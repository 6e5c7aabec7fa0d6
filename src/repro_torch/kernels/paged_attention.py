"""Paged decode attention (``csrc/paged_attention.cu``).

Counterpart of ``repro.kernels.paged_attention.paged_attention``: one query
token per row attends the first ``lengths[b]`` tokens of its pages
``k_pages[block_tables[b, p]]``; a row of length 0 gives zeros. Group
sizes up to 128 and head dims that are a multiple of 4 up to 256 are
taken, in float32 or bfloat16 (all of one type; the output takes it: a
bf16 launch computes in f32, as the reference's kernel upcasts, and rounds
the output once). A tensor on
the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.paged_attention_ref`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import paged_attention_ref

_SIGNATURES = {
    # q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D,
    # page, pages, stream
    "paged_attention_launch": "pppppppiiiiiip",
    "paged_attention_bf16_launch": "pppppppiiiiiip",  # bf16 q, pages, out
    # (B, H, Hkv, D, page, pages_per_seq) -> floats of scratch a launch
    # needs (every chunk's partial softmax state)
    "paged_attention_scratch_floats": "iiiiii",
}
MAX_GROUP = 128  # query heads per kv head (csrc: the q heads' shared memory)


def chunk_tokens(head_dim: int) -> int:
    """Tokens of the table one block of the kernel takes (csrc:
    chunk_tokens): 64, and 32 for a head dim past 128."""
    return 32 if head_dim > 128 else 64


def chunk_plan(page_size: int, pages_per_seq: int, head_dim: int) -> int:
    """Chunks of :func:`chunk_tokens` that cover a row's table, as the
    kernel's grid does: one block each per (chunk, kv head, row); a block
    whose chunk starts at or past the row's clamped length returns at once,
    and the merge reads the first ``ceil(len / chunk_tokens)`` chunks."""
    return -(-pages_per_seq * page_size // chunk_tokens(head_dim))


def paged_attention(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, page_size, Hkv, D)
    v_pages: torch.Tensor,  # (P, page_size, Hkv, D)
    block_tables: torch.Tensor,  # (B, pages_per_seq) int
    lengths: torch.Tensor,  # (B,) int
) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    name = "paged_attention"
    dev = q.device
    if not (q.dim() == 3 and k_pages.dim() == 4
            and k_pages.shape == v_pages.shape):
        raise ValueError(f"{name}: bad ranks")
    B, H, D = q.shape
    _, page, Hkv, kd = k_pages.shape
    if kd != D:
        raise ValueError(f"{name}: head dim mismatch")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(
            f"{name}: {H} query heads over {Hkv} kv heads: the group size must "
            f"be a whole number up to {MAX_GROUP}")
    build.check_head_dim(name, D)
    if page % 8:
        raise ValueError(f"{name}: page size {page} must be a multiple of 8")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be (B, pages_per_seq)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths must be (B,)")
    dtype = build.check_cuda(name, dev, q=q, k_pages=k_pages, v_pages=v_pages)
    tables = build.as_int32(block_tables, dev)
    lens = build.as_int32(lengths, dev)
    out = torch.empty_like(q)
    if B == 0 or tables.shape[1] == 0:
        return out.zero_()
    lib = build.load(name, _SIGNATURES)
    pages = tables.shape[1]
    scratch = torch.empty(
        (lib.paged_attention_scratch_floats(B, H, Hkv, D, page, pages),),
        device=dev, dtype=torch.float32)
    code = getattr(lib, build.entry("paged_attention_launch", dtype))(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, Hkv, D, page,
        pages, torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, name, lib, code)
    build.launches[name] += 1
    return out
