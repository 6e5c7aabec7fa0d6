"""Paged decode attention (``csrc/paged_attention.cu``).

Counterpart of ``repro.kernels.paged_attention.paged_attention``: one query
token per row attends the first ``lengths[b]`` tokens of its pages
``k_pages[block_tables[b, p]]``; a row of length 0 gives zeros. Group
sizes up to 128 and head dims that are a multiple of 4 up to 256 are
taken, in float32 or bfloat16 (all of one type; the output takes it: a
bf16 launch computes in f32, as the reference's kernel upcasts, and rounds
the output once). A launch runs one of two loops of
``csrc/paged_attention.cu``, chosen by :func:`bf16_path` from the shape and
addresses and counted per loop (``ops.path_launch_counts``): ``"split"``
for bf16 at G·D <= 512 and D a multiple of 8 (a cluster of
:func:`split_plan` blocks per row and kv head over TMA rings, merged in
distributed shared memory), else ``"chunk"`` (64-token chunks and a merge
kernel), which f32 launches always take. A tensor on
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
    # q, k_pages, v_pages, tables, lengths, out, lse (or NULL), scratch, B,
    # H, Hkv, D, page, pages, stream
    "paged_attention_launch": "ppppppppiiiiiip",
    "paged_attention_bf16_launch": "ppppppppiiiiiip",  # bf16 q, pages, out
    # (B, H, Hkv, D, page, pages_per_seq) -> floats of scratch a launch
    # needs (every chunk's partial softmax state)
    "paged_attention_scratch_floats": "iiiiii",
    # q, k_pages, v_pages, tables, lengths, out, lse (or NULL), B, H, Hkv,
    # D, page, pages, P, n_split, stream: the bf16 split loop (no scratch)
    "paged_attention_bf16_split_launch": "pppppppiiiiiiiip",
}
MAX_GROUP = 128  # query heads per kv head (csrc: the q heads' shared memory)
SPLIT_TOKENS = 64  # tokens of a tile of the split loop (csrc: split::TK)
SPLIT_MAX = 8  # blocks of a cluster, at most (csrc: split::MAX_SPLIT)
SPLIT_MAX_GROUP = 16  # query heads per kv head of the split loop (split::MAX_G)
# G·D of a kv head's query heads, at most, where the split loop runs: it
# beat the chunk loop at G·D = 128 and 256 (llama-7b, qwen3-0.6b) and lost
# at 640, 896 and 2048 (stablelm-12b, qwen2-vl-7b, gemma-2b) on an H100
SPLIT_MAX_GD = 512


def split_plan(B: int, Hkv: int, sms: int) -> int:
    """Blocks per (row, kv head) of the split loop on a card of ``sms``
    SMs: about two blocks an SM over the B·Hkv clusters, 1 to 8 (one
    thread-block cluster each)."""
    return min(SPLIT_MAX, max(1, -(-2 * sms // (B * Hkv))))


def split_share(length: int, table_tokens: int, n_split: int, s: int) -> tuple[int, int]:
    """The 64-token tiles [j0, j1) that block ``s`` of ``n_split`` takes of a
    row of ``length`` tokens (clamped to the table's ``table_tokens``): the
    s-th contiguous, equal share of the row's live tiles (empty where the
    row has fewer tiles than blocks)."""
    n_live = -(-min(max(length, 0), table_tokens) // SPLIT_TOKENS)
    return s * n_live // n_split, (s + 1) * n_live // n_split


def bf16_path(B: int, G: int, Hkv: int, D: int, ptrs) -> str:
    """The loop of a bf16 launch, from its shape and addresses alone:
    ``"split"`` for a group of at most 16 heads whose G·D is at most
    SPLIT_MAX_GD, a head dim that is a multiple of 8 (TMA's 16-byte rows)
    up to 256, at most 65535 (row, kv head) pairs and every base address in
    ``ptrs`` (q, the pools) on 16 bytes; else ``"chunk"``, which takes any G
    up to 128 and D a multiple of 4 (and every f32 launch). A pure
    function: nothing is tried and nothing falls back."""
    ok = (G <= SPLIT_MAX_GROUP and G * D <= SPLIT_MAX_GD and D % 8 == 0
          and 0 < D <= build.MAX_HEAD_DIM and B * Hkv <= 65535
          and all(p % 16 == 0 for p in ptrs))
    return "split" if ok else "chunk"


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
    *,
    return_lse: bool = False,
):
    """The attention (B, H, D); with ``return_lse``, (attention, lse (B,
    H) f32): each query's log-sum-exp of its scaled scores, −inf for a row
    of length 0 (whose attention is zeros), for merging partial attentions
    over parts of the keys."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   return_lse=return_lse)
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
    lse = (torch.empty((B, H), device=dev, dtype=torch.float32) if return_lse
           else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    if B == 0 or tables.shape[1] == 0:
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    lib = build.load(name, _SIGNATURES)
    pages = tables.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    path = "chunk"
    if dtype == torch.bfloat16:
        path = bf16_path(B, H // Hkv, Hkv, D,
                         (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()))
    if path == "split":
        code = lib.paged_attention_bf16_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), lse_ptr, B, H, Hkv, D, page, pages,
            k_pages.shape[0], split_plan(B, Hkv, build.sm_count(dev)), stream)
        build.check_error(name, name, lib, code)
        build.launches[name] += 1
        build.path_launches[name, path] += 1
        return (out, lse) if return_lse else out
    scratch = torch.empty(
        (lib.paged_attention_scratch_floats(B, H, Hkv, D, page, pages),),
        device=dev, dtype=torch.float32)
    code = getattr(lib, build.entry("paged_attention_launch", dtype))(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), lse_ptr, scratch.data_ptr(), B, H, Hkv, D,
        page, pages, stream)
    build.check_error(name, name, lib, code)
    build.launches[name] += 1
    build.path_launches[name, path] += 1
    return (out, lse) if return_lse else out
