"""Paged decode attention (``csrc/paged_attention.cu``).

Counterpart of ``repro.kernels.paged_attention.paged_attention``: one query
token per row attends the first ``lengths[b]`` tokens of its pages
``k_pages[block_tables[b, p]]``; a row of length 0 gives zeros. A tensor on
the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.paged_attention_ref`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import paged_attention_ref

# q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page,
# pages, stream
_ARGTYPES = ("p", "p", "p", "p", "p", "p", "p", "i", "i", "i", "i", "i", "i", "p")
# paged_attention_scratch_floats(B, H, Hkv, D, pages_per_seq): floats of
# scratch a launch needs (the page splits' partial softmax states)
_EXTRA = {"scratch_floats": ("i", "i", "i", "i", "i")}
GROUP_SIZES = (1, 2, 4, 8)
MAX_HEAD_DIM = 128


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
    if H % Hkv or H // Hkv not in GROUP_SIZES:
        raise ValueError(f"{name}: group size {H}/{Hkv} not in {GROUP_SIZES}")
    if D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {D} must be a multiple of 4 up to {MAX_HEAD_DIM}")
    if page % 8:
        raise ValueError(f"{name}: page size {page} must be a multiple of 8")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be (B, pages_per_seq)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths must be (B,)")
    build.check_cuda_f32(name, dev, q=q, k_pages=k_pages, v_pages=v_pages)
    tables = build.as_int32(block_tables, dev)
    lens = build.as_int32(lengths, dev)
    out = torch.empty_like(q)
    if B == 0 or tables.shape[1] == 0:
        return out.zero_()
    lib = build.load(name, _ARGTYPES, _EXTRA)
    pages = tables.shape[1]
    scratch = torch.empty(
        (lib.paged_attention_scratch_floats(B, H, Hkv, D, pages),),
        device=dev, dtype=torch.float32)
    code = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, Hkv, D, page,
        pages, torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, lib, code)
    build.launches[name] += 1
    return out
