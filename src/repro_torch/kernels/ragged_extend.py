"""Ragged extend attention (``csrc/ragged_extend.cu``).

Counterpart of ``repro.kernels.ragged_extend.ragged_extend``: causal GQA
attention of padded suffix chunks ``q (B, S, Hq, D)`` against the dense
cache ``(B, T, Hkv, D)``; query ``s`` of row ``b`` sees keys
``0 .. start[b] + s`` for ``s < true_lens[b]``, and padded queries are
zeros. Any group size and any head dim that is a multiple of 4 up to 256
is taken, in float32 or bfloat16 (all of one type; the output takes it: a
bf16 launch computes in f32, as the reference's kernel upcasts q, k and v,
and rounds the output once). A bf16 launch takes one of two tile loops,
chosen by :func:`bf16_path` from the shape and addresses and counted per
loop (``ops.path_launch_counts``): ``"wgmma"``
(``csrc/ragged_extend_wgmma.cu`` on ``csrc/attention_wgmma.cuh``: TMA and
warpgroup products, Q·Kᵀ on the bf16 values and P·V on P as bf16 hi + lo)
where the head dim is a multiple of 16 on 16-byte bases, else ``"mma"``
(``csrc/ragged_extend.cu`` on ``csrc/attention_tc.cuh``), which every f32
launch takes. A tensor on the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.ragged_extend_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .flash_prefill import bf16_path as _flash_bf16_path
from .ref import ragged_extend_ref

_SIGNATURES = {
    # q, k, v, start, true_lens, out, scratch, lse (or NULL), B, S, T, Hq,
    # Hkv, D, stream
    "ragged_extend_launch": "ppppppppiiiiiip",
    "ragged_extend_bf16_launch": "ppppppppiiiiiip",  # the same on bf16 q, k, v, out
    # (B, S, T, Hq, Hkv, D) -> KV parts per q tile (1: no scratch)
    "ragged_extend_kv_parts": "iiiiii",
}
_WGMMA_SOURCE = "ragged_extend_wgmma"
_WGMMA_SIGNATURES = {
    # the same arguments as ragged_extend_bf16_launch, on attention_wgmma.cuh
    "ragged_extend_wgmma_launch": "ppppppppiiiiiip",
    "ragged_extend_wgmma_kv_parts": "iiiiii",
}


def bf16_path(B: int, S: int, T: int, Hq: int, Hkv: int, D: int, ptrs) -> str:
    """The tile loop of a bf16 launch on contiguous q (B, S, Hq, D) and k,
    v (B, T, Hkv, D), from its shape and addresses alone: ``"wgmma"`` on
    the conditions of :func:`~repro_torch.kernels.flash_prefill.bf16_path`
    (D a multiple of 16 up to 256, 16-byte strides, every base address in
    ``ptrs`` on 16 bytes), else ``"mma"``. A pure function: nothing is tried
    and nothing falls back."""
    strides = (S * Hq * D, D, Hq * D, T * Hkv * D, D, Hkv * D, T * Hkv * D, D, Hkv * D)
    return _flash_bf16_path(D, strides, ptrs)


def ragged_extend(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D) — new rows already written
    v: torch.Tensor,  # (B, T, Hkv, D)
    start: torch.Tensor,  # (B,) int — cache length before this chunk
    true_lens: torch.Tensor,  # (B,) int — live tokens per row (may be 0)
    *,
    return_lse: bool = False,
):
    """The attention (B, S, Hq, D); with ``return_lse``, (attention, lse
    (B, S, Hq) f32): each query's log-sum-exp of its scaled scores, −inf
    for a padded query (whose attention is zeros), for merging partial
    attentions over parts of the keys."""
    if q.device.type == "cpu":
        return ragged_extend_ref(q, k, v, start, true_lens, return_lse=return_lse)
    name = "ragged_extend"
    dev = q.device
    if not (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape):
        raise ValueError(f"{name}: bad ranks")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: cache shape")
    if Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads over {Hkv} kv heads")
    build.check_head_dim(name, D)
    if tuple(start.shape) != (B,) or tuple(true_lens.shape) != (B,):
        raise ValueError(f"{name}: start/true_lens must be (B,)")
    dtype = build.check_cuda(name, dev, q=q, k=k, v=v)
    st = build.as_int32(start, dev)
    tl = build.as_int32(true_lens, dev)
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, Hq), device=dev, dtype=torch.float32) if return_lse
           else None)
    if B * S == 0:
        return (out, lse) if return_lse else out
    path = "mma"
    if dtype == torch.bfloat16:
        path = bf16_path(B, S, T, Hq, Hkv, D, (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    if path == "wgmma":
        source, lib = _WGMMA_SOURCE, build.load(_WGMMA_SOURCE, _WGMMA_SIGNATURES)
        parts = lib.ragged_extend_wgmma_kv_parts(B, S, T, Hq, Hkv, D)
        fn = lib.ragged_extend_wgmma_launch
    else:
        source, lib = name, build.load(name, _SIGNATURES)
        parts = lib.ragged_extend_kv_parts(B, S, T, Hq, Hkv, D)
        fn = getattr(lib, build.entry("ragged_extend_launch", dtype))
    # where the KV range is split over blocks, their partials: a sum of
    # p·v, a max and a sum of p per part and query vector
    scratch = (torch.empty((parts * B * S * Hq * (D + 2),), device=dev, dtype=torch.float32)
               if parts > 1 else None)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), st.data_ptr(), tl.data_ptr(),
              out.data_ptr(), None if scratch is None else scratch.data_ptr(),
              None if lse is None else lse.data_ptr(), B, S, T, Hq, Hkv, D,
              torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, source, lib, code)
    build.launches[name] += 1
    build.path_launches[name, path] += 1
    return (out, lse) if return_lse else out
