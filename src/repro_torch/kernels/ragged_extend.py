"""Ragged extend attention (``csrc/ragged_extend.cu``).

Counterpart of ``repro.kernels.ragged_extend.ragged_extend``: causal GQA
attention of padded suffix chunks ``q (B, S, Hq, D)`` against the dense
cache ``(B, T, Hkv, D)``; query ``s`` of row ``b`` sees keys
``0 .. start[b] + s`` for ``s < true_lens[b]``, and padded queries are
zeros. Any group size and any head dim that is a multiple of 4 up to 256
is taken, in float32 or bfloat16 (all of one type; the output takes it: a
bf16 launch computes in f32, as the reference's kernel upcasts q, k and v,
and rounds the output once). A tensor on the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.ragged_extend_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import ragged_extend_ref

_SIGNATURES = {
    # q, k, v, start, true_lens, out, scratch, B, S, T, Hq, Hkv, D, stream
    "ragged_extend_launch": "pppppppiiiiiip",
    "ragged_extend_bf16_launch": "pppppppiiiiiip",  # the same on bf16 q, k, v, out
    # (B, S, T, Hq, Hkv, D) -> KV parts per q tile (1: no scratch)
    "ragged_extend_kv_parts": "iiiiii",
}


def ragged_extend(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D) — new rows already written
    v: torch.Tensor,  # (B, T, Hkv, D)
    start: torch.Tensor,  # (B,) int — cache length before this chunk
    true_lens: torch.Tensor,  # (B,) int — live tokens per row (may be 0)
) -> torch.Tensor:
    if q.device.type == "cpu":
        return ragged_extend_ref(q, k, v, start, true_lens)
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
    if B * S == 0:
        return out
    lib = build.load(name, _SIGNATURES)
    # where the KV range is split over blocks, their partials: a sum of
    # p·v, a max and a sum of p per part and query vector
    parts = lib.ragged_extend_kv_parts(B, S, T, Hq, Hkv, D)
    scratch = (torch.empty((parts * B * S * Hq * (D + 2),), device=dev, dtype=torch.float32)
               if parts > 1 else None)
    code = getattr(lib, build.entry("ragged_extend_launch", dtype))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), st.data_ptr(), tl.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, S, T, Hq, Hkv, D, torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, name, lib, code)
    build.launches[name] += 1
    return out
