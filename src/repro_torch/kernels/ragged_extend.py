"""Ragged extend attention (``csrc/ragged_extend.cu``).

Counterpart of ``repro.kernels.ragged_extend.ragged_extend``: causal GQA
attention of padded suffix chunks ``q (B, S, Hq, D)`` against the dense
cache ``(B, T, Hkv, D)``; query ``s`` of row ``b`` sees keys
``0 .. start[b] + s`` for ``s < true_lens[b]``, and padded queries are
zeros. A tensor on the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.ragged_extend_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import ragged_extend_ref

# q, k, v, start, true_lens, out, B, S, T, Hq, Hkv, D, stream
_ARGTYPES = ("p", "p", "p", "p", "p", "p", "i", "i", "i", "i", "i", "i", "p")
QUERIES_PER_BLOCK = 32
MAX_HEAD_DIM = 128


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
    if Hq % Hkv or QUERIES_PER_BLOCK % (Hq // Hkv):
        raise ValueError(
            f"{name}: group size {Hq}/{Hkv} must divide {QUERIES_PER_BLOCK}")
    if D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {D} must be a multiple of 4 up to {MAX_HEAD_DIM}")
    if tuple(start.shape) != (B,) or tuple(true_lens.shape) != (B,):
        raise ValueError(f"{name}: start/true_lens must be (B,)")
    build.check_cuda_f32(name, dev, q=q, k=k, v=v)
    st = build.as_int32(start, dev)
    tl = build.as_int32(true_lens, dev)
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = build.load(name, _ARGTYPES)
    code = lib.ragged_extend_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), st.data_ptr(), tl.data_ptr(),
        out.data_ptr(), B, S, T, Hq, Hkv, D,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, lib, code)
    build.launches[name] += 1
    return out
