"""Fused base + multi-LoRA projection (``csrc/fused_sgmv.cu``).

Counterpart of ``repro.kernels.sgmv.fused_sgmv``: ``x·W + scale·(x·A[id])·B[id]``
with one adapter id per batch row; a negative id keeps ``x·W`` and drops the
delta. A tensor on the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.fused_sgmv_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import fused_sgmv_ref

# x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, R, scale, stream
_ARGTYPES = ("p", "p", "p", "p", "p", "p", "p", "i", "i", "i", "i", "i", "f", "p")
# fused_sgmv_scratch_floats(M, d_in, d_out, R): floats of scratch a launch needs
_EXTRA = {"scratch_floats": ("i", "i", "i", "i")}


def fused_sgmv(
    x: torch.Tensor,  # (B, S, d_in)
    w: torch.Tensor,  # (d_in, d_out)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_sgmv_ref(x, w, lora_a, lora_b, adapter_ids, scale)
    name = "fused_sgmv"
    dev = x.device
    if not (x.dim() == 3 and w.dim() == 2 and lora_a.dim() == 3
            and lora_b.dim() == 3):
        raise ValueError(f"{name}: bad ranks")
    B, S, d_in = x.shape
    N, a_in, r = lora_a.shape
    d_out = w.shape[1]
    if w.shape[0] != d_in or a_in != d_in:
        raise ValueError(f"{name}: d_in mismatch")
    if tuple(lora_b.shape) != (N, r, d_out):
        raise ValueError(f"{name}: lora_b shape")
    if tuple(adapter_ids.shape) != (B,):
        raise ValueError(f"{name}: adapter_ids shape")
    # a rank the kernel is not compiled for, or a tile over the shared
    # memory of a block, comes back as the launch's CUDA error
    build.check_cuda_f32(name, dev, x=x, w=w, lora_a=lora_a, lora_b=lora_b)
    ids = build.as_int32(adapter_ids, dev)
    y = torch.empty((B, S, d_out), device=dev, dtype=torch.float32)
    if B * S == 0 or d_out == 0:
        return y
    lib = build.load(name, _ARGTYPES, _EXTRA)
    scratch = torch.empty(
        (max(1, lib.fused_sgmv_scratch_floats(B * S, d_in, d_out, r)),),
        device=dev, dtype=torch.float32)
    code = lib.fused_sgmv_launch(
        x.data_ptr(), w.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
        ids.data_ptr(), y.data_ptr(), scratch.data_ptr(), B * S, S, d_in,
        d_out, r, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, lib, code)
    build.launches[name] += 1
    return y
