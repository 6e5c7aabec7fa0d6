"""Multi-LoRA projections (``csrc/fused_sgmv.cu``).

``fused_sgmv`` is the counterpart of ``repro.kernels.sgmv.fused_sgmv``:
``x·W + scale·(x·A[id])·B[id]`` with one adapter id per batch row; a
negative id keeps ``x·W`` and drops the delta. ``sgmv`` is the counterpart
of ``repro.kernels.sgmv.sgmv``, the delta alone: a negative id gives a zero
row. Both run the same source with the base term compiled in or out. A
tensor on the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.fused_sgmv_ref`,
:func:`~repro_torch.kernels.ref.sgmv_ref`); a CUDA tensor launches the
kernel or raises. Every rank from 1 to ``MAX_RANK`` is taken.

``fused_sgmv`` is differentiable: under autograd, with an input that
requires grad, it runs as a ``torch.autograd.Function``. Its backward
computes the base parts, ``dx = dy·Wᵀ`` and (only where W needs a
gradient) ``dW = Σ xᵀ·dy``, as plain library products, and everything
indexed by adapter id (the shrinks, the per-adapter dA and dB and the delta
of dx) in ``csrc/lora_grad.cu`` on the card, or all of it in
:func:`~repro_torch.kernels.ref.fused_sgmv_bwd_ref` on the CPU. ``sgmv``
serves the engine only: on the card it refuses an input that requires grad
(``build.check_cuda_f32``).
"""

from __future__ import annotations

import torch

from . import build
from .ref import fused_sgmv_bwd_ref, fused_sgmv_ref, lora_grad_ref, sgmv_ref

_SOURCE = "fused_sgmv"
MAX_RANK = 128  # csrc: ranks 4, 8, .., 128 compiled, a rank between runs on the next
_SIGNATURES = {
    # x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, R, scale, stream
    "fused_sgmv_launch": "pppppppiiiiifp",
    # x, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, R, scale, stream
    "sgmv_launch": "ppppppiiiiifp",
    # (M, d_in, d_out, R, has_base) -> floats of scratch a launch needs
    "fused_sgmv_scratch_floats": "iiiii",
}
_GRAD_SOURCE = "lora_grad"
_GRAD_SIGNATURES = {
    # x, dy, a, b, ids, scratch, da, db, dx (NULL: none), B, S, N, d_in,
    # d_out, r, scale, stream
    "lora_grad_launch": "pppppppppiiiiiifp",
    # (B, S, N, d_in, d_out, r) -> floats of scratch a launch needs
    "lora_grad_scratch_floats": "iiiiii",
}


# the skinny path's launch plan (csrc/fused_sgmv.cu: use_skinny, skinny_plan)
SKINNY_MAX_M = 16
SKINNY_COLS = 64  # output columns of a W block
SKINNY_KS = 32  # k rows of a ring stage
SKINNY_MAX_SPLITS = 16


def skinny_plan(M: int, d_in: int, d_out: int, has_base: bool, sms: int):
    """(cols, splits, kper) of the skinny path on a card of ``sms`` SMs:
    ``cols`` W blocks of 64 columns (none without the base term) and one
    shrink block per batch row in each of ``splits`` k splits (about two W
    blocks an SM, or shrink blocks without the base term; at most 16).
    Split z takes ring stages [z·kper, (z + 1)·kper) of 32 k rows, the last
    one cut at d_in. The kernel writes ``splits·M·(r + d_out)`` floats of partials
    (``splits·M·r`` without the base term)."""
    KT = -(-d_in // SKINNY_KS)
    cols = -(-d_out // SKINNY_COLS) if has_base else 0
    splits = min(max(-(-2 * sms // (cols if has_base else M)), 1), KT,
                 SKINNY_MAX_SPLITS)
    kper = -(-KT // splits)
    return cols, -(-KT // kper), kper


def _check(name, x, w, lora_a, lora_b, adapter_ids):
    """Shapes (B, S, d_in, d_out, r) of a launch, after the wrapper checks."""
    if not (x.dim() == 3 and lora_a.dim() == 3 and lora_b.dim() == 3
            and (w is None or w.dim() == 2)):
        raise ValueError(f"{name}: bad ranks")
    B, S, d_in = x.shape
    N, a_in, r = lora_a.shape
    d_out = lora_b.shape[2]
    if a_in != d_in or (w is not None and tuple(w.shape) != (d_in, d_out)):
        raise ValueError(f"{name}: d_in / d_out mismatch")
    if tuple(lora_b.shape) != (N, r, d_out):
        raise ValueError(f"{name}: lora_b shape")
    if tuple(adapter_ids.shape) != (B,):
        raise ValueError(f"{name}: adapter_ids shape")
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"{name}: rank {r} must be in 1..{MAX_RANK}")
    tensors = dict(x=x, lora_a=lora_a, lora_b=lora_b)
    if w is not None:
        tensors["w"] = w
    build.check_cuda_f32(name, x.device, **tensors)
    return B, S, d_in, d_out, r


def _launch(name, x, w, lora_a, lora_b, adapter_ids, scale):
    dev = x.device
    B, S, d_in, d_out, r = _check(name, x, w, lora_a, lora_b, adapter_ids)
    ids = build.as_int32(adapter_ids, dev)
    y = torch.empty((B, S, d_out), device=dev, dtype=torch.float32)
    if B * S == 0 or d_out == 0:
        return y
    lib = build.load(_SOURCE, _SIGNATURES)
    scratch = torch.empty(
        (max(1, lib.fused_sgmv_scratch_floats(B * S, d_in, d_out, r, w is not None)),),
        device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if w is None:
        code = lib.sgmv_launch(
            x.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(), ids.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), B * S, S, d_in, d_out, r,
            float(scale), stream)
    else:
        code = lib.fused_sgmv_launch(
            x.data_ptr(), w.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
            ids.data_ptr(), y.data_ptr(), scratch.data_ptr(), B * S, S, d_in,
            d_out, r, float(scale), stream)
    build.check_error(name, _SOURCE, lib, code)
    build.launches[name] += 1
    return y


def weight_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dW = Σ_b x_bᵀ·dy_b`` (d_in, d_out): one library product over every
    token. The backward calls it only where W needs a gradient."""
    return x.reshape(-1, x.shape[-1]).T @ dy.reshape(-1, dy.shape[-1])


def lora_grad(
    x: torch.Tensor,  # (B, S, d_in)
    dy: torch.Tensor,  # (B, S, d_out) — the gradient of fused_sgmv's output
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float,
    dx: torch.Tensor | None = None,  # (B, S, d_in), added into; None: skipped
):
    """The adapter-indexed part of fused_sgmv's backward: returns (dA, dB)
    and adds the delta ``scale·g·A[id]ᵀ`` into ``dx`` where it is given.
    A tensor on the CPU takes :func:`~repro_torch.kernels.ref.lora_grad_ref`;
    a CUDA tensor launches ``csrc/lora_grad.cu`` or raises."""
    if x.device.type == "cpu":
        delta, da, db = lora_grad_ref(x, dy, lora_a, lora_b, adapter_ids, scale)
        if dx is not None:
            dx += delta.to(dx.dtype)
        return da, db
    name = "lora_grad"
    dev = x.device
    B, S, d_in = x.shape
    N, _, r = lora_a.shape
    d_out = lora_b.shape[2]
    if tuple(dy.shape) != (B, S, d_out) or (dx is not None and dx.shape != x.shape):
        raise ValueError(f"{name}: dy must be (B, S, d_out) and dx x's shape")
    tensors = dict(x=x, dy=dy, lora_a=lora_a, lora_b=lora_b)
    if dx is not None:
        tensors["dx"] = dx
    build.check_cuda_f32(name, dev, **tensors)
    ids = build.as_int32(adapter_ids, dev)
    da, db = torch.empty_like(lora_a), torch.empty_like(lora_b)
    if B * S == 0:
        return da.zero_(), db.zero_()
    lib = build.load(_GRAD_SOURCE, _GRAD_SIGNATURES)
    floats = lib.lora_grad_scratch_floats(B, S, N, d_in, d_out, r)
    if floats < 0:
        raise ValueError(f"{name}: the scratch of B={B}, S={S}, N={N} passes 2^31 floats")
    scratch = torch.empty((floats,), device=dev, dtype=torch.float32)
    code = lib.lora_grad_launch(
        x.data_ptr(), dy.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
        ids.data_ptr(), scratch.data_ptr(), da.data_ptr(), db.data_ptr(),
        None if dx is None else dx.data_ptr(), B, S, N, d_in, d_out, r, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, _GRAD_SOURCE, lib, code)
    build.launches[name] += 1
    return da, db


def fused_sgmv_bwd(x, w, lora_a, lora_b, adapter_ids, scale, dy,
                   need_dx: bool = True, need_dw: bool = True):
    """The backward of :func:`fused_sgmv`: (dx, dw, da, db), dx None unless
    ``need_dx`` and dw None unless ``need_dw``. On the card the base parts
    are library products (:func:`weight_grad`, ``dy·Wᵀ``) and the rest is
    :func:`lora_grad`; on the CPU all of it is
    :func:`~repro_torch.kernels.ref.fused_sgmv_bwd_ref`."""
    if x.device.type == "cpu":
        dx, dw, da, db = fused_sgmv_bwd_ref(x, w, lora_a, lora_b, adapter_ids,
                                            scale, dy, need_dw)
        return (dx if need_dx else None), dw, da, db
    dy = dy.contiguous()
    dx = dy @ w.T if need_dx else None
    dw = weight_grad(x, dy) if need_dw else None
    da, db = lora_grad(x, dy, lora_a, lora_b, adapter_ids, scale, dx)
    return dx, dw, da, db


class _FusedSgmvFn(torch.autograd.Function):
    """fused_sgmv with its backward. ``ctx.needs_input_grad`` skips dW when
    W is frozen (LoRA-only training) and dx when x needs none (the first
    layer's input)."""

    @staticmethod
    def forward(ctx, x, w, lora_a, lora_b, adapter_ids, scale):
        ctx.scale = scale
        ctx.save_for_backward(x, w, lora_a, lora_b, adapter_ids)
        if x.device.type == "cpu":
            return fused_sgmv_ref(x, w, lora_a, lora_b, adapter_ids, scale)
        return _launch("fused_sgmv", x, w, lora_a, lora_b, adapter_ids, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, lora_a, lora_b, adapter_ids = ctx.saved_tensors
        need_dx, need_dw, need_da, need_db = ctx.needs_input_grad[:4]
        dx, dw, da, db = fused_sgmv_bwd(x, w, lora_a, lora_b, adapter_ids, ctx.scale,
                                        dy, need_dx, need_dw)
        return (dx, dw, da if need_da else None, db if need_db else None, None, None)


def fused_sgmv(
    x: torch.Tensor,  # (B, S, d_in)
    w: torch.Tensor,  # (d_in, d_out)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, lora_a, lora_b)):
        return _FusedSgmvFn.apply(x, w, lora_a, lora_b, adapter_ids, scale)
    if x.device.type == "cpu":
        return fused_sgmv_ref(x, w, lora_a, lora_b, adapter_ids, scale)
    return _launch("fused_sgmv", x, w, lora_a, lora_b, adapter_ids, scale)


def sgmv(
    x: torch.Tensor,  # (B, S, d_in)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative gives a zero row
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return sgmv_ref(x, lora_a, lora_b, adapter_ids, scale)
    return _launch("sgmv", x, None, lora_a, lora_b, adapter_ids, scale)
