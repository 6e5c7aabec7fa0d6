"""Causal flash attention for a fresh prefill (``csrc/flash_prefill.cu``).

``flash_prefill`` is the counterpart of
``repro.kernels.flash_prefill.flash_prefill``: causal GQA attention in the
head-major layout ``q (B, H, S, D)``, ``k/v (B, Hkv, S, D)``.
``flash_prefill_ragged`` is the counterpart of ``flash_prefill_ragged``:
the same with ``true_lens`` (B,) live tokens per row; padded queries and
rows of length 0 come out as zeros. Any group size and any head dim that is
a multiple of 4 up to 256 is taken, in float32 or bfloat16 (all of one
type; the output takes it: a bf16 launch runs Q·Kᵀ on the bf16 values with
f32 sums, the softmax in f32 and P·V on P split into bf16 hi + lo, and
rounds the output once). bf16 launches take one of two tile loops, chosen
by :func:`bf16_path` from the shape, strides and addresses and counted per
loop (``ops.path_launch_counts``): ``csrc/attention_wgmma.cuh`` (wgmma and
TMA) for a head dim that is a multiple of 16 on 16-byte strides, else
``csrc/attention_tc.cuh`` (mma.sync), which f32 launches always take. The
inputs may be strided views (a
``(B, S, H, D)`` tensor transposed to head-major is read in place) as long
as D has unit stride; the output has q's strides. A tensor on the CPU takes
the plain version (:func:`~repro_torch.kernels.ref.flash_prefill_ref`,
:func:`~repro_torch.kernels.ref.flash_prefill_ragged_ref`); a CUDA tensor
launches the kernel or raises.

Both are differentiable: under autograd, with an input that requires grad,
``flash_prefill`` runs as a ``torch.autograd.Function`` whose forward also
writes each query's log-sum-exp and whose backward is
``csrc/flash_prefill_bwd.cu`` on the card and
:func:`~repro_torch.kernels.ref.flash_prefill_bwd_ref` on the CPU.
``flash_prefill_ragged`` serves the engine only: on the card it refuses an
input that requires grad (``build.check_cuda``). The backward kernel takes
float32 only: a bfloat16 input that requires grad on the card raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from . import build
from .ref import (flash_prefill_bwd_ref, flash_prefill_lse_ref,
                  flash_prefill_ragged_ref, flash_prefill_ref)

_SOURCE = "flash_prefill"
# q, k, v, true_lens (NULL: S in every row), out, lse (NULL: none), B, S, H,
# Hkv, D, then the b, h, s element strides of q, k and v (out has q's),
# stream
_SIGNATURES = {"flash_prefill_launch": "ppppppiiiiilllllllllp",
               "flash_prefill_bf16_launch": "ppppppiiiiilllllllllp",  # bf16 q, k, v, out
               # the same on attention_wgmma.cuh's loop (:func:`bf16_path`)
               "flash_prefill_bf16_wgmma_launch": "ppppppiiiiilllllllllp"}
WGMMA_MAX_D = 256  # head dims of the wgmma loop: multiples of 16 up to this
_BWD_SOURCE = "flash_prefill_bwd"
_BWD_SIGNATURES = {
    # q, k, v, o, dout, lse, delta, part (NULL: no head parts), dQ partials
    # (NULL: a dQ pass of its own), dq, dk, dv, B, S, H, Hkv, D, head
    # parts, then the b, h, s element strides of q (o, dq), k (dk), v (dv)
    # and dout, stream
    "flash_prefill_bwd_launch": "ppppppppppppiiiiiillllllllllllp",
}

BWD_KV_KEYS = 64  # keys of a dK/dV block of csrc/flash_prefill_bwd.cu
# The most floats of dQ partials (256 MiB) the backward folds dQ into its
# dK/dV blocks for; past it dQ takes a pass of its own. The partials grow
# as S²·B·H·D / 128; the budget keeps the backward's memory O(S).
DQ_FOLD_FLOATS = 1 << 26


def dq_part_rows(S: int) -> int:
    """Rows (of D floats, for every b and head) of the dQ partials of all
    kv tiles: tile t holds queries 64t .. S - 1."""
    t = -(-S // BWD_KV_KEYS)
    return t * S - BWD_KV_KEYS // 2 * t * (t - 1)


def bwd_plan(B: int, S: int, H: int, Hkv: int, D: int, sms: int) -> tuple[int, bool]:
    """How ``csrc/flash_prefill_bwd.cu`` splits the work on a card of
    ``sms`` SMs: (hs, fold). Where the (64-key tile, b, kv head) blocks of
    the dK/dV pass do not give two blocks an SM, each block takes one of
    ``hs`` parts of the group's heads (at most G) and a further pass adds
    the parts' dK and dV in order. ``fold``: the dK/dV blocks also write
    each q tile's dQ partial over their keys, added in kv tile order (five
    products in place of seven), while the partials fit
    :data:`DQ_FOLD_FLOATS`; else dQ has a pass of its own."""
    blocks = -(-S // BWD_KV_KEYS) * B * Hkv
    hs = max(1, min(-(-2 * sms // blocks), H // Hkv))
    return hs, dq_part_rows(S) * B * H * D <= DQ_FOLD_FLOATS


def bf16_path(D: int, strides, ptrs) -> str:
    """The tile loop of a bf16 launch of ``csrc/flash_prefill.cu``, from its
    shape alone: ``"wgmma"`` (``csrc/attention_wgmma.cuh``: TMA loads and
    warpgroup products) for a head dim ``D`` that is a multiple of 16 up to
    256, every b, h and s element stride of q, k and v in ``strides`` a
    positive multiple of 8 (16 bytes) and every base address in ``ptrs`` on
    16 bytes; else ``"mma"`` (``csrc/attention_tc.cuh``, which takes any
    multiple of 4 on 8-byte rows). A pure function: nothing is tried and
    nothing falls back."""
    ok = (D % 16 == 0 and 0 < D <= WGMMA_MAX_D
          and all(st > 0 and st % 8 == 0 for st in strides)
          and all(p % 16 == 0 for p in ptrs))
    return "wgmma" if ok else "mma"


def _launch(name, q, k, v, true_lens, lse=None):
    dev = q.device
    if not (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape):
        raise ValueError(f"{name}: bad ranks")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"{name}: k/v must be (B, Hkv, S, D) of q's B, S, D")
    if H % Hkv:
        raise ValueError(f"{name}: {H} query heads over {Hkv} kv heads")
    build.check_head_dim(name, D)
    dtype = build.check_cuda(name, dev, rows=True, q=q, k=k, v=v)
    lens = None
    if true_lens is not None:
        if tuple(true_lens.shape) != (B,):
            raise ValueError(f"{name}: true_lens must be (B,)")
        lens = build.as_int32(true_lens, dev)
    out = torch.empty_like(q)  # q's strides: a transposed view stays a view
    if B * S == 0:
        return out
    if out.stride() != q.stride():
        raise ValueError(f"{name}: q must be a permutation of a dense tensor")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    path = "mma"
    if dtype == torch.bfloat16:
        path = bf16_path(D, strides, (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    fname = ("flash_prefill_bf16_wgmma_launch" if path == "wgmma"
             else build.entry("flash_prefill_launch", dtype))
    lib = build.load(_SOURCE, _SIGNATURES)
    code = getattr(lib, fname)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, S, H, Hkv, D, *strides, torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, _SOURCE, lib, code)
    build.launches[name] += 1
    build.path_launches[name, path] += 1
    return out


def _rows_ok(t):
    """Unit stride on the last dimension, 16-byte rows and base: what the
    kernels read in place."""
    return (t.stride(-1) == 1 and all(st % 4 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _dense_like(t):
    """``t`` itself if a tensor of its strides can be allocated (a
    permutation of a dense tensor), else a contiguous copy."""
    return t if torch.empty_like(t).stride() == t.stride() else t.contiguous()


def flash_prefill_fwd(q, k, v):
    """flash_prefill's output and each query's log-sum-exp (B, H, S) of its
    scaled scores, which its backward takes: the plain versions on the CPU,
    one launch of ``csrc/flash_prefill.cu`` (counted as ``flash_prefill``)
    on the card."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v), flash_prefill_lse_ref(q, k)
    B, H, S, _ = q.shape
    lse = torch.empty((B, H, S), device=q.device, dtype=torch.float32)
    return _launch("flash_prefill", q, k, v, None, lse), lse


def flash_prefill_bwd(q, k, v, o, lse, do):
    """The backward of :func:`flash_prefill`: (dq, dk, dv) from its inputs,
    its output ``o`` and ``lse`` (:func:`flash_prefill_fwd`) and ``do``, the
    gradient of ``o``. A tensor on the CPU takes
    :func:`~repro_torch.kernels.ref.flash_prefill_bwd_ref`; a CUDA tensor
    launches ``csrc/flash_prefill_bwd.cu`` (dq with q's strides, dk k's, dv
    v's) or raises."""
    if q.device.type == "cpu":
        return flash_prefill_bwd_ref(q, k, v, o, lse, do)
    name = "flash_prefill_bwd"
    dev = q.device
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: o and do must be q's shape, v k's")
    if B * S == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    build.check_head_dim(name, D)
    k, v = _dense_like(k), _dense_like(v)
    if not _rows_ok(do):
        do = do.contiguous()
    build.refuse_bf16_training(name, q, k, v, o, do)
    build.check_cuda(name, dev, rows=True, q=q, k=k, v=v, o=o, do=do)
    build.check_cuda(name, dev, lse=lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.stride() != q.stride() or o.stride() != q.stride():
        raise ValueError(f"{name}: q and o must be one permutation of a dense tensor")
    lib = build.load(_BWD_SOURCE, _BWD_SIGNATURES)
    hs, fold = bwd_plan(B, S, H, Hkv, D, build.sm_count(dev))
    # scratch: Δ (rounded up to 16 bytes), the head parts' dK and dV, the
    # dQ partials
    n_delta = -(-B * H * S // 4) * 4
    n_part = 2 * hs * B * Hkv * S * D if hs > 1 else 0
    n_dq = dq_part_rows(S) * B * H * D if fold else 0
    scratch = torch.empty((n_delta + n_part + n_dq,), device=dev, dtype=torch.float32)
    ptr = scratch.data_ptr()
    code = lib.flash_prefill_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), ptr, ptr + 4 * n_delta if n_part else None,
        ptr + 4 * (n_delta + n_part) if fold else None, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, H, Hkv, D, hs, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *do.stride()[:3], torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, _BWD_SOURCE, lib, code)
    build.launches[name] += 1
    return dq, dk, dv


class _FlashPrefillFn(torch.autograd.Function):
    """flash_prefill with its backward: the forward keeps out and each
    query's log-sum-exp; the backward recomputes the probabilities from
    them (FlashAttention-2)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_prefill_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        return flash_prefill_bwd(*ctx.saved_tensors, do)


def flash_prefill(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        build.refuse_bf16_training("flash_prefill", q, k, v)
        return _FlashPrefillFn.apply(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v)
    return _launch("flash_prefill", q, k, v, None)


def flash_prefill_ragged(
    q: torch.Tensor,  # (B, H, S, D) — S is the padded length
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    true_lens: torch.Tensor,  # (B,) int — live tokens per row (may be 0)
) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_prefill_ragged_ref(q, k, v, true_lens)
    return _launch("flash_prefill_ragged", q, k, v, true_lens)
