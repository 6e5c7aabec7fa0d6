"""Causal flash attention for a fresh prefill (``csrc/flash_prefill.cu``).

``flash_prefill`` is the counterpart of
``repro.kernels.flash_prefill.flash_prefill``: causal GQA attention in the
head-major layout ``q (B, H, S, D)``, ``k/v (B, Hkv, S, D)``.
``flash_prefill_ragged`` is the counterpart of ``flash_prefill_ragged``:
the same with ``true_lens`` (B,) live tokens per row; padded queries and
rows of length 0 come out as zeros. Any group size and any head dim that is
a multiple of 4 up to 256 is taken. The inputs may be strided views (a
``(B, S, H, D)`` tensor transposed to head-major is read in place) as long
as D has unit stride; the output has q's strides. A tensor on the CPU takes
the plain version (:func:`~repro_torch.kernels.ref.flash_prefill_ref`,
:func:`~repro_torch.kernels.ref.flash_prefill_ragged_ref`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import flash_prefill_ragged_ref, flash_prefill_ref

_SOURCE = "flash_prefill"
# q, k, v, true_lens (NULL: S in every row), out, B, S, H, Hkv, D, then the
# b, h, s element strides of q, k and v (out has q's), stream
_SIGNATURES = {"flash_prefill_launch": "pppppiiiiilllllllllp"}


def _launch(name, q, k, v, true_lens):
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
    build.check_cuda_f32(name, dev, rows=True, q=q, k=k, v=v)
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
    lib = build.load(_SOURCE, _SIGNATURES)
    code = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(),
        B, S, H, Hkv, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_error(name, _SOURCE, lib, code)
    build.launches[name] += 1
    return out


def flash_prefill(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
) -> torch.Tensor:
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
