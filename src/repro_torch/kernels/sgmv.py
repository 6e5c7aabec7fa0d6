"""Multi-LoRA projections (``csrc/fused_sgmv.cu``).

``fused_sgmv`` is the counterpart of ``repro.kernels.sgmv.fused_sgmv``:
``x·W + scale·(x·A[id])·B[id]`` with one adapter id per batch row; a
negative id keeps ``x·W`` and drops the delta. ``sgmv`` is the counterpart
of ``repro.kernels.sgmv.sgmv``, the delta alone: a negative id gives a zero
row. Both run the same source with the base term compiled in or out. A
tensor on the CPU takes the plain version
(:func:`~repro_torch.kernels.ref.fused_sgmv_ref`,
:func:`~repro_torch.kernels.ref.sgmv_ref`); a CUDA tensor launches the
kernel or raises. Every rank from 1 to ``MAX_RANK`` is taken. The inputs
are float32 or bfloat16, all of one type (the output takes it); bfloat16
computes what the reference's kernel computes on bf16 inputs (products of
the bf16 values with f32 sums, h = x·A kept in f32, B promoted, y rounded
once). A launch takes one of four loops, chosen from its shape and
counted per loop (``ops.path_launch_counts``): M = B·S <= 16 rows (decode)
the one-launch cluster loop of ``csrc/fused_sgmv_cluster.cu`` in bf16
with d_in and d_out multiples of 8 on 16-byte bases where W is large
enough for it to win, else the skinny loop of ``csrc/fused_sgmv.cu``
(every f32 decode launch); more rows the
``wgmma`` + TMA loop of ``csrc/fused_sgmv_wgmma.cu`` in bf16 on the same
shapes and bases, the rest the ``mma.sync`` loop of ``csrc/fused_sgmv.cu``
(:func:`bf16_path`).

``fused_sgmv`` is differentiable: under autograd, with an input that
requires grad, it runs as a ``torch.autograd.Function``. Its backward
computes the base parts, ``dx = dy·Wᵀ`` and (only where W needs a
gradient) ``dW = Σ xᵀ·dy``, as plain library products, and everything
indexed by adapter id (the shrinks, the per-adapter dA and dB and the delta
of dx) in ``csrc/lora_grad.cu`` on the card, or all of it in
:func:`~repro_torch.kernels.ref.fused_sgmv_bwd_ref` on the CPU. ``sgmv``
serves the engine only: on the card it refuses an input that requires grad
(``build.check_cuda``). The backward kernels take float32 only: a bfloat16
input that requires grad on the card raises ``NotImplementedError``.
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
    "fused_sgmv_bf16_launch": "pppppppiiiiifp",  # bf16 x, w, A, B, y; f32 scratch
    "sgmv_bf16_launch": "ppppppiiiiifp",
    # (M, d_in, d_out, R, has_base) -> floats of scratch a launch needs
    "fused_sgmv_scratch_floats": "iiiii",
}
_WGMMA_SOURCE = "fused_sgmv_wgmma"
_WGMMA_SIGNATURES = {
    # x, w, lora_a, lora_b, ids, y, scratch, its floats, counters (NULL: the
    # shrink is not split), their count, M, S, d_in, d_out, r, N, SMs,
    # scale, stream
    "fused_sgmv_bf16_wgmma_launch": "ppppppplpiiiiiiiifp",
    # B, S, d_in, d_out, r, SMs, out: 6 int64s -> the launch's plan
    "fused_sgmv_wgmma_plan": "iiiiiip",
}
_CLUSTER_SOURCE = "fused_sgmv_cluster"
_CLUSTER_SIGNATURES = {
    # x, w, lora_a, lora_b, ids, y, h (tagged f32 scratch, zeros at first),
    # its 64-bit words, M, S, d_in, d_out, r, SMs, scale, stream
    "fused_sgmv_cluster_launch": "pppppppliiiiiifp",
    # M, S, d_in, d_out, SMs, out: 4 int64s -> the plan
    "fused_sgmv_cluster_plan": "iiiiip",
    # cluster size -> clusters of that size the card holds at once
    "fused_sgmv_cluster_capacity": "i",
}
_GRAD_SOURCE = "lora_grad"
_GRAD_SIGNATURES = {
    # x, dy, a, b, ids, h, g, parts_h, parts_g, parts_a, parts_b (NULL where
    # unsplit), counters, da, db, dx (NULL: none), B, S, N, d_in, d_out, r,
    # then lora_grad_plan's r8, ks_h, kper_h, ks_g, kper_g, ms, sper, scale,
    # stream
    "lora_grad_launch": "pppppppppppppppiiiiiiiiiiiiifp",
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


# csrc/fused_sgmv_cluster.cu's geometry and plan (make_plan)
CLUSTER_COLS = 128  # output columns of a W slab: 256 bytes of a bf16 W row
CLUSTER_KS = 64  # k rows of a ring stage
CLUSTER_MAX_CS = 16  # blocks of a cluster at most (non-portable past 8)
# The decode launches the cluster loop takes: W of at least 2^22 elements
# (8 MB in bf16), or 2^21 at more than 8 rows. Below them its fixed costs
# (a cluster launch, the merge in distributed shared memory, the hand-off
# of h) outweigh the W it streams faster, and the skinny loop was as fast
# or faster. Both loops through their C entries, in turns on the H100
# (scripts/decode_kernels.py --dtype bf16, NVIDIA H100 80GB HBM3, 700 W,
# us cold, cluster against skinny): W of 2^24 (4096 x 4096) at 2, 4, 8, 16
# rows 20.62/27.19, 21.14/30.50, 22.42/33.60, 26.63/58.74; 2^22 (2048 x
# 2048) at 2, 4, 8, 16 rows 11.76/12.79, 12.23/13.50, 11.95/14.49,
# 13.44/23.29; 2^21 (1024 x 2048, 2048 x 1024) at 8 rows 10.35/10.08,
# 10.78/10.44, at 9 rows 11.35/13.90, 11.14/15.21, at 12 rows
# 11.57/14.41, 11.13/14.83, at 16 rows 11.42/15.30, 11.52/16.94; below
# 2^21 at 2 or 8 rows (1024 x 1024, 2048 x 576, 2560 x 256) 9.94/8.33,
# 9.30/8.45, 9.70/8.57, 9.44/7.49. Rows between those measured are
# taken as their neighbours.
CLUSTER_MIN_WEIGHTS = 1 << 22
CLUSTER_MIN_WEIGHTS_WIDE = 1 << 21  # at more than 8 rows


def bf16_path(M: int, d_in: int, d_out: int, ptrs, dtype: torch.dtype) -> str:
    """The loop of a ``fused_sgmv`` launch of M = B·S rows in ``dtype``,
    from its shape alone. At most 16 rows with d_in and d_out multiples of
    4: ``"cluster"`` (``csrc/fused_sgmv_cluster.cu``: one launch on
    split-K clusters) for bf16 with d_in and d_out multiples of 8, every
    base address in ``ptrs`` (x, W, A, B) on 16 bytes (its 16-byte copies)
    and W of at least ``CLUSTER_MIN_WEIGHTS`` elements
    (``CLUSTER_MIN_WEIGHTS_WIDE`` past 8 rows), else ``"skinny"``
    (``csrc/fused_sgmv.cu``'s decode loop, every f32 decode launch). More
    rows: ``"wgmma"`` (``csrc/fused_sgmv_wgmma.cu``: TMA loads and
    warpgroup products) for bf16 on the same shapes and bases (TMA's
    16-byte strides); else ``"mma"`` (``csrc/fused_sgmv.cu``'s tiled
    mma.sync loop, which takes 8-byte rows, and every tiled f32 launch). A
    pure function: nothing is tried and nothing falls back."""
    wide = (dtype == torch.bfloat16 and d_in % 8 == 0 and d_out % 8 == 0
            and all(p % 16 == 0 for p in ptrs))
    if M <= SKINNY_MAX_M and d_in % 4 == 0 and d_out % 4 == 0:
        least = CLUSTER_MIN_WEIGHTS if M <= 8 else CLUSTER_MIN_WEIGHTS_WIDE
        return "cluster" if wide and d_in * d_out >= least else "skinny"
    return "wgmma" if wide else "mma"


def cluster_plan(M: int, S: int, d_in: int, d_out: int, sms: int, capacity) -> dict:
    """The plan of a ``"cluster"`` launch (``csrc/fused_sgmv_cluster.cu``:
    make_plan) on a card of ``sms`` SMs that holds ``capacity(cs)``
    clusters of ``cs`` blocks at once: ``cols`` W slabs of 128 columns and
    ``nb`` = M / S shrink clusters (one a batch row), each of ``cs`` blocks,
    the largest power of two up to ``CLUSTER_MAX_CS`` with cols·cs <= 2·sms, 8·cs <=
    d_in and cols + nb <= capacity(cs), so the whole grid is co-resident.
    Block z of a cluster takes k rows ``k_ranges[z]`` = [8·floor(z·(d_in /
    8) / cs), 8·floor((z + 1)·(d_in / 8) / cs)). None where no size fits."""
    cols, nb = -(-d_out // CLUSTER_COLS), M // S
    cs = CLUSTER_MAX_CS
    while cs >= 1:
        if (cs == 1 or (cols * cs <= 2 * sms and 8 * cs <= d_in)) and cols + nb <= capacity(cs):
            break
        cs //= 2
    if cs < 1:
        return None
    k8 = d_in // 8
    return {"cols": cols, "nb": nb, "cs": cs, "blocks": (cols + nb) * cs,
            "k_ranges": [(8 * (z * k8 // cs), 8 * ((z + 1) * k8 // cs)) for z in range(cs)]}


WGMMA_PLAN_KEYS = ("shrink_parts", "shrink_kper", "base_parts", "base_kper",
                   "scratch_floats", "counters")


def wgmma_plan(lib, B: int, S: int, d_in: int, d_out: int, r: int, sms: int) -> dict:
    """How ``csrc/fused_sgmv_wgmma.cu`` (``lib``) splits a launch on a card
    of ``sms`` SMs, from the source's own ``make_plan``: the shrink's and
    the tile loop's parts of d_in and k stages a part, and the f32 scratch
    and int32 counters the launch needs ({``WGMMA_PLAN_KEYS``})."""
    import ctypes

    out = (ctypes.c_int64 * len(WGMMA_PLAN_KEYS))()
    code = lib.fused_sgmv_wgmma_plan(B, S, d_in, d_out, r, sms, ctypes.addressof(out))
    build.check_error("fused_sgmv", _WGMMA_SOURCE, lib, code)
    return dict(zip(WGMMA_PLAN_KEYS, out))


# csrc/lora_grad.cu's tiles, which lora_grad_plan splits the work over
LORA_GRAD_TM = 64  # tokens of a shrink tile
LORA_GRAD_KC = 32  # d rows of a shrink stage
LORA_GRAD_TD = 64  # columns of an outer block
LORA_GRAD_MAX_PARTS = 8


def _split(n: int, want: int, least: int, step: int) -> tuple[int, int]:
    """``n`` in at most ``want`` parts of at least ``least``, each a
    multiple of ``step``: (parts, per)."""
    parts = max(min(n // least, want), 1)
    per = -(-n // parts)
    per = -(-per // step) * step
    return -(-n // per), per


def _lora_grad_layout(M, N, d_in, d_out, r, r8, ks_h, ks_g, ms):
    """Floats of lora_grad's scratch buffers, in order: h, g, the shrink's
    parts of h and of g, the outer products' parts of dA and of dB (0
    where unsplit), each rounded up to 16 bytes."""
    sizes = (M * r8, M * r8, ks_h * M * r8 if ks_h > 1 else 0,
             ks_g * M * r8 if ks_g > 1 else 0, ms * N * d_in * r if ms > 1 else 0,
             ms * N * r * d_out if ms > 1 else 0)
    return tuple(-(-n // 4) * 4 for n in sizes)


_counters: dict = {}
_cluster_h: dict = {}


def cluster_h(dev, stream, M: int, r: int) -> torch.Tensor:
    """The cluster loop's scratch of h for a launch of M rows at rank r: the
    shrink's k parts, each an f32 and its launch's tag in 64 bits. No two
    launches that share one may run at the same time (one would overwrite
    the other's parts, whose readers then wait until the kernel traps).
    Outside a graph capture: 16 parts of 16 rows x 128 ranks, zeros when
    made, one per device and stream (the launches on a stream run in
    turn), kept from launch to launch, so a launch needs no memset or
    allocation. Inside a capture: 16 parts of M x r of its own, zeros
    (the graph zeroes them before the launch at each replay), so a replay
    on any stream shares no scratch with a live launch."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((CLUSTER_MAX_CS * M * r,), device=dev, dtype=torch.int64)
    h = _cluster_h.get((dev, stream))
    if h is None:
        h = _cluster_h[(dev, stream)] = torch.zeros(
            (CLUSTER_MAX_CS * SKINNY_MAX_M * MAX_RANK,), device=dev, dtype=torch.int64)
    return h


def _zero_counters(dev, stream, n: int) -> torch.Tensor:
    """The counts of finished shrink parts of lora_grad and of the wgmma
    loop of fused_sgmv: at least ``n`` int32 zeros, one buffer per device and
    stream (the launches on a stream run in turn). The kernels leave them
    zero."""
    buf = _counters.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _counters[(dev, stream)] = torch.zeros((n,), device=dev, dtype=torch.int32)
    return buf


def lora_grad_plan(B: int, S: int, N: int, d_in: int, d_out: int, r: int, sms: int):
    """How ``csrc/lora_grad.cu`` splits the work on a card of ``sms`` SMs
    (the wrapper passes it to the kernel): (r8, (ks_h, kper_h), (ks_g,
    kper_g), (ms, sper), scratch floats). The rank runs padded to
    r8, a multiple of 8. The shrink splits d_in (d_out) into ks parts of
    kper rows, at least 256 each, until the 64-token tiles (h and g) give
    four blocks an SM, and the last part's block of a tile adds the parts
    in order; the outer products split the sequence into ms parts of sper
    tokens, at least 64 each, until the blocks of the adapters that can
    have rows give two blocks an SM, and a third launch adds the parts in
    order."""
    M = B * S
    r8 = -(-r // 8) * 8
    tiles = 2 * B * -(-S // LORA_GRAD_TM)
    want_k = min(-(-4 * sms // tiles), LORA_GRAD_MAX_PARTS)
    ks_h = _split(d_in, want_k, 256, LORA_GRAD_KC)
    ks_g = _split(d_out, want_k, 256, LORA_GRAD_KC)
    blocks = min(N, B) * (-(-d_in // LORA_GRAD_TD) + -(-d_out // LORA_GRAD_TD))
    ms = _split(S, min(-(-2 * sms // blocks), LORA_GRAD_MAX_PARTS), 64, 1)
    floats = sum(_lora_grad_layout(M, N, d_in, d_out, r, r8, ks_h[0], ks_g[0], ms[0]))
    return r8, ks_h, ks_g, ms, floats


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
    dtype = build.check_cuda(name, x.device, **tensors)
    return B, S, d_in, d_out, r, dtype


def _launch(name, x, w, lora_a, lora_b, adapter_ids, scale):
    dev = x.device
    B, S, d_in, d_out, r, dtype = _check(name, x, w, lora_a, lora_b, adapter_ids)
    ids = build.as_int32(adapter_ids, dev)
    y = torch.empty((B, S, d_out), device=dev, dtype=dtype)
    if B * S == 0 or d_out == 0:
        return y
    if w is None:
        lib = build.load(_SOURCE, _SIGNATURES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(lib.fused_sgmv_scratch_floats(B * S, d_in, d_out, r, 0), dev)
        code = getattr(lib, build.entry("sgmv_launch", dtype))(
            x.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(), ids.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), B * S, S, d_in, d_out, r,
            float(scale), stream)
        build.check_error(name, _SOURCE, lib, code)
        build.launches[name] += 1
        return y
    ptrs = (x.data_ptr(), w.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr())
    path = bf16_path(B * S, d_in, d_out, ptrs, dtype)
    source, sigs = {"wgmma": (_WGMMA_SOURCE, _WGMMA_SIGNATURES),
                    "cluster": (_CLUSTER_SOURCE, _CLUSTER_SIGNATURES)}.get(
                        path, (_SOURCE, _SIGNATURES))
    lib = build.load(source, sigs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if path == "cluster":
        h = cluster_h(dev, stream, B * S, r)
        code = lib.fused_sgmv_cluster_launch(
            *ptrs, ids.data_ptr(), y.data_ptr(), h.data_ptr(), h.numel(), B * S, S, d_in, d_out,
            r, build.sm_count(dev), float(scale), stream)
    elif path == "wgmma":
        sms = build.sm_count(dev)
        plan = wgmma_plan(lib, B, S, d_in, d_out, r, sms)
        scratch = _scratch(plan["scratch_floats"], dev)
        counters = (_zero_counters(dev, stream, plan["counters"]) if plan["counters"]
                    else None)
        code = lib.fused_sgmv_bf16_wgmma_launch(
            *ptrs, ids.data_ptr(), y.data_ptr(), scratch.data_ptr(), scratch.numel(),
            None if counters is None else counters.data_ptr(),
            0 if counters is None else counters.numel(), B * S, S, d_in, d_out, r,
            lora_a.shape[0], sms, float(scale), stream)
    else:
        scratch = _scratch(lib.fused_sgmv_scratch_floats(B * S, d_in, d_out, r, 1), dev)
        code = getattr(lib, build.entry("fused_sgmv_launch", dtype))(
            *ptrs, ids.data_ptr(), y.data_ptr(), scratch.data_ptr(), B * S, S, d_in,
            d_out, r, float(scale), stream)
    build.check_error(name, source, lib, code)
    build.launches[name] += 1
    build.path_launches[name, path] += 1
    return y


def _scratch(floats: int, dev) -> torch.Tensor:
    return torch.empty((max(1, floats),), device=dev, dtype=torch.float32)


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
    build.refuse_bf16_training(name, *tensors.values())
    build.check_cuda(name, dev, **tensors)
    ids = build.as_int32(adapter_ids, dev)
    da, db = torch.empty_like(lora_a), torch.empty_like(lora_b)
    if B * S == 0:
        return da.zero_(), db.zero_()
    lib = build.load(_GRAD_SOURCE, _GRAD_SIGNATURES)
    r8, (ks_h, kper_h), (ks_g, kper_g), (ms, sper), floats = lora_grad_plan(
        B, S, N, d_in, d_out, r, build.sm_count(dev))
    scratch = torch.empty((floats,), device=dev, dtype=torch.float32)
    bufs, at = [], scratch.data_ptr()
    for n in _lora_grad_layout(B * S, N, d_in, d_out, r, r8, ks_h, ks_g, ms):
        bufs.append(at if n else None)
        at += 4 * n
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the shrink's count of finished parts, per 64-token tile of h and g
    counters = (_zero_counters(dev, stream, 2 * B * -(-S // LORA_GRAD_TM)).data_ptr()
                if ks_h > 1 or ks_g > 1 else None)
    code = lib.lora_grad_launch(
        x.data_ptr(), dy.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
        ids.data_ptr(), *bufs, counters, da.data_ptr(), db.data_ptr(),
        None if dx is None else dx.data_ptr(), B, S, N, d_in, d_out, r, r8, ks_h, kper_h,
        ks_g, kper_g, ms, sper, float(scale), stream)
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
        build.refuse_bf16_training("fused_sgmv", x, w, lora_a, lora_b)
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
