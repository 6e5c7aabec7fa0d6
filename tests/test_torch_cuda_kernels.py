"""CUDA kernels of the port against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip without one; the card
is detected inside the ``cuda`` fixture, never at import. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Inputs come from numpy with a fixed seed. The kernel-against-plain tests
run in f32 and in bf16 (``DTYPES``; bf16 within 2e-2 of the output's
largest magnitude and each element within one bf16 rounding of the plain
f32 value, see ``_match``). f32 tolerances: fused_sgmv and sgmv
1e-4 of the largest reference magnitude (f32 sums of up to 2048 terms, in
another order); the attention kernels 1e-5 absolute (softmax weights times
unit-scale values); the backward kernels (flash_prefill_bwd, lora_grad)
1e-4 of the largest plain gradient (sums over S or B·S terms).
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    build,
    flash_prefill,
    flash_prefill_bwd,
    flash_prefill_fwd,
    flash_prefill_ragged,
    fused_sgmv,
    lora_grad,
    ops,
    paged_attention,
    ragged_extend,
    ref,
    sgmv,
)

flash_prefill_mod = importlib.import_module("repro_torch.kernels.flash_prefill")
sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    """A numpy array on ``dev``; float arrays in ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.to(dtype) if t.is_floating_point() else t


# The kernel-against-plain tests run in both float types the kernels take.
# bf16 inputs are the f32 draws rounded; kernel and plain version both sum
# in f32 and round the output to bf16 once, so they differ by a rounding of
# the output at most: held to 2e-2 of the output's largest magnitude, the
# reference's bf16 tolerance (tests/test_kernels.py), and each element to
# one bf16 rounding of the plain f32 value (``_match``).
DTYPES = [torch.float32, torch.bfloat16]


def _plain(fn, *args, **kw):
    """``fn`` (a plain version) on ``args``; on bf16 inputs also on them
    upcast to f32 (else None)."""
    want = fn(*args, **kw)
    if want.dtype == torch.float32:
        return want, None
    up = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    return want, fn(*up, **kw)


def _bf16_spacing(x):
    """The distance between neighbouring bf16 values at each |x| (f32); 0
    where x is 0."""
    _, e = torch.frexp(x)  # |x| in [2^(e-1), 2^e)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def _match(got, want, f32_tol, dtype, want_f32=None):
    """got (the kernel) within f32_tol of want (the plain version) in f32.
    In bf16, within 2e-2 of max|want|, and each element within one bf16
    rounding of want_f32 (the plain version on the inputs upcast):
    |got − bf16(want_f32)| at most one bf16 spacing + f32_tol + 2^-16 of
    max|want_f32| (an f32 operand split in two halves keeps 16 bits)."""
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        return float((got - want).abs().max()) <= f32_tol
    if float((got.float() - want.float()).abs().max()) > 2e-2 * float(want.float().abs().max()):
        return False
    w = want_f32.float()
    atol = f32_tol + 2.0 ** -16 * float(w.abs().max())
    err = (got.float() - w.to(torch.bfloat16).float()).abs()
    return bool((err <= _bf16_spacing(w) + atol).all())


@pytest.mark.parametrize("B,S,d_in,d_out,r,N", [
    (8, 1, 1024, 2048, 32, 8),   # decode rows: the skinny path
    (8, 1, 2048, 1024, 32, 8),
    (2, 8, 1024, 1024, 16, 3),   # 16 rows of two adapters: skinny
    (3, 5, 100, 328, 8, 2),      # skinny, a part-filled column block
    (5, 1, 97, 64, 4, 2),        # few rows, d_in % 4 != 0: the tiled path
    (4, 37, 96, 320, 16, 3),
    (2, 256, 1024, 1024, 32, 8),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_sgmv_cuda_matches_plain(cuda, dtype, B, S, d_in, d_out, r, N):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, d_in), np.float32)
    w = rng.standard_normal((d_in, d_out), np.float32) * 0.03
    a = rng.standard_normal((N, d_in, r), np.float32) * 0.03
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.03
    ids = rng.integers(-1, N, size=(B,)).astype(np.int32)
    ids[0] = -1
    args = [_t(v, cuda, dtype) for v in (x, w, a, b, ids)]
    for zero_w in (False, True):
        if zero_w:
            args[1] = torch.zeros_like(args[1])
        before = ops.launch_counts()["fused_sgmv"]
        got = fused_sgmv(*args, scale=2.0)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_sgmv"] == before + 1
        want, want32 = _plain(ref.fused_sgmv_ref, *args, scale=2.0)
        assert _match(got, want, 1e-4 * float(want.abs().max()), dtype, want32)
        # a negative id drops the delta: the row is exactly x·W
        assert torch.equal(got[0], torch.zeros_like(got[0])) or not zero_w


@pytest.mark.parametrize("B,S,T,H,Hkv,D", [
    (8, 256, 2048, 16, 8, 128),
    (4, 19, 200, 4, 2, 128),
    (3, 1, 96, 8, 8, 64),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_extend_cuda_matches_plain(cuda, dtype, B, S, T, H, Hkv, D):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    lens = np.array([[0, 1, 37 % (S + 1), S][i % 4] for i in range(B)], np.int32)
    start = np.array([min(T - int(lens[i]), 5 + 311 * i) for i in range(B)],
                     np.int32)
    args = [_t(a, cuda, dtype) for a in (q, k, v, start, lens)]
    got = ragged_extend(*args)
    torch.cuda.synchronize()
    want, want32 = _plain(ref.ragged_extend_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # true_lens == 0


# The engine's buckets (S = 256, 64, 8 at the smallest) with decode riders
# (true_lens 1) at long starts, group sizes 1..8, head dims 32..128, and S
# off the q tile (128 query vectors, 128/G tokens). At these shapes the
# q tiles do not fill the card, so the KV range of a long row is split over
# blocks and merged by the combine pass, beside rows too short to split.
_RAGGED = [
    # B, S, T, H, Hkv, D, lens, starts
    (8, 64, 2048, 16, 8, 128, [0, 1, 37, 64, 64, 37, 1, 64],
     [0, 2047, 500, 0, 1984, 1011, 1500, 300]),
    (8, 8, 2048, 16, 8, 128, [0, 1, 5, 8, 8, 5, 1, 8],
     [0, 2047, 500, 0, 2040, 1011, 1500, 300]),
    (4, 50, 700, 16, 4, 64, [50, 1, 0, 33], [650, 699, 0, 7]),  # G = 4, D = 64
    (4, 20, 500, 16, 2, 32, [20, 1, 13, 20], [480, 499, 0, 100]),  # G = 8, D = 32
    (2, 33, 3000, 8, 8, 128, [33, 1], [2967, 2999]),  # G = 1, a 64-row tile
    (3, 100, 1200, 8, 4, 96, [100, 7, 1], [1100, 0, 1199]),  # D = 96
]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,lens,starts", _RAGGED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_extend_cuda_engine_shapes(cuda, dtype, B, S, T, H, Hkv, D, lens, starts):
    from repro_torch.kernels import build
    from repro_torch.kernels.ragged_extend import _SIGNATURES

    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    args = [_t(a, cuda, dtype) for a in (q, k, v, np.asarray(starts, np.int32),
                                  np.asarray(lens, np.int32))]
    before = ops.launch_counts()["ragged_extend"]
    got = ragged_extend(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ragged_extend"] == before + 1
    want, want32 = _plain(ref.ragged_extend_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    for b, n in enumerate(lens):  # padded queries and empty rows are zeros
        assert torch.equal(got[b, n:], torch.zeros_like(got[b, n:]))
    # a fixed order of sums, the split's combine included
    assert torch.equal(ragged_extend(*args), got)
    lib = build.load("ragged_extend", _SIGNATURES)
    assert lib.ragged_extend_kv_parts(B, S, T, H, Hkv, D) > 1  # split


# Head dims and group sizes past the qwen3 shapes: D = 20 (no multiple of
# 8, padded to the k8 step), 160 and 256 (wide heads: 32-key stages, q
# tiles of at most 64 rows, D split over the warps of a row), G = 1, 3, 7
# (a token's heads straddle two q tiles; dead rows past S·G) and 8, each
# with decode riders, empty rows and part-filled chunks.
_RAGGED_WIDE = [
    # B, S, T, H, Hkv, D, lens, starts
    (4, 64, 700, 8, 8, 20, [64, 1, 0, 33], [600, 699, 0, 7]),       # D = 20, G = 1
    (4, 64, 900, 12, 4, 160, [64, 1, 0, 50], [800, 899, 0, 300]),   # D = 160, G = 3
    (4, 50, 1200, 14, 2, 256, [50, 1, 17, 0], [1100, 1199, 0, 5]),  # D = 256, G = 7
    (8, 256, 2048, 28, 4, 128, [0, 1, 37, 256, 256, 37, 1, 256],    # qwen2-vl: G = 7
     [0, 2047, 500, 0, 1792, 1011, 64, 300]),
    (8, 256, 2048, 8, 1, 256, [0, 1, 37, 256, 256, 37, 1, 256],     # gemma-2b: G = 8
     [0, 2047, 500, 0, 1792, 1011, 64, 300]),
    (8, 256, 2048, 32, 8, 160, [0, 1, 37, 256, 256, 37, 1, 256],    # stablelm-12b
     [0, 2047, 500, 0, 1792, 1011, 64, 300]),
    (3, 8, 300, 16, 16, 256, [8, 1, 5], [292, 299, 0]),             # G = 1, D = 256
    (2, 1, 4000, 7, 1, 160, [1, 1], [3999, 10]),                    # decode riders alone
    (8, 256, 2048, 16, 16, 64, [0, 1, 37, 256, 256, 37, 1, 256],    # seamless-m4t
     [0, 2047, 500, 0, 1792, 1011, 64, 300]),
    (2, 512, 520, 16, 16, 64, [512, 512], [0, 0]),                  # its static prefill
]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,lens,starts", _RAGGED_WIDE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_extend_cuda_wide_heads_and_any_group(cuda, dtype, B, S, T, H, Hkv, D, lens,
                                                     starts):
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    args = [_t(a, cuda, dtype) for a in (q, k, v, np.asarray(starts, np.int32),
                                  np.asarray(lens, np.int32))]
    before = ops.launch_counts()["ragged_extend"]
    got = ragged_extend(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ragged_extend"] == before + 1
    want, want32 = _plain(ref.ragged_extend_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    for b, n in enumerate(lens):
        assert torch.equal(got[b, n:], torch.zeros_like(got[b, n:]))
    assert torch.equal(ragged_extend(*args), got)


# The tiled path of fused_sgmv.cu (M > 16, or d_in / d_out no multiple of
# 4): a shrink pass, then 128 x 128 output tiles on the tensor cores in
# 3xTF32. Tiles of 128 rows straddle batch rows of different ids wherever S
# is no multiple of 128. ``ids``: "mixed" draws ids in [-1, N) with batch
# row 0 at -1; "none" sets every id to -1; "repeat" gives batch rows 0 and 2
# the same adapter, so one tile meets an id twice.
_TILED = [
    # B, S, d_in, d_out, r, N, ids, scale
    (1, 17, 1024, 1024, 32, 4, "repeat", 1.0),  # M = 17, just past the skinny path
    (4, 37, 256, 320, 16, 3, "mixed", 0.5),     # tiles straddle 3+ batch rows
    (4, 37, 256, 320, 16, 3, "repeat", 2.0),
    (3, 50, 128, 256, 32, 2, "none", 2.0),      # every id -1
    (2, 100, 256, 256, 4, 3, "mixed", 0.25),    # each compiled rank
    (2, 100, 256, 256, 8, 3, "mixed", 0.25),
    (2, 100, 256, 256, 16, 3, "mixed", 0.25),
    (2, 100, 256, 256, 32, 3, "mixed", 0.25),
    (2, 100, 256, 256, 64, 3, "mixed", 0.25),
    (3, 60, 97, 328, 8, 2, "mixed", 1.5),       # d_in % 4 != 0: 4-byte copies
    (3, 60, 100, 320, 8, 2, "repeat", 1.5),     # a part-filled k slice
    (3, 60, 100, 330, 8, 2, "mixed", 1.5),      # d_out % 4 != 0
    (3, 60, 64, 101, 8, 2, "mixed", 1.5),       # odd d_out: scalar stores
    (8, 256, 1024, 2048, 32, 8, "mixed", 2.0),  # the engine's q projection
    (8, 64, 1024, 1024, 32, 8, "mixed", 1.0),   # smaller buckets: d_in split
    (8, 8, 1024, 2048, 32, 8, "repeat", 1.0),   # over blocks, parts added
    (3, 60, 512, 101, 8, 2, "mixed", 1.5),      # the split with scalar stores
    (2, 100, 256, 256, 1, 3, "mixed", 0.25),    # ranks between the compiled ones:
    (2, 100, 256, 256, 12, 3, "repeat", 0.25),  # A and B staged with 4-byte copies,
    (2, 100, 256, 256, 128, 3, "mixed", 0.25),  # ranks past r zero; 128 in halves
    (3, 60, 97, 330, 12, 2, "mixed", 1.5),      # r = 12 with scalar stores
    (8, 256, 4096, 4096, 32, 8, "mixed", 1.0),  # llama-7b's q projection
    (8, 64, 1024, 2048, 128, 8, "repeat", 1.0), # r = 128 with d_in split
    (8, 256, 2560, 2560, 32, 8, "mixed", 1.0),  # recurrentgemma-2b q
    (8, 256, 2560, 256, 32, 8, "repeat", 1.0),  # recurrentgemma-2b k (MQA)
    (8, 256, 2048, 2048, 32, 8, "mixed", 1.0),  # rwkv6-1.6b r
    (8, 256, 1024, 1024, 32, 8, "mixed", 1.0),  # seamless-m4t decoder q
    (2, 512, 1024, 1024, 32, 8, "mixed", 1.0),  # the same at its static prefill
]


def _tiled_inputs(B, S, d_in, d_out, r, N, ids, dev, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d_in), np.float32)
    w = rng.standard_normal((d_in, d_out), np.float32) * d_in ** -0.5
    a = rng.standard_normal((N, d_in, r), np.float32) * d_in ** -0.5
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.1
    if ids == "none":
        idv = np.full((B,), -1, np.int32)
    else:
        idv = rng.integers(-1, N, size=(B,)).astype(np.int32)
        idv[0] = -1
        if ids == "repeat":
            idv[0] = N - 1
            idv[min(2, B - 1)] = N - 1
    return [_t(v, dev, dtype) for v in (x, w, a, b, idv)]


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale", _TILED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_sgmv_cuda_tiled_path(cuda, dtype, B, S, d_in, d_out, r, N, ids, scale):
    x, w, a, b, idv = _tiled_inputs(B, S, d_in, d_out, r, N, ids, cuda, seed=6, dtype=dtype)
    for ww in (w, torch.zeros_like(w)):
        before = ops.launch_counts()["fused_sgmv"]
        got = fused_sgmv(x, ww, a, b, idv, scale=scale)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_sgmv"] == before + 1
        want, want32 = _plain(ref.fused_sgmv_ref, x, ww, a, b, idv, scale)
        assert _match(got, want, 1e-4 * float(want.abs().max()), dtype, want32)
        # one owner per output element, sums in a fixed order
        assert torch.equal(fused_sgmv(x, ww, a, b, idv, scale=scale), got)
    dead = idv < 0  # with W zeroed, a row of id -1 is exactly 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale", _TILED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sgmv_cuda_tiled_path(cuda, dtype, B, S, d_in, d_out, r, N, ids, scale):
    x, _, a, b, idv = _tiled_inputs(B, S, d_in, d_out, r, N, ids, cuda, seed=7, dtype=dtype)
    before = ops.launch_counts()["sgmv"]
    got = sgmv(x, a, b, idv, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sgmv"] == before + 1
    want, want32 = _plain(ref.sgmv_ref, x, a, b, idv, scale)
    assert _match(got, want, 1e-4 * float(want.abs().max()), dtype, want32)
    dead = idv < 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert torch.equal(sgmv(x, a, b, idv, scale=scale), got)


@pytest.mark.parametrize("B,T,H,Hkv,D,page", [
    (8, 2048, 16, 8, 128, 128),
    (5, 1040, 8, 2, 128, 16),  # 65 pages per row, split over many blocks
    (4, 96, 8, 2, 128, 32),
    (2, 64, 4, 4, 64, 16),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_cuda_matches_plain(cuda, dtype, B, T, H, Hkv, D, page):
    rng = np.random.default_rng(2)
    pages = T // page
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((B * pages, page, Hkv, D), np.float32)
    vp = rng.standard_normal((B * pages, page, Hkv, D), np.float32)
    tables = rng.permutation(B * pages).reshape(B, pages).astype(np.int32)
    lens = np.array([[0, 1, 129 % (T + 1), T][i % 4] for i in range(B)], np.int32)
    lens[-1] = T + 1  # an inactive row's start + 1 may point past the table
    args = [_t(a, cuda, dtype) for a in (q, kp, vp, tables, lens)]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    want, want32 = _plain(ref.paged_attention_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # length 0


# bf16 fused_sgmv on csrc/fused_sgmv_wgmma.cu (sgmv.bf16_path: M > 16, d_in
# and d_out multiples of 8, 16-byte bases): the tensor-core shrink, 128 x
# 256 tiles on wgmma with x, W and B[id] by TMA, the expand after x·W in
# the same accumulator, d_in split where the tiles do not fill the card.
# qwen3-0.6b's q, k and o at S = 2016 and 256; tiles straddling batch rows
# (S = 37, 2016); ranks 1, 12, 32, 128; deepseek's kv_a (d_out = 576, a
# part-filled tile); d_in = 4096 with all-positive inputs (the longest
# chain of k16 steps rounding toward zero); the engine's 8 x 32 extend
# (d_in split into 8 parts, summed in order). ids as in _TILED.
_WGMMA = [
    # B, S, d_in, d_out, r, N, ids, scale, positive
    (8, 2016, 1024, 2048, 32, 8, "mixed", 1.0, False),  # qwen3-0.6b q, fresh prefill
    (8, 2016, 1024, 1024, 32, 8, "repeat", 1.0, False),  # k
    (8, 2016, 2048, 1024, 32, 8, "mixed", 1.0, False),  # o
    (8, 256, 1024, 2048, 32, 8, "mixed", 2.0, False),   # q at the engine's bucket
    (8, 256, 1024, 1024, 32, 8, "repeat", 1.0, False),  # k: d_in in 2 parts
    (8, 32, 1024, 2048, 32, 8, "mixed", 1.0, False),    # the 8 x 32 extend: 8 parts
    (4, 37, 256, 320, 16, 3, "mixed", 0.5, False),      # tiles straddle 4 batch rows
    (4, 37, 256, 320, 16, 3, "repeat", 2.0, False),
    (2, 100, 256, 256, 1, 3, "mixed", 0.25, False),     # ranks 1, 12, 32, 128
    (2, 100, 256, 256, 12, 3, "repeat", 0.25, False),
    (2, 100, 256, 256, 32, 3, "mixed", 0.25, False),
    (2, 100, 256, 256, 128, 3, "mixed", 0.25, False),
    (2, 256, 2048, 576, 32, 8, "mixed", 1.0, False),    # deepseek kv_a
    (2, 64, 4096, 512, 32, 4, "repeat", 1.0, True),     # d_in = 4096, all positive
    (3, 50, 128, 256, 32, 2, "none", 2.0, False),       # every id -1
]


def _wgmma_inputs(B, S, d_in, d_out, r, N, ids, positive, dev):
    x, w, a, b, idv = _tiled_inputs(B, S, d_in, d_out, r, N, ids, dev, seed=9,
                                    dtype=torch.bfloat16)
    if positive:
        x, w, a, b = (t.abs() for t in (x, w, a, b))
    return x, w, a, b, idv


def _sgmv_path(x, w, a, b):
    B, S, d_in = x.shape
    return sgmv_mod.bf16_path(B * S, d_in, w.shape[1],
                              (x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr()),
                              x.dtype)


@pytest.mark.parametrize("B,S,d_in,d_out,r,want", [
    # want: (shrink parts, kper, base parts, kper) on an H100's 132 SMs
    (8, 2016, 1024, 2048, 32, (1, 16, 1, 16)),  # qwen3-0.6b q: 1008 tiles
    (8, 2016, 2048, 1024, 32, (1, 32, 1, 32)),  # o
    (8, 256, 1024, 2048, 32, (2, 8, 1, 16)),    # 128 tiles: one wave
    (8, 256, 1024, 1024, 32, (2, 8, 1, 16)),    # 64 tiles: half the card
    (8, 32, 1024, 2048, 32, (2, 8, 4, 4)),      # the extend: 16 tiles
    (2, 256, 2048, 576, 32, (4, 8, 5, 7)),      # deepseek kv_a: 12 tiles
    (2, 512, 4096, 4096, 32, (8, 8, 1, 64)),    # llama-7b: 128 tiles
    (4, 37, 256, 320, 16, (1, 4, 2, 2)),        # 4 k stages in parts of 2
    (2, 100, 128, 256, 128, (1, 2, 1, 2)),      # 2 k stages: one part
    (3, 40, 128, 256, 12, (1, 2, 1, 2)),        # r % 8 != 0: at most 2 stages a part
])
def test_fused_sgmv_cuda_wgmma_plan(cuda, B, S, d_in, d_out, r, want):
    """fused_sgmv_wgmma.cu's make_plan, as sgmv.wgmma_plan reads it: parts
    cover d_in's k stages of 64 with none empty; the scratch holds h (ranks
    padded to 32), the shrink's partials where it is split and the partial
    tiles where the tile loop is; one counter a shrink block of a part."""
    lib = build.load(sgmv_mod._WGMMA_SOURCE, sgmv_mod._WGMMA_SIGNATURES)
    plan = sgmv_mod.wgmma_plan(lib, B, S, d_in, d_out, r, 132)
    sp, skper, bp, bkper = (plan[k] for k in sgmv_mod.WGMMA_PLAN_KEYS[:4])
    assert (sp, skper, bp, bkper) == want
    KT = -(-d_in // 64)
    for parts, kper in ((sp, skper), (bp, bkper)):
        assert 1 <= parts <= 8 and (parts - 1) * kper < KT <= parts * kper
    M, rs = B * S, -(-r // 32) * 32
    assert plan["scratch_floats"] == (M * rs + (sp * M * rs if sp > 1 else 0)
                                      + (bp * M * d_out if bp > 1 else 0))
    assert plan["counters"] == (B * -(-S // 64) * rs // 32 if sp > 1 else 0)


@pytest.mark.parametrize("short", ["scratch", "counters"])
def test_fused_sgmv_cuda_wgmma_refuses_short_buffers(cuda, short):
    """The C entry sizes the plan itself and refuses a scratch or a counter
    buffer shorter than it needs (cudaErrorInvalidValue), writing nothing."""
    B, S, d_in, d_out, r = 8, 32, 1024, 2048, 32  # the extend: both buffers in use
    x, w, a, b, idv = _wgmma_inputs(B, S, d_in, d_out, r, 8, "mixed", False, cuda)
    lib = build.load(sgmv_mod._WGMMA_SOURCE, sgmv_mod._WGMMA_SIGNATURES)
    sms = build.sm_count(cuda)
    plan = sgmv_mod.wgmma_plan(lib, B, S, d_in, d_out, r, sms)
    assert plan["counters"] > 0 and plan["scratch_floats"] > 0
    floats = plan["scratch_floats"] - (short == "scratch")
    n_count = plan["counters"] - (short == "counters")
    scratch = torch.zeros((plan["scratch_floats"],), device=cuda)
    counters = torch.zeros((plan["counters"],), device=cuda, dtype=torch.int32)
    y = torch.zeros((B, S, d_out), device=cuda, dtype=torch.bfloat16)
    code = lib.fused_sgmv_bf16_wgmma_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), idv.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), floats, counters.data_ptr(), n_count, B * S, S, d_in, d_out, r,
        a.shape[0], sms, 1.0, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert code == 1  # cudaErrorInvalidValue
    assert not y.any() and not counters.any()


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale,positive", _WGMMA)
def test_fused_sgmv_cuda_wgmma_path(cuda, B, S, d_in, d_out, r, N, ids, scale, positive):
    """On the wgmma loop (counted), within the bf16 bar of the plain bf16
    and f32 versions, repeat launches bitwise equal, and every row of id -1
    bitwise equal to the same launch with every id -1: bf16(x·W) as the
    loop sums it, no delta."""
    x, w, a, b, idv = _wgmma_inputs(B, S, d_in, d_out, r, N, ids, positive, cuda)
    assert _sgmv_path(x, w, a, b) == "wgmma"
    paths = ops.path_launch_counts()["fused_sgmv"]
    got = fused_sgmv(x, w, a, b, idv, scale=scale)
    torch.cuda.synchronize()
    assert _one_path_launch("fused_sgmv", paths, "wgmma")
    want, want32 = _plain(ref.fused_sgmv_ref, x, w, a, b, idv, scale)
    assert _match(got, want, 1e-4 * float(want.abs().max()), torch.bfloat16, want32)
    assert torch.equal(fused_sgmv(x, w, a, b, idv, scale=scale), got)
    base = fused_sgmv(x, w, a, b, torch.full_like(idv, -1), scale=scale)
    dead = idv < 0
    assert torch.equal(got[dead], base[dead])
    bwant, bwant32 = _plain(ref.fused_sgmv_ref, x, w, a, b, torch.full_like(idv, -1), scale)
    assert _match(base, bwant, 1e-4 * float(bwant.abs().max()), torch.bfloat16, bwant32)


@pytest.mark.parametrize("case", ["d_out % 8", "x on 8 bytes"])
def test_fused_sgmv_cuda_bf16_shapes_off_the_wgmma_loop(cuda, case):
    """bf16 launches the wgmma loop cannot read take fused_sgmv.cu's tiled
    mma.sync loop by the rule, counted as such: d_out = 324 (no multiple
    of 8) and x on an 8-byte offset (a contiguous view 4 elements into a
    buffer). Within the bf16 bar either way."""
    d_out = 324 if case == "d_out % 8" else 256
    x, w, a, b, idv = _wgmma_inputs(4, 37, 256, d_out, 16, 3, "mixed", False, cuda)
    if case == "x on 8 bytes":
        flat = torch.empty(x.numel() + 4, device=cuda, dtype=x.dtype)
        flat[4:] = x.reshape(-1)
        x = flat[4:].view(x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == 8
    assert _sgmv_path(x, w, a, b) == "mma"
    paths = ops.path_launch_counts()["fused_sgmv"]
    got = fused_sgmv(x, w, a, b, idv, scale=0.5)
    torch.cuda.synchronize()
    assert _one_path_launch("fused_sgmv", paths, "mma")
    want, want32 = _plain(ref.fused_sgmv_ref, x, w, a, b, idv, 0.5)
    assert _match(got, want, 1e-4 * float(want.abs().max()), torch.bfloat16, want32)


def test_fused_sgmv_cuda_decode_takes_the_skinny_loop(cuda):
    """M <= 16 rows (a decode step) take the skinny loop in f32, and in bf16
    off the cluster loop's shapes (x on an 8-byte offset); llama-7b's q at
    2 rows takes the cluster loop, qwen3-0.6b's q at 8 rows the loop
    sgmv.bf16_path gives it. Counted as such, within the bar."""
    qwen3_q = sgmv_mod.bf16_path(8, 1024, 2048, (0, 0, 0, 0), torch.bfloat16)
    for dtype, B, d_in, d_out, shift, path in (
            (torch.float32, 8, 1024, 2048, 0, "skinny"), (torch.bfloat16, 8, 4096, 4096, 4, "skinny"),
            (torch.bfloat16, 8, 1024, 2048, 0, qwen3_q), (torch.bfloat16, 2, 4096, 4096, 0, "cluster")):
        x, w, a, b, idv = _tiled_inputs(B, 1, d_in, d_out, 32, 8, "mixed", cuda, seed=3,
                                        dtype=dtype)
        if shift:
            flat = torch.empty(x.numel() + shift, device=cuda, dtype=x.dtype)
            flat[shift:] = x.reshape(-1)
            x = flat[shift:].view(x.shape)
        assert _sgmv_path(x, w, a, b) == path
        paths = ops.path_launch_counts()["fused_sgmv"]
        got = fused_sgmv(x, w, a, b, idv)
        torch.cuda.synchronize()
        assert _one_path_launch("fused_sgmv", paths, path)
        want, want32 = _plain(ref.fused_sgmv_ref, x, w, a, b, idv, 1.0)
        assert _match(got, want, 1e-4 * float(want.abs().max()), dtype, want32)


# bf16 fused_sgmv at M <= 16 on csrc/fused_sgmv_cluster.cu (sgmv.bf16_path:
# d_in and d_out multiples of 8, 16-byte bases): one launch, split-K over
# thread-block clusters, the shrink in clusters of the same grid. M = 1, 2,
# 8, 16; S = 1, 4, 8; ranks 1, 12, 32, 128; d_out 576, 256, 136 (slabs
# part-filled); d_in 4096 (llama-7b) and 8 (one 8-row k step, cs = 1);
# repeated ids; every id -1; each config's decode projections.
_CLUSTER = [
    # B, S, d_in, d_out, r, N, ids, scale
    (1, 1, 1024, 2048, 32, 4, "mixed", 1.0),    # M = 1
    (8, 1, 1024, 2048, 32, 8, "mixed", 1.0),    # qwen3-0.6b q, k, o
    (8, 1, 1024, 1024, 32, 8, "repeat", 0.5),
    (8, 1, 2048, 1024, 32, 8, "mixed", 2.0),
    (16, 1, 1024, 2048, 32, 8, "mixed", 1.0),   # M = 16
    (16, 1, 2048, 576, 64, 5, "repeat", 1.0),
    (2, 1, 2048, 576, 32, 8, "mixed", 1.0),     # deepseek kv_a, q, o
    (2, 1, 2048, 3072, 32, 8, "repeat", 1.0),
    (2, 1, 4096, 4096, 32, 8, "mixed", 1.0),    # llama-7b q
    (2, 1, 2560, 2560, 32, 8, "mixed", 1.0),    # recurrentgemma-2b q, k
    (2, 1, 2560, 256, 32, 8, "repeat", 1.0),
    (2, 1, 2048, 2048, 32, 8, "mixed", 1.0),    # rwkv6-1.6b r
    (2, 1, 1024, 1024, 32, 8, "mixed", 1.0),    # seamless-m4t decoder q
    (8, 1, 1024, 2048, 1, 8, "mixed", 1.0),     # ranks 1, 12, 128
    (8, 1, 1024, 2048, 12, 8, "repeat", 1.0),
    (8, 1, 1024, 2048, 128, 8, "mixed", 1.0),
    (16, 1, 512, 136, 128, 3, "repeat", 1.5),   # rank 128 at 16 rows, an 8-column slab
    (2, 8, 512, 256, 16, 2, "repeat", 1.0),     # S = 8, 16 rows, one id
    (4, 4, 256, 64, 8, 3, "mixed", 1.0),        # S = 4
    (4, 1, 256, 320, 32, 3, "none", 2.0),       # every id -1
    (3, 1, 8, 4096, 4, 3, "mixed", 1.0),        # d_in = 8: one block a cluster
    (1, 16, 256, 256, 32, 2, "repeat", 1.0),    # 16 rows of one id, more than a rank's slots
    (2, 4, 256, 128, 128, 3, "repeat", 0.5),    # rank 128: 8 rows of one id on 2 slots
]


def _cluster_lib():
    return build.load(sgmv_mod._CLUSTER_SOURCE, sgmv_mod._CLUSTER_SIGNATURES)


def _cluster_launch(x, w, a, b, idv, scale):
    """csrc/fused_sgmv_cluster.cu's loop through its C entry, at any shape it
    takes (the path rule sends it the large ones only)."""
    dev = x.device
    B, S, d_in = x.shape
    d_out, r = w.shape[1], a.shape[2]
    y = torch.empty((B, S, d_out), device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    h = sgmv_mod.cluster_h(dev, stream, B * S, r)
    code = _cluster_lib().fused_sgmv_cluster_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), idv.data_ptr(), y.data_ptr(),
        h.data_ptr(), h.numel(), B * S, S, d_in, d_out, r, build.sm_count(dev), scale, stream)
    assert code == 0
    return y


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale", _CLUSTER)
def test_fused_sgmv_cuda_cluster_path(cuda, B, S, d_in, d_out, r, N, ids, scale):
    """The cluster loop (through its C entry) within the bf16 bar of the
    plain bf16 and f32 versions (W zeroed too), repeat launches bitwise
    equal, every row of id -1 bitwise equal to the same launch with every
    id -1 (x·W as the loop sums it, no delta)."""
    x, w, a, b, idv = _wgmma_inputs(B, S, d_in, d_out, r, N, ids, False, cuda)
    for ww in (w, torch.zeros_like(w)):
        got = _cluster_launch(x, ww, a, b, idv, scale)
        torch.cuda.synchronize()
        want, want32 = _plain(ref.fused_sgmv_ref, x, ww, a, b, idv, scale)
        assert _match(got, want, 1e-4 * float(want.abs().max()), torch.bfloat16, want32)
        assert torch.equal(_cluster_launch(x, ww, a, b, idv, scale), got)
    got = _cluster_launch(x, w, a, b, idv, scale)
    base = _cluster_launch(x, w, a, b, torch.full_like(idv, -1), scale)
    dead = idv < 0
    assert torch.equal(got[dead], base[dead])


@pytest.mark.parametrize("B,S,d_in,d_out", [
    (2, 1, 4096, 4096), (2, 1, 2048, 2048), (2, 1, 2048, 3072), (16, 1, 1024, 2048),
    (2, 1, 2560, 2560),
])
def test_fused_sgmv_cuda_cluster_rule_shapes(cuda, B, S, d_in, d_out):
    """The decode shapes the rule sends to the cluster loop (llama-7b's,
    rwkv6-1.6b's, deepseek's and recurrentgemma-2b's projections at 2 rows,
    qwen3-0.6b's q at 16) take it through fused_sgmv, counted, equal to the
    C entry's launch bit for bit."""
    x, w, a, b, idv = _wgmma_inputs(B, S, d_in, d_out, 32, 8, "mixed", False, cuda)
    assert _sgmv_path(x, w, a, b) == "cluster"
    paths = ops.path_launch_counts()["fused_sgmv"]
    got = fused_sgmv(x, w, a, b, idv)
    torch.cuda.synchronize()
    assert _one_path_launch("fused_sgmv", paths, "cluster")
    assert torch.equal(got, _cluster_launch(x, w, a, b, idv, 1.0))


def test_fused_sgmv_cuda_cluster_graph_replays(cuda):
    """A cluster launch captured in a CUDA graph (no host sync in it; its
    scratch of h its own, zeroed in the graph) gives, at each replay on new
    x and A written in place, the eager launch's bits: each replay knows its
    own parts of h."""
    B, d_in, d_out = 16, 1024, 2048
    x, w, a, b, idv = _wgmma_inputs(B, 1, d_in, d_out, 32, 8, "mixed", False, cuda)
    assert _sgmv_path(x, w, a, b) == "cluster"
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # a warm-up on the capture stream
        fused_sgmv(x, w, a, b, idv)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fused_sgmv(x, w, a, b, idv)
    gen = torch.Generator(device=cuda).manual_seed(11)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
        a.copy_(torch.randn(a.shape, generator=gen, device=cuda) * d_in ** -0.5)
        graph.replay()
        torch.cuda.synchronize()
        want = fused_sgmv(x, w, a, b, idv)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_fused_sgmv_cuda_cluster_graph_replays_beside_eager_launches(cuda):
    """A graph captured on one stream and replayed on a second while eager
    cluster launches run on the capture stream: the captured launch has a
    scratch of h of its own, so neither overwrites the other's parts (whose
    readers would wait until the kernel traps), and each gives its eager
    bits. Both grids fit on the card at once (6 clusters of 16 each)."""
    B, d_in, d_out = 2, 8192, 512
    x, w, a, b, idv = _wgmma_inputs(B, 1, d_in, d_out, 32, 8, "mixed", False, cuda)
    x2 = x.flip(0).contiguous()
    assert _sgmv_path(x, w, a, b) == "cluster"
    want, want2 = fused_sgmv(x, w, a, b, idv), fused_sgmv(x2, w, a, b, idv)
    cap, other = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    cap.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(cap):  # the capture stream's scratch, made before the capture
        fused_sgmv(x2, w, a, b, idv)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        out = fused_sgmv(x, w, a, b, idv)
    torch.cuda.synchronize()
    eager, replays = [], []
    for _ in range(32):
        with torch.cuda.stream(other):
            graph.replay()
            replays.append(out.clone())
        with torch.cuda.stream(cap):
            eager.append(fused_sgmv(x2, w, a, b, idv))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in replays)
    assert all(torch.equal(e, want2) for e in eager)


@pytest.mark.parametrize("M,S,d_in,d_out", [
    (8, 1, 1024, 2048), (8, 1, 1024, 1024), (8, 1, 2048, 1024), (2, 1, 4096, 4096),
    (2, 1, 2048, 576), (2, 1, 2560, 256), (2, 1, 2560, 2560), (16, 1, 1024, 2048),
    (16, 16, 8, 4096), (1, 1, 64, 8),
])
def test_fused_sgmv_cuda_cluster_plan(cuda, M, S, d_in, d_out):
    """The source's make_plan, as fused_sgmv_cluster_plan returns it, is
    sgmv.cluster_plan's on the card's SMs and its cluster capacities
    (cudaOccupancyMaxActiveClusters): the grid co-resident."""
    import ctypes

    lib = _cluster_lib()
    sms = build.sm_count(cuda)
    caps = {cs: lib.fused_sgmv_cluster_capacity(cs) for cs in (1, 2, 4, 8, 16)}
    assert all(n > 0 for n in caps.values()), caps
    out = (ctypes.c_int64 * 4)()
    assert lib.fused_sgmv_cluster_plan(M, S, d_in, d_out, sms, ctypes.addressof(out)) == 0
    cols, nb, cs, cap = out
    want = sgmv_mod.cluster_plan(M, S, d_in, d_out, sms, caps.__getitem__)
    assert (cols, nb, cs) == (want["cols"], want["nb"], want["cs"]) and cap == caps[cs]
    assert cols + nb <= cap


@pytest.mark.parametrize("bad", ["h short", "h on 8 bytes", "y on 8 bytes", "17 rows",
                                 "d_out % 8", "M % S"])
def test_fused_sgmv_cuda_cluster_refuses(cuda, bad):
    """The C entry refuses what the loop does not take
    (cudaErrorInvalidValue) and writes nothing."""
    M, d_in, d_out, r = 8, 1024, 1024, 32
    x, w, a, b, idv = _wgmma_inputs(M, 1, d_in, d_out, r, 8, "mixed", False, cuda)
    h = torch.zeros((M * r + 2,), device=cuda, dtype=torch.int64)
    y = torch.zeros((M * d_out + 8,), device=cuda, dtype=torch.bfloat16)
    args = dict(h=h.data_ptr(), h_words=M * r, y=y.data_ptr(), M=M, S=1, d_out=d_out)
    if bad == "h short":
        args["h_words"] -= 1
    elif bad == "h on 8 bytes":
        args["h"] += 8
    elif bad == "y on 8 bytes":
        args["y"] += 8
    elif bad == "17 rows":
        args["M"] = 17
    elif bad == "d_out % 8":
        args["d_out"] = d_out - 4
    else:
        args["S"] = 3
    code = _cluster_lib().fused_sgmv_cluster_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), idv.data_ptr(), args["y"],
        args["h"], args["h_words"], args["M"], args["S"], d_in, args["d_out"], r,
        build.sm_count(cuda), 1.0, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert code == 1  # cudaErrorInvalidValue
    assert not y.any() and not h.any()


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale", [
    (8, 1, 1024, 2048, 32, 8, "mixed", 1.0), (16, 1, 2048, 576, 64, 5, "repeat", 1.0),
    (2, 8, 512, 256, 16, 2, "repeat", 1.0),
])
def test_fused_sgmv_cuda_bf16_skinny_loop_at_the_cluster_shapes(cuda, B, S, d_in, d_out, r, N,
                                                                ids, scale):
    """fused_sgmv.cu's bf16 skinny loop, which the rule now gives only the
    bf16 shapes off the cluster loop, still right at the shapes the cluster
    loop took from it: called through its C entry."""
    x, w, a, b, idv = _wgmma_inputs(B, S, d_in, d_out, r, N, ids, False, cuda)
    lib = build.load(sgmv_mod._SOURCE, sgmv_mod._SIGNATURES)
    M = B * S
    scratch = torch.empty((lib.fused_sgmv_scratch_floats(M, d_in, d_out, r, 1),), device=cuda)
    y = torch.empty((B, S, d_out), device=cuda, dtype=torch.bfloat16)
    code = lib.fused_sgmv_bf16_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), idv.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), M, S, d_in, d_out, r, scale,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    want, want32 = _plain(ref.fused_sgmv_ref, x, w, a, b, idv, scale)
    assert _match(y, want, 1e-4 * float(want.abs().max()), torch.bfloat16, want32)


# The skinny path of fused_sgmv.cu (M <= 16): d_in split over blocks with
# the shrink in the same grid, then a merge pass. d_in off the 32-row ring
# stage (100, 2048 + 4), d_out that part-fills a 64-column slab, ranks 4
# and 64, M = 1, 8, 16; ids as in _TILED, plus "one" (every row on one
# adapter).
_SKINNY = [
    # B, S, d_in, d_out, r, N, ids, scale
    (1, 1, 1024, 2048, 32, 4, "mixed", 1.0),    # M = 1
    (8, 1, 1024, 2048, 32, 8, "mixed", 1.0),    # the decode projections
    (8, 1, 1024, 1024, 32, 8, "repeat", 0.5),
    (8, 1, 2048, 1024, 32, 8, "mixed", 2.0),
    (8, 1, 100, 68, 4, 3, "mixed", 1.5),        # r = 4, d_in % 32 != 0
    (8, 1, 2052, 132, 64, 3, "mixed", 0.5),     # r = 64, 2048 + 4 rows
    (16, 1, 2052, 1028, 64, 5, "repeat", 1.0),  # M = 16
    (16, 1, 100, 260, 4, 3, "none", 2.0),       # every id -1
    (8, 1, 1024, 2048, 32, 8, "one", 1.0),      # every row on one adapter
    (2, 8, 512, 196, 16, 2, "one", 1.0),        # S = 8, 16 rows
    (4, 4, 256, 64, 8, 3, "mixed", 1.0),
    (8, 1, 2560, 2560, 32, 8, "mixed", 1.0),    # recurrentgemma-2b q, decode
    (8, 1, 2560, 256, 32, 8, "repeat", 1.0),    # recurrentgemma-2b k
    (8, 1, 2048, 2048, 32, 8, "mixed", 1.0),    # rwkv6-1.6b r
    (8, 1, 1024, 1024, 32, 8, "mixed", 1.0),    # seamless-m4t decoder q
    (2, 1, 1024, 1024, 32, 8, "mixed", 1.0),    # the same at its static decode
    (8, 1, 1024, 2048, 1, 8, "mixed", 1.0),     # r = 1, 12 and 128 at decode
    (8, 1, 1024, 2048, 12, 8, "repeat", 1.0),
    (8, 1, 1024, 2048, 128, 8, "mixed", 1.0),
    (16, 1, 100, 260, 12, 3, "one", 2.0),       # r = 12, M = 16
    (8, 1, 4096, 4096, 32, 8, "mixed", 1.0),    # llama-7b's q projection
]


def _capacity(r):
    """The compiled rank (4, 8, .., 128) a rank r runs on."""
    return max(4, 1 << (r - 1).bit_length())


def _skinny_ids(idv, ids, N):
    if ids == "one":
        idv[:] = N - 1
    return idv


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale", _SKINNY)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_sgmv_cuda_skinny_path(cuda, dtype, B, S, d_in, d_out, r, N, ids, scale):
    from repro_torch.kernels import build
    from repro_torch.kernels.sgmv import _SIGNATURES, skinny_plan

    x, w, a, b, idv = _tiled_inputs(B, S, d_in, d_out, r, N,
                                    "mixed" if ids == "one" else ids, cuda, seed=9,
                                    dtype=dtype)
    idv = _skinny_ids(idv, ids, N)
    for ww in (w, torch.zeros_like(w)):
        before = ops.launch_counts()["fused_sgmv"]
        got = fused_sgmv(x, ww, a, b, idv, scale=scale)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_sgmv"] == before + 1
        want, want32 = _plain(ref.fused_sgmv_ref, x, ww, a, b, idv, scale)
        assert _match(got, want, 1e-4 * float(want.abs().max()), dtype, want32)
        # one writer per partial, sums in a fixed order
        assert torch.equal(fused_sgmv(x, ww, a, b, idv, scale=scale), got)
    dead = idv < 0  # with W zeroed, a row of id -1 is exactly 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    # the Python mirror of the launch plan sizes the scratch as the source does
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, _ = skinny_plan(B * S, d_in, d_out, True, sms)
    lib = build.load("fused_sgmv", _SIGNATURES)
    R = _capacity(r)  # the compiled rank r runs on
    assert lib.fused_sgmv_scratch_floats(B * S, d_in, d_out, r, 1) == splits * B * S * (R + d_out)


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale", _SKINNY)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sgmv_cuda_skinny_path(cuda, dtype, B, S, d_in, d_out, r, N, ids, scale):
    from repro_torch.kernels import build
    from repro_torch.kernels.sgmv import _SIGNATURES, skinny_plan

    x, _, a, b, idv = _tiled_inputs(B, S, d_in, d_out, r, N,
                                    "mixed" if ids == "one" else ids, cuda, seed=10,
                                    dtype=dtype)
    idv = _skinny_ids(idv, ids, N)
    before = ops.launch_counts()["sgmv"]
    got = sgmv(x, a, b, idv, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sgmv"] == before + 1
    want, want32 = _plain(ref.sgmv_ref, x, a, b, idv, scale)
    assert _match(got, want, 1e-4 * max(float(want.abs().max()), 1e-30), dtype, want32)
    dead = idv < 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert torch.equal(sgmv(x, a, b, idv, scale=scale), got)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, _ = skinny_plan(B * S, d_in, d_out, False, sms)
    lib = build.load("fused_sgmv", _SIGNATURES)
    assert lib.fused_sgmv_scratch_floats(B * S, d_in, d_out, r, 0) == splits * B * S * _capacity(r)


# paged_attention.cu's chunks of 64 tokens: group sizes 1..8, D 64 and 128,
# pages of 8, 16 and 128 tokens, lengths 0, 1, a page boundary ± 1, T and
# T + 1 (past the table: clamped), permuted tables, and one row of 64 pages
# of 128 (T = 8192).
_PAGED = [
    # B, T, H, Hkv, D, page
    (8, 2048, 16, 8, 128, 128),  # the main path's shape, G = 2
    (6, 1024, 8, 8, 128, 16),    # G = 1
    (6, 512, 16, 4, 64, 8),      # G = 4, D = 64, 8-token pages
    (6, 768, 16, 2, 128, 128),   # G = 8
    (6, 256, 8, 1, 64, 16),      # G = 8, D = 64
    (3, 8192, 16, 8, 128, 128),  # 64 pages a row
    (6, 640, 28, 4, 128, 128),   # qwen2-vl-7b: G = 7, heads in blocks of 8
    (6, 640, 8, 1, 256, 128),    # gemma-2b: D = 256, 32-token chunks, G = 8
    (6, 640, 32, 8, 160, 128),   # stablelm-12b: D = 160, G = 4
    (6, 640, 32, 32, 128, 128),  # llama-7b: G = 1
    (4, 256, 24, 8, 20, 16),     # G = 3, D = 20
    (3, 512, 16, 16, 256, 8),    # G = 1, D = 256
    (2, 128, 128, 1, 256, 16),   # G = 128 at D = 256: the largest block
    (3, 192, 96, 1, 64, 32),     # G = 96: 1536 outputs, more than the threads
    (6, 520, 16, 16, 64, 8),     # seamless-m4t's static decode: G = 1, D = 64
]


@pytest.mark.parametrize("B,T,H,Hkv,D,page", _PAGED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_cuda_chunks(cuda, dtype, B, T, H, Hkv, D, page):
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import _SIGNATURES, chunk_plan, chunk_tokens

    rng = np.random.default_rng(11)
    pages = T // page
    P = B * pages + 5
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    tables = rng.permutation(P)[: B * pages].reshape(B, pages).astype(np.int32)
    lens = [0, 1, page - 1, page + 1, T, T + 1][:B]
    lens += [T] * (B - len(lens))
    if B == 3:
        lens = [T, 2 * page, T + 1]
    args = [_t(v, cuda, dtype) for v in (q, kp, vp, tables, np.asarray(lens, np.int32))]
    before = ops.launch_counts()["paged_attention"]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before + 1
    want, want32 = _plain(ref.paged_attention_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    for bb, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[bb], torch.zeros_like(got[bb]))
    assert torch.equal(paged_attention(*args), got)  # a fixed merge order
    lib = build.load("paged_attention", _SIGNATURES)
    nc = chunk_plan(page, pages, D)
    assert nc == -(-T // chunk_tokens(D))
    assert lib.paged_attention_scratch_floats(B, H, Hkv, D, page, pages) == B * H * nc * (D + 2)


@pytest.mark.parametrize("B,S,d_in,d_out,r,N", [
    (8, 1, 1024, 2048, 32, 8),   # decode rows: the skinny path
    (8, 1, 2048, 1024, 32, 8),
    (3, 5, 100, 328, 8, 2),      # skinny, a part-filled column block
    (4, 37, 96, 320, 16, 3),     # the tiled path
    (2, 256, 1024, 2048, 32, 8),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sgmv_cuda_matches_plain(cuda, dtype, B, S, d_in, d_out, r, N):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, d_in), np.float32)
    a = rng.standard_normal((N, d_in, r), np.float32) * 0.03
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.03
    ids = rng.integers(-1, N, size=(B,)).astype(np.int32)
    ids[0] = -1
    args = [_t(v, cuda, dtype) for v in (x, a, b, ids)]
    before = ops.launch_counts()["sgmv"]
    got = sgmv(*args, scale=2.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sgmv"] == before + 1
    want, want32 = _plain(ref.sgmv_ref, *args, scale=2.0)
    assert _match(got, want, 1e-4 * float(want.abs().max()), dtype, want32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # a negative id
    assert torch.equal(sgmv(*args, scale=2.0), got)  # a fixed order of sums


def _flash_path(dtype, D, q, k, v):
    """The tile loop a flash launch on these tensors takes: bf16 by
    ``flash_prefill.bf16_path``, f32 always attention_tc.cuh's."""
    if dtype == torch.float32:
        return "mma"
    return flash_prefill_mod.bf16_path(
        D, (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]),
        (q.data_ptr(), k.data_ptr(), v.data_ptr()))


def _one_path_launch(name, before, path):
    """Exactly one launch of ``name`` since ``before`` (path_launch_counts),
    on ``path``."""
    after = ops.path_launch_counts()[name]
    return {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in after}


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (8, 16, 8, 2016, 128),  # the generate path; S off the 16-token q tiles
    (2, 4, 2, 100, 128),
    (3, 8, 1, 33, 64),      # MQA
    (1, 4, 4, 1, 32),       # MHA, one token
    (2, 8, 8, 2016, 128),   # G = 1 at the generate path's length
    (2, 4, 1, 300, 36),     # G = 4, a head dim padded to the k8 step
    (2, 32, 8, 2048, 160),  # stablelm-12b: a wide head, G = 4
    (2, 8, 1, 2048, 256),   # gemma-2b: D = 256, MQA (G = 8)
    (2, 28, 4, 300, 128),   # qwen2-vl-7b: G = 7
    (2, 6, 2, 77, 20),      # G = 3, D = 20
    (1, 14, 2, 130, 256),   # G = 7 at D = 256
    (2, 4, 4, 65, 160),     # G = 1 at D = 160
    (2, 16, 16, 512, 64),   # seamless-m4t's decoder at its static prefill
    (2, 16, 16, 256, 64),   # the same at its identities' forward
    (2, 14, 2, 300, 64),    # G = 7 at D = 64 (bf16: the wgmma loop)
    (1, 7, 1, 129, 128),    # G = 7 at D = 128, MQA
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_cuda_matches_plain(cuda, dtype, B, H, Hkv, S, D):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, H, S, D), np.float32)
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    args = [_t(a, cuda, dtype) for a in (q, k, v)]
    path = _flash_path(dtype, D, *args)
    # bf16: every head dim that is a multiple of 16 takes the wgmma loop
    assert path == ("wgmma" if dtype == torch.bfloat16 and D % 16 == 0 else "mma")
    before = ops.launch_counts()["flash_prefill"]
    paths = ops.path_launch_counts()["flash_prefill"]
    got = flash_prefill(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_prefill"] == before + 1
    assert _one_path_launch("flash_prefill", paths, path)
    want, want32 = _plain(ref.flash_prefill_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    # (B, S, H, D) tensors transposed to head-major are read in place
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in args)
    assert _flash_path(dtype, D, qt, kt, vt) == path
    got_t = flash_prefill(qt, kt, vt)
    assert got_t.stride() == qt.stride()
    assert torch.equal(got_t, got)


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (2, 16, 8, 300, 128),  # qwen3-0.6b's heads
    (1, 8, 1, 200, 256),   # gemma-2b's
])
def test_flash_prefill_bf16_strided_views_take_the_mma_loop(cuda, B, H, Hkv, S, D):
    """bf16 inputs the wgmma loop cannot read, q on an 8-byte base and k, v
    views whose token stride is 4 elements past a 16-byte step (rows of
    D + 4 in a wider tensor), go to attention_tc.cuh's loop by the rule,
    counted as such; dense copies take the wgmma loop; both within the bf16
    bar of the plain versions."""
    rng = np.random.default_rng(6)
    flat = _t(rng.standard_normal(B * H * S * D + 4, np.float32), cuda, torch.bfloat16)
    q = flat[4:].view(B, H, S, D)
    k, v = (_t(rng.standard_normal((B, Hkv, S, D + 4), np.float32), cuda,
               torch.bfloat16)[..., :D] for _ in "kv")
    assert _flash_path(torch.bfloat16, D, q, k, v) == "mma"
    paths = ops.path_launch_counts()["flash_prefill"]
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert _one_path_launch("flash_prefill", paths, "mma")
    want, want32 = _plain(ref.flash_prefill_ref, q, k, v)
    assert _match(got, want, 1e-5, torch.bfloat16, want32)
    dense = [t.clone(memory_format=torch.contiguous_format) for t in (q, k, v)]
    paths = ops.path_launch_counts()["flash_prefill"]
    got_w = flash_prefill(*dense)
    torch.cuda.synchronize()
    assert _one_path_launch("flash_prefill", paths, "wgmma")
    assert _match(got_w, want, 1e-5, torch.bfloat16, want32)


@pytest.mark.parametrize("S,lens,H,Hkv,D", [
    (2016, [0, 1, 37, 1000, 2015, 2016, 2016, 2016], 16, 8, 128),
    (100, [100, 0, 17], 16, 8, 128),
    (2048, [2048, 0, 1, 1000], 32, 8, 160),  # stablelm-12b
    (2048, [0, 2048, 513, 1], 8, 1, 256),    # gemma-2b
    (300, [300, 1, 0, 129], 28, 4, 128),     # G = 7
    (77, [77, 5, 0], 8, 8, 20),              # G = 1, D = 20
    (150, [0, 150, 71], 14, 2, 64),          # G = 7 at D = 64 (bf16: wgmma)
    (130, [130, 0, 1], 7, 1, 128),           # G = 7 at D = 128, MQA
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_ragged_cuda_matches_plain(cuda, dtype, S, lens, H, Hkv, D):
    B = len(lens)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, S, D), np.float32)
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    args = [_t(a, cuda, dtype) for a in (q, k, v, np.asarray(lens, np.int32))]
    path = _flash_path(dtype, D, *args[:3])
    assert path == ("wgmma" if dtype == torch.bfloat16 and D % 16 == 0 else "mma")
    before = ops.launch_counts()
    paths = ops.path_launch_counts()["flash_prefill_ragged"]
    got = flash_prefill_ragged(*args)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_prefill_ragged"] == before["flash_prefill_ragged"] + 1
    assert after["flash_prefill"] == before["flash_prefill"]
    assert _one_path_launch("flash_prefill_ragged", paths, path)
    want, want32 = _plain(ref.flash_prefill_ragged_ref, *args)
    assert _match(got, want, 1e-5, dtype, want32)
    for b, n in enumerate(lens):  # padded queries and empty rows are zeros
        assert torch.equal(got[b, :, n:], torch.zeros_like(got[b, :, n:]))
    full = [b for b, n in enumerate(lens) if n == S]
    assert torch.equal(got[full], flash_prefill(*args[:3])[full])


def _grad_cases(dev):
    """kernel -> (shape of its first float input x, a call on x)"""
    f = lambda *shape: torch.randn(shape, device=dev)  # noqa: E731
    ids = torch.zeros((2,), dtype=torch.int32, device=dev)
    kv = (2, 8, 1, 4)  # (B, T, Hkv, D), also one page of 8 per row
    return {
        "fused_sgmv": ((2, 3, 8), lambda x: fused_sgmv(
            x, f(8, 8), f(1, 8, 4), f(1, 4, 8), ids)),
        "sgmv": ((2, 3, 8), lambda x: sgmv(x, f(1, 8, 4), f(1, 4, 8), ids)),
        "ragged_extend": ((2, 3, 2, 4), lambda x: ragged_extend(
            x, f(*kv), f(*kv), ids, ids + 3)),
        "paged_attention": ((2, 2, 4), lambda x: paged_attention(
            x, f(*kv), f(*kv), torch.arange(2, device=dev).view(2, 1), ids + 5)),
        "flash_prefill": ((2, 2, 3, 4), lambda x: flash_prefill(
            x, f(2, 1, 3, 4), f(2, 1, 3, 4))),
        "flash_prefill_ragged": ((2, 2, 3, 4), lambda x: flash_prefill_ragged(
            x, f(2, 1, 3, 4), f(2, 1, 3, 4), ids + 2)),
    }


@pytest.mark.parametrize("name", sorted(build.SERVING_ONLY))
def test_cuda_launch_under_autograd_raises(cuda, name):
    """The serving-only kernels have no backward: an input that requires
    grad raises rather than come back as a tensor without a gradient.
    Under no_grad the same call launches."""
    shape, call = _grad_cases(cuda)[name]
    x = torch.randn(shape, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="serving-only kernel"):
        call(x)
    with torch.no_grad():
        before = ops.launch_counts()[name]
        assert torch.isfinite(call(x)).all()
        torch.cuda.synchronize()
        assert ops.launch_counts()[name] == before + 1


def _training_case(name, dev):
    """(inputs that require grad, kernel call, plain call) at a small shape
    with a row of id -1 and a repeated id (fused_sgmv) or G = 2 (flash)."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def f(*shape):
        return torch.randn(shape, generator=g).to(dev).requires_grad_(True)

    if name == "fused_sgmv":
        ids = torch.tensor([1, -1, 1], dtype=torch.int32, device=dev)
        xs = (f(3, 5, 24), f(24, 16), f(2, 24, 4), f(2, 4, 16))
        return (xs, lambda *t: fused_sgmv(*t, ids, scale=0.5),
                lambda *t: ref.fused_sgmv_ref(*t, ids, 0.5))
    xs = (f(2, 4, 9, 8), f(2, 2, 9, 8), f(2, 2, 9, 8))
    return xs, flash_prefill, ref.flash_prefill_ref


@pytest.mark.parametrize("name,backward", [("fused_sgmv", "lora_grad"),
                                           ("flash_prefill", "flash_prefill_bwd")])
def test_cuda_training_kernels_return_the_plain_gradients(cuda, name, backward):
    """fused_sgmv and flash_prefill are differentiable on the card: the
    gradients of every input equal those of autograd through the plain
    forward on the same tensors, within 1e-4 of their largest magnitude,
    and the backward launches its own kernel once."""
    xs, kernel, plain = _training_case(name, cuda)
    before = ops.launch_counts()
    y = kernel(*xs)
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, xs, dy)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after[name] == before[name] + 1
    assert after[backward] == before[backward] + 1
    want = torch.autograd.grad(plain(*xs), xs, dy)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_cuda_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((2, 3, 8), device=cuda, dtype=torch.float64)
    w = torch.zeros((8, 4), device=cuda)
    a = torch.zeros((1, 8, 4), device=cuda)
    b = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_sgmv(x, w, a, b, torch.zeros(2, dtype=torch.int64))


def test_cuda_wrappers_refuse_mixed_float_types(cuda):
    """Every float input of a launch has one type: a bf16 x with an f32 W
    (or f32 q with bf16 pages) raises ValueError before any launch."""
    before = ops.launch_counts()
    f = lambda dt, *shape: torch.zeros(shape, device=cuda, dtype=dt)  # noqa: E731
    bf, f32 = torch.bfloat16, torch.float32
    ids = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one type"):
        fused_sgmv(f(bf, 2, 3, 8), f(f32, 8, 8), f(bf, 1, 8, 4), f(bf, 1, 4, 8), ids)
    with pytest.raises(ValueError, match="one type"):
        sgmv(f(bf, 2, 3, 8), f(bf, 1, 8, 4), f(f32, 1, 4, 8), ids)
    with pytest.raises(ValueError, match="one type"):
        ragged_extend(f(f32, 2, 3, 2, 8), f(bf, 2, 8, 1, 8), f(bf, 2, 8, 1, 8), ids, ids + 3)
    with pytest.raises(ValueError, match="one type"):
        paged_attention(f(f32, 2, 2, 8), f(bf, 2, 8, 1, 8), f(bf, 2, 8, 1, 8),
                        torch.arange(2, device=cuda).view(2, 1), ids + 5)
    with pytest.raises(ValueError, match="one type"):
        flash_prefill(f(bf, 2, 2, 3, 8), f(bf, 2, 1, 3, 8), f(f32, 2, 1, 3, 8))
    with pytest.raises(ValueError, match="one type"):
        flash_prefill_ragged(f(bf, 2, 2, 3, 8), f(f32, 2, 1, 3, 8), f(bf, 2, 1, 3, 8), ids)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("name", ["fused_sgmv", "flash_prefill"])
def test_cuda_bf16_training_raises(cuda, name):
    """The backward kernels take f32 only: a bf16 input that requires grad
    on the card raises NotImplementedError naming bf16 training, before any
    launch; the same call under no_grad launches the bf16 kernel."""
    xs, kernel, _ = _training_case(name, cuda)
    xs = tuple(x.detach().to(torch.bfloat16).requires_grad_(True) for x in xs)
    before = ops.launch_counts()
    with pytest.raises(NotImplementedError, match="bf16 training is not ported"):
        kernel(*xs)
    assert ops.launch_counts() == before
    with torch.no_grad():
        y = kernel(*xs)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    assert ops.launch_counts()[name] == before[name] + 1


def test_cuda_wrappers_name_the_shape_limits(cuda):
    """Shapes the kernels do not take raise ValueError naming the limit,
    before any launch."""
    before = ops.launch_counts()
    f = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    ids = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rank 129 must be in 1..128"):
        fused_sgmv(f(2, 3, 8), f(8, 8), f(1, 8, 129), f(1, 129, 8), ids)
    with pytest.raises(ValueError, match="rank 0 must be in 1..128"):
        sgmv(f(2, 3, 8), f(1, 8, 0), f(1, 0, 8), ids)
    with pytest.raises(ValueError, match="head dim 264 must be a multiple of 4 up to 256"):
        ragged_extend(f(2, 3, 2, 264), f(2, 8, 1, 264), f(2, 8, 1, 264), ids, ids + 3)
    with pytest.raises(ValueError, match="head dim 18 must be a multiple of 4"):
        flash_prefill(f(2, 2, 3, 18), f(2, 1, 3, 18), f(2, 1, 3, 18))
    with pytest.raises(ValueError, match="head dim 18 must be a multiple of 4"):
        flash_prefill_ragged(f(2, 2, 3, 18), f(2, 1, 3, 18), f(2, 1, 3, 18), ids)
    with pytest.raises(ValueError, match="group size must be a whole number up to 128"):
        paged_attention(f(2, 129, 4), f(2, 8, 1, 4), f(2, 8, 1, 4),
                        torch.arange(2, device=cuda).view(2, 1), ids + 5)
    with pytest.raises(ValueError, match="head dim 260 must be a multiple of 4 up to 256"):
        paged_attention(f(2, 2, 260), f(2, 8, 1, 260), f(2, 8, 1, 260),
                        torch.arange(2, device=cuda).view(2, 1), ids + 5)
    assert ops.launch_counts() == before


GRAD_TOL = 1e-4  # times max|plain grad|


def _close(got, want):
    return float((got - want).abs().max()) <= GRAD_TOL * float(want.abs().max())


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (2, 16, 8, 130, 128),   # qwen3-0.6b's heads, a part-filled tile
    (2, 4, 4, 77, 64),      # G = 1
    (2, 6, 2, 70, 20),      # G = 3, D = 20
    (1, 8, 2, 100, 160),    # G = 4 at a wide head
    (1, 8, 1, 65, 256),     # gemma-2b: D = 256, MQA
    (1, 28, 4, 40, 128),    # G = 7
    (2, 4, 2, 1, 128),      # S = 1: one key, one query
    (1, 4, 2, 15, 64),      # S = 15: inside one q tile of either pass
    (1, 16, 8, 513, 128),   # S = 513: one key past the last 64-key tile
    (2, 4, 2, 33, 4),       # D = 4, padded to 32
    (1, 3, 3, 47, 20),      # D = 20 at G = 1
    (1, 14, 2, 90, 160),    # G = 7 at a wide head
    (8, 16, 8, 512, 128),   # qwen3-0.6b's training batch
])
def test_flash_prefill_bwd_cuda_matches_plain(cuda, B, H, Hkv, S, D):
    """The attention backward against the plain one from the same o and
    lse, read through (B, S, H, D) tensors transposed to head-major; a
    repeat launch gives the same bits. The forward's out is the same bits
    with and without its log-sum-exp, which matches the plain one. Every
    shape here folds dQ into the dK/dV blocks."""
    assert flash_prefill_mod.bwd_plan(B, S, H, Hkv, D, build.sm_count(cuda))[1]
    _check_flash_bwd(cuda, B, H, Hkv, S, D)


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (2, 16, 8, 130, 128),   # qwen3-0.6b's heads, a part-filled tile
    (2, 4, 2, 1, 128),      # S = 1
    (1, 16, 8, 513, 128),   # one query past the last 64-query tile
    (2, 4, 2, 33, 4),       # D = 4
    (1, 3, 3, 47, 20),      # D = 20 at G = 1
    (1, 14, 2, 90, 160),    # G = 7 at a wide head: K/V tiles of 32
    (1, 8, 1, 65, 256),     # D = 256, MQA: 32-query tiles, four key warps
])
def test_flash_prefill_bwd_separate_dq_cuda_matches_plain(cuda, monkeypatch, B, H, Hkv, S, D):
    """The separate dQ pass, which the plan takes where the dQ partials
    would pass their budget: with the budget at nothing, every shape takes
    it."""
    monkeypatch.setattr(flash_prefill_mod, "DQ_FOLD_FLOATS", -1)
    assert not flash_prefill_mod.bwd_plan(B, S, H, Hkv, D, build.sm_count(cuda))[1]
    _check_flash_bwd(cuda, B, H, Hkv, S, D)


def test_flash_prefill_bwd_long_sequence_cuda(cuda):
    """One 16384-token row of qwen3-0.6b's heads: the dQ partials would take
    4.3e9 floats, so the plan takes the separate dQ pass and the scratch
    stays Δ's. Held against SDPA's f32 backward (memory-efficient, K and V
    repeated over the group, their gradients summed back), as the plain
    version's S x S scores would not fit the card; a repeat launch gives
    the same bits."""
    B, H, Hkv, S, D = 1, 16, 8, 16384, 128
    assert flash_prefill_mod.bwd_plan(B, S, H, Hkv, D, build.sm_count(cuda)) == (1, False)
    F = torch.nn.functional
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn((B, S, h, D), generator=gen, device=cuda).transpose(1, 2)
                   for h in (H, Hkv, Hkv, H))
    out, lse = flash_prefill_fwd(q, k, v)
    got = flash_prefill_bwd(q, k, v, out, lse, do)
    again = flash_prefill_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    G = H // Hkv
    qe, ke, ve = (t.detach().clone().requires_grad_(True)
                  for t in (q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)))
    with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION):
        o_lib = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)
        dq, dk, dv = torch.autograd.grad(o_lib, (qe, ke, ve), do)
    want = (dq, dk.reshape(B, Hkv, G, S, D).sum(2), dv.reshape(B, Hkv, G, S, D).sum(2))
    for a, b in zip(got, want):
        assert _close(a, b)


def _check_flash_bwd(cuda, B, H, Hkv, S, D):
    rng = np.random.default_rng(6)
    q, k, v, do = (_t(rng.standard_normal(s, np.float32), cuda).transpose(1, 2)
                   for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))
    out, lse = flash_prefill_fwd(q, k, v)
    with torch.no_grad():
        assert torch.equal(out, flash_prefill(q, k, v))
    assert float((lse - ref.flash_prefill_lse_ref(q, k)).abs().max()) <= 1e-5
    before = ops.launch_counts()["flash_prefill_bwd"]
    got = flash_prefill_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_prefill_bwd"] == before + 1
    assert got[0].stride() == q.stride() and got[1].stride() == k.stride()
    want = ref.flash_prefill_bwd_ref(q, k, v, out, lse, do)
    if S == 1:
        # one key: P = 1 and dS = dP - Δ = 0, so dq and dk are 0 up to the
        # rounding of dO·V against Δ (the plain ones too); dv is dO
        assert _close(got[2], want[2])
        for a in got[:2]:
            assert float(a.abs().max()) <= GRAD_TOL * float(do.abs().max())
    else:
        for a, b in zip(got, want):
            assert _close(a, b)
    again = flash_prefill_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,S,d_in,d_out,r,N", [
    (4, 64, 1024, 2048, 32, 4),  # qwen3-0.6b's q projection
    (3, 37, 96, 320, 1, 2),      # rank 1, part-filled tiles
    (3, 20, 100, 72, 12, 3),     # rank 12, part-filled tiles
    (3, 20, 98, 72, 12, 3),      # d_in % 4 != 0: 4-byte copies
    (3, 40, 128, 96, 8, 3),      # rank 8: one n-tile
    (3, 70, 96, 200, 9, 3),      # rank 9: padded to 16
    (2, 65, 160, 130, 33, 2),    # rank 33, d_out % 4 != 0
    (2, 33, 64, 64, 128, 2),     # rank 128
    (3, 300, 200, 136, 16, 2),   # the sequence split into parts, summed in order
])
def test_lora_grad_cuda_matches_plain(cuda, B, S, d_in, d_out, r, N):
    """dA, dB and the delta of dx against the plain versions, with a row of
    id -1 and a repeated id; an adapter with no row gets zeros; without dx
    the kernel writes the same dA and dB; a repeat launch gives the same
    bits."""
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((B, S, d_in), np.float32), cuda)
    dy = _t(rng.standard_normal((B, S, d_out), np.float32), cuda)
    a = _t(rng.standard_normal((N, d_in, r), np.float32) * 0.05, cuda)
    b = _t(rng.standard_normal((N, r, d_out), np.float32) * 0.05, cuda)
    ids = _t(np.array(([-1, 0, 0, 1] * B)[:B], np.int32), cuda)
    base = _t(rng.standard_normal((B, S, d_in), np.float32), cuda)
    dx = base.clone()
    before = ops.launch_counts()["lora_grad"]
    da, db = lora_grad(x, dy, a, b, ids, 0.5, dx)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lora_grad"] == before + 1
    delta, da_want, db_want = ref.lora_grad_ref(x, dy, a, b, ids, 0.5)
    assert _close(da, da_want) and _close(db, db_want)
    assert _close(dx - base, delta)
    assert torch.equal(dx[0], base[0])  # id -1: no delta
    if N > 2:
        assert not da[2].any() and not db[2].any()  # no row of id 2
    da2, db2 = lora_grad(x, dy, a, b, ids, 0.5)
    assert torch.equal(da, da2) and torch.equal(db, db2)
    # the last block of each split shrink tile zeroes its counter again
    assert not any(c.any() for c in sgmv_mod._counters.values())


# The bf16 attention loops of their own design. paged_attention's split
# loop (paged_attention.bf16_path: G <= 16, G·D <= 512, D a multiple of 8): split_plan
# blocks a (row, kv head) as one cluster, TMA boxes of gcd(page, 64) tokens,
# the merge in distributed shared memory; pages of 8, 16, 24 and 128
# tokens, lengths 0, 1, page ± 1, T and past T, permuted tables, one row
# long enough to reload its block's table window. ragged_extend's wgmma loop
# (ragged_extend_wgmma.cu: D a multiple of 16): the engine's buckets with
# decode riders at long starts, the KV split and its combine, G 1 to 8, D
# 32 to 256. Each against its plain bf16 version and within one bf16
# rounding of the plain f32 version (``_match``), bitwise on repeat, rows of
# length 0 and padded queries exact zeros, on the loop its rule names.
_SPLIT = [
    # B, T, H, Hkv, D, page
    (8, 2048, 16, 8, 128, 128),   # qwen3-0.6b: G = 2
    (6, 1024, 8, 8, 128, 16),     # G = 1, 16-token pages
    (6, 512, 16, 4, 64, 8),       # G = 4, D = 64, 8-token pages
    (6, 640, 16, 4, 128, 128),    # G = 4, D = 128: G·D = 512
    (6, 640, 2, 1, 256, 128),     # D = 256, G = 2
    (6, 640, 24, 8, 160, 128),    # D = 160, G = 3 (padded to 4)
    (4, 384, 32, 2, 32, 24),      # G = 16, D = 32, 24-token pages (boxes of 8)
    (2, 20480, 2, 1, 64, 8),      # 2560 pages a row, 320 a block: the window reloads
]


@pytest.mark.parametrize("B,T,H,Hkv,D,page", _SPLIT)
def test_paged_attention_cuda_split_path(cuda, B, T, H, Hkv, D, page):
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    rng = np.random.default_rng(21)
    pages = T // page
    P = B * pages + 5
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    tables = rng.permutation(P)[: B * pages].reshape(B, pages).astype(np.int32)
    lens = ([T - 7, 0, 1, page - 1, page + 1, T, T + 1] + [T] * B)[:B]
    args = [_t(v, cuda, torch.bfloat16) for v in (q, kp, vp, tables, np.asarray(lens, np.int32))]
    assert pa.bf16_path(B, H // Hkv, Hkv, D, [a.data_ptr() for a in args[:3]]) == "split"
    paths = ops.path_launch_counts()["paged_attention"]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert _one_path_launch("paged_attention", paths, "split")
    want, want32 = _plain(ref.paged_attention_ref, *args)
    assert _match(got, want, 1e-5, torch.bfloat16, want32)
    for bb, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[bb], torch.zeros_like(got[bb]))
    assert torch.equal(paged_attention(*args), got)  # no atomics: the same bits


_RAGGED_WGMMA = [
    # B, S, T, H, Hkv, D, lens, starts
    (8, 256, 2048, 16, 8, 128, [0, 1, 37, 256, 256, 37, 1, 256],     # the 256 bucket
     [0, 2047, 500, 0, 1792, 1011, 64, 300]),
    (8, 64, 2048, 16, 8, 128, [0, 1, 37, 64, 64, 37, 1, 64],          # 64
     [0, 2047, 500, 0, 1984, 1011, 1500, 300]),
    (8, 8, 2048, 16, 8, 128, [0, 1, 5, 8, 8, 5, 1, 8],                # 8
     [0, 2047, 500, 0, 2040, 1011, 1500, 300]),
    (8, 1, 2048, 16, 8, 128, [1, 1, 0, 1, 1, 1, 1, 1],                # riders alone
     [2047, 5, 0, 64, 1000, 1500, 2000, 100]),
    (4, 64, 900, 32, 32, 128, [64, 1, 0, 50], [800, 899, 0, 300]),     # llama-7b: G = 1
    (4, 50, 1200, 28, 4, 128, [50, 1, 17, 0], [1100, 1199, 0, 5]),     # qwen2-vl-7b: G = 7
    (4, 64, 900, 12, 4, 160, [64, 1, 0, 50], [800, 899, 0, 300]),      # D = 160, G = 3
    (4, 50, 1200, 8, 1, 256, [50, 1, 17, 0], [1100, 1199, 0, 5]),      # gemma-2b: D = 256
    (2, 512, 520, 16, 16, 64, [512, 512], [0, 0]),                     # seamless's prefill
    (3, 33, 400, 8, 2, 32, [33, 20, 1], [367, 0, 399]),                # D = 32
]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,lens,starts", _RAGGED_WGMMA)
def test_ragged_extend_cuda_wgmma_path(cuda, B, S, T, H, Hkv, D, lens, starts):
    rex = importlib.import_module("repro_torch.kernels.ragged_extend")
    rng = np.random.default_rng(31)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    args = [_t(a, cuda, torch.bfloat16) for a in (q, k, v, np.asarray(starts, np.int32),
                                               np.asarray(lens, np.int32))]
    assert rex.bf16_path(B, S, T, H, Hkv, D, [a.data_ptr() for a in args[:3]]) == "wgmma"
    paths = ops.path_launch_counts()["ragged_extend"]
    got = ragged_extend(*args)
    torch.cuda.synchronize()
    assert _one_path_launch("ragged_extend", paths, "wgmma")
    want, want32 = _plain(ref.ragged_extend_ref, *args)
    assert _match(got, want, 1e-5, torch.bfloat16, want32)
    for b, n in enumerate(lens):
        assert torch.equal(got[b, n:], torch.zeros_like(got[b, n:]))
    assert torch.equal(ragged_extend(*args), got)
    # the plan: 1 to 8 parts, the most at the one-tile buckets (64 blocks)
    # over 2048 keys on a card of 113 SMs or more
    lib = build.load("ragged_extend_wgmma", rex._WGMMA_SIGNATURES)
    parts = lib.ragged_extend_wgmma_kv_parts(B, S, T, H, Hkv, D)
    assert 1 <= parts <= 8
    if B * Hkv == 64 and S * (H // Hkv) <= 128 and T == 2048:
        assert parts == 8


def test_bf16_attention_shapes_off_the_new_loops(cuda):
    """bf16 shapes the new loops do not take run the old ones by the rules:
    ragged_extend at D = 20 on attention_tc.cuh ("mma"), paged_attention
    at G = 32 and at qwen2-vl-7b's G·D = 7 · 128 on the chunk loop; all
    still match their plain versions."""
    rng = np.random.default_rng(41)
    q = rng.standard_normal((2, 16, 8, 20), np.float32)
    k = rng.standard_normal((2, 64, 4, 20), np.float32)
    args = [_t(a, cuda, torch.bfloat16) for a in (q, k, k, np.asarray([48, 0], np.int32),
                                               np.asarray([16, 0], np.int32))]
    paths = ops.path_launch_counts()["ragged_extend"]
    got = ragged_extend(*args)
    assert _one_path_launch("ragged_extend", paths, "mma")
    want, want32 = _plain(ref.ragged_extend_ref, *args)
    assert _match(got, want, 1e-5, torch.bfloat16, want32)
    for G, D in ((32, 64), (7, 128)):
        qp = rng.standard_normal((2, G, D), np.float32)
        kp = rng.standard_normal((4, 16, 1, D), np.float32)
        pargs = [_t(a, cuda, torch.bfloat16) for a in (qp, kp, kp,
                                                    np.asarray([[0, 1], [2, 3]], np.int32),
                                                    np.asarray([20, 32], np.int32))]
        paths = ops.path_launch_counts()["paged_attention"]
        got = paged_attention(*pargs)
        assert _one_path_launch("paged_attention", paths, "chunk")
        want, want32 = _plain(ref.paged_attention_ref, *pargs)
        assert _match(got, want, 1e-5, torch.bfloat16, want32)
