"""The 3xTF32 arithmetic of the attention tile loop, emulated in numpy.

``src/repro_torch/kernels/csrc/attention_tc.cuh`` (the loop of
``ragged_extend.cu`` and ``flash_prefill.cu``) runs both products of
attention on the tensor cores with TF32 operands (10 explicit mantissa
bits), in this order for each 64-key K/V tile:

1. S = Q·Kᵀ: each operand splits into hi = tf32(a) and lo = tf32(a - hi);
   each k8 step over D adds lo·hi, hi·lo and hi·hi to one f32 accumulator.
2. x = S / √D in f32; an f32 online softmax over the tile: m' = max(m,
   max x), α = exp(m - m'), p = exp(x - m') (exactly 0 where masked),
   l = l·α + Σp.
3. P splits hi/lo like any operand; P·V sums the tile's keys in a fresh
   accumulator, one k8 step and three products at a time.
4. O = α·O + that, in f32. The output is O·(1/l), and 0 for padded queries.

These tests pin the argument that lets the kernels keep the attention
tolerance of ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``
(1e-5 absolute). The case is one KV group of the 256-token chunk at start
1792 in ``chip_smoke.RAGGED_BUCKETS[256]`` (row 4, 71 % of the flops of
that bucket), cut to its last q tile: 32 tokens x G = 2 heads, 64 query
vectors against 2017-2048 keys, D = 128. The emulated kernel stays within a
tenth of the tolerance of an f64 oracle, and one TF32 product for either
Q·Kᵀ or P·V does not stay within it. Each k8 step's eight products are
summed exactly and rounded once into the f32 accumulator; the tensor core's
own rounding inside a step is not modelled.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

ATTN_TOL = 1e-5  # chip_smoke.ATTN_TOL: absolute
MARGIN = 10.0
BKV = 64  # keys per K/V tile


def tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, to nearest,
    ties away from zero, on the bits of the f32 (finite inputs). A copy of
    tests/test_torch_tf32x3.py's."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(a, np.float32)
    hi = tf32(a)
    return hi, tf32(a - hi)  # a - hi is exact in f32


def mma(acc, a, b, passes: int):
    """acc + a·b on the tensor cores, one k8 step at a time: 3xTF32
    (``passes`` 3: lo·hi, hi·lo, hi·hi) or one TF32 product (1)."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3 else [(ahi, bhi)]
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        for pa, pb in terms:
            acc = (acc.astype(np.float64)
                   + pa[:, s].astype(np.float64) @ pb[s].astype(np.float64)
                   ).astype(np.float32)
    return acc


def emulate(q, k, v, pos, live, kv_end, qk_passes=3, pv_passes=3):
    """The tile loop for one q tile of one KV group: q (R, D) query vectors
    at absolute positions ``pos`` (R,), live where ``live``; keys
    0 .. kv_end - 1 of k, v (T, D), key t seen by row r where t <= pos[r]."""
    R, D = q.shape
    f32 = np.float32
    sqrt_d = np.sqrt(f32(D))
    m = np.full((R,), -1e30, f32)
    l = np.zeros((R,), f32)
    o = np.zeros((R, D), f32)
    for t0 in range(0, kv_end, BKV):
        t = np.arange(t0, t0 + BKV)
        # K/V rows past the keys the tile may see are staged as zeros
        kt = np.where((t < kv_end)[:, None], k[t0:t0 + BKV], f32(0))
        vt = np.where((t < kv_end)[:, None], v[t0:t0 + BKV], f32(0))
        s = mma(np.zeros((R, BKV), f32), q, kt.T, qk_passes)
        valid = live[:, None] & (t[None, :] < kv_end) & (t[None, :] <= pos[:, None])
        x = np.where(valid, s / sqrt_d, f32(-1e30)).astype(f32)
        m_new = np.maximum(m, x.max(1))
        alpha = np.exp(m - m_new).astype(f32)
        p = np.where(valid, np.exp(x - m_new[:, None]), f32(0)).astype(f32)
        l = (l * alpha + p.sum(1, dtype=f32)).astype(f32)
        fresh = mma(np.zeros((R, D), f32), p, vt, pv_passes)
        o = ((o * alpha[:, None]).astype(f32) + fresh).astype(f32)
        m = m_new
    inv = np.where(live, f32(1) / np.maximum(l, f32(1e-30)), f32(0)).astype(f32)
    return (o * inv[:, None]).astype(f32)


def oracle(q, k, v, pos, live, kv_end):
    q64, k64, v64 = (a.astype(np.float64) for a in (q, k[:kv_end], v[:kv_end]))
    logits = q64 @ k64.T / np.sqrt(q.shape[1])
    valid = np.arange(kv_end)[None, :] <= pos[:, None]
    logits = np.where(valid, logits, -np.inf)
    w = np.exp(logits - logits.max(1, keepdims=True))
    w /= w.sum(1, keepdims=True)
    return np.where(live[:, None], w @ v64, 0.0)


def case(true_len=256, seed=0, T=2048, start=1792, G=2, D=128, tokens=32):
    """The last q tile (``tokens`` tokens x G heads) of row 4 of the
    256-token bucket, one KV group: q (R, D), k and v (T, D), each query
    vector's position and liveness, and the row's frontier."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tokens * G, D), np.float32)
    k = rng.standard_normal((T, D), np.float32)
    v = rng.standard_normal((T, D), np.float32)
    s = 256 - tokens + np.arange(tokens * G) // G  # token of each vector
    live = s < true_len
    kv_end = min(start + min(256, true_len), T)
    return q, k, v, start + s, live, kv_end


def test_attn_3xtf32_keeps_the_tolerance_with_margin():
    q, k, v, pos, live, kv_end = case()
    assert live.all() and kv_end == 2048 and 2017 <= pos.min() + 1
    want = oracle(q, k, v, pos, live, kv_end)
    err = float(np.abs(emulate(q, k, v, pos, live, kv_end) - want).max())
    assert err * MARGIN <= ATTN_TOL, err
    # the port's plain version (f32 on the CPU) meets the same bound
    G, D = 2, q.shape[1]
    qt = torch.zeros((1, 256, G, D))
    qt[0, 256 - len(q) // G:] = torch.from_numpy(q).view(-1, G, D)
    kt = torch.from_numpy(k)[None, :, None].expand(1, -1, 1, D).contiguous()
    vt = torch.from_numpy(v)[None, :, None].expand(1, -1, 1, D).contiguous()
    plain = ref.ragged_extend_ref(qt, kt, vt, torch.tensor([1792]),
                                  torch.tensor([256]))[0, 256 - len(q) // G:]
    assert float(np.abs(plain.reshape(-1, D).numpy() - want).max()) * MARGIN <= ATTN_TOL


@pytest.mark.parametrize("product", ["qk", "pv"])
def test_one_tf32_product_misses_the_tolerance(product):
    """Why each product pays three: one TF32 product keeps ~11 bits of its
    operands, Q·Kᵀ's error moves the softmax weights and P·V's the sums."""
    q, k, v, pos, live, kv_end = case()
    want = oracle(q, k, v, pos, live, kv_end)
    passes = {"qk_passes": 1} if product == "qk" else {"pv_passes": 1}
    got = emulate(q, k, v, pos, live, kv_end, **passes)
    assert float(np.abs(got - want).max()) > ATTN_TOL


def test_padded_queries_are_exact_zeros_and_stale_rows_never_reach_pv():
    """Queries past true_lens keep l == 0 and come out as exact zeros; K/V
    rows past the frontier hold NaN here and are staged as zeros, so the
    live rows stay finite and within the tolerance."""
    q, k, v, pos, live, kv_end = case(true_len=240)
    assert live.sum() == 2 * 16 and kv_end == 1792 + 240
    k[kv_end:] = np.nan
    v[kv_end:] = np.nan
    got = emulate(q, k, v, pos, live, kv_end)
    assert np.all(got[~live] == 0) and np.isfinite(got).all()
    want = oracle(q, k, v, pos, live, kv_end)
    assert float(np.abs(got - want).max()) * MARGIN <= ATTN_TOL
