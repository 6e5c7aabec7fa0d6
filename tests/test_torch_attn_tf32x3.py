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

The second half emulates the tilings the kernels took on for the other
dense configs: q tiles that number a row's query vectors s·G + h, so at
G = 7 a token's heads straddle two tiles and rows past S·G are dead; wide
heads (D > 128) staged 32 keys at a time with P·V's columns split over the
warps of a row; Q·Kᵀ joined in f32 every 32 of D (8 joins at D = 256); and
the tensor cores' accumulator rounding toward zero. The emulation walks
one block per q tile (no KV split) and is held against the Pallas kernel
in interpret mode, called as ``tests/test_torch_kernels.py`` calls it.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels import ragged_extend as jax_ragged_extend
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


# ------------------------------------- the tilings of wide heads and any G
def rz32(x: np.ndarray) -> np.ndarray:
    """f64 to f32 rounded toward zero: the tensor cores' accumulator."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y).astype(np.float32)


def mma_rz(a, b):
    """a·b from a zero accumulator, 3xTF32, one k8 step at a time, each
    step's sum exact and added to the accumulator rounding toward zero."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        for pa, pb in ((alo, bhi), (ahi, blo), (ahi, bhi)):
            acc = rz32(acc.astype(np.float64)
                       + pa[:, s].astype(np.float64) @ pb[s].astype(np.float64))
    return acc


def tile_rows(vectors: int, D: int) -> int:
    """csrc/attention_tc.cuh: tile_rows."""
    most = 64 if D > 128 else 128
    rows = 16
    while rows < most and rows < vectors:
        rows *= 2
    return rows


def d_tiles(D: int) -> int:
    """csrc/attention_tc.cuh: d_tiles."""
    return 4 if D <= 32 else 8 if D <= 64 else 16 if D <= 128 else 20 if D <= 160 else 32


def tile_attend(qt, k, v, pos, live, kv_end, D):
    """One q tile of attention_tc.cuh's loop with all of a staged tile's
    keys in each warp (a 128-row tile, or a wide head): qt (R, DP) zero
    padded to the k8 step, k and v (T, D) of one kv head, each row's
    absolute position and liveness. Returns the normalised rows (R, D)."""
    R, DP = qt.shape
    wide = D > 128
    bk = 32 if wide else 64  # keys of a staged tile
    wk = 8 // (R // 16)  # warps of a row: they split D's d-tiles (wide)
    dt = DP // 8
    blocks = ([(w * dt // wk * 8, (w + 1) * dt // wk * 8) for w in range(wk)]
              if wide else [(0, DP)])
    f32 = np.float32
    scale = f32(1) / np.sqrt(f32(D))
    m = np.full((R,), -1e30, f32)
    l = np.zeros((R,), f32)
    o = np.zeros((R, DP), f32)
    for t0 in range(0, kv_end, bk):
        t = np.arange(t0, t0 + bk)
        inside = (t < kv_end)[:, None]
        kt = np.zeros((bk, DP), f32)
        vt = np.zeros((bk, DP), f32)
        kt[:, :D] = np.where(inside, k[np.minimum(t, len(k) - 1)], f32(0))
        vt[:, :D] = np.where(inside, v[np.minimum(t, len(v) - 1)], f32(0))
        sc = np.zeros((R, bk), f32)
        for d0 in range(0, DP, 32):  # a fresh accumulator every 32 of D
            sc = (sc + mma_rz(qt[:, d0:d0 + 32], kt[:, d0:d0 + 32].T)).astype(f32)
        valid = live[:, None] & (t[None, :] < kv_end) & (t[None, :] <= pos[:, None])
        x = np.where(valid, sc * scale, f32(-1e30)).astype(f32)
        m_new = np.maximum(m, x.max(1))
        alpha = np.exp(m - m_new).astype(f32)
        p = np.where(valid, np.exp(x - m_new[:, None]), f32(0)).astype(f32)
        l = (l * alpha + p.sum(1, dtype=f32)).astype(f32)
        fresh = np.concatenate([mma_rz(p, vt[:, lo:hi]) for lo, hi in blocks], axis=1)
        o = ((o * alpha[:, None]).astype(f32) + fresh).astype(f32)
        m = m_new
    inv = np.where(live, f32(1) / np.maximum(l, f32(1e-30)), f32(0)).astype(f32)
    return (o * inv[:, None]).astype(f32)[:, :D]


def emulate_ragged(q, k, v, start, true_lens):
    """ragged_extend.cu with one block per q tile: for each (row, kv head)
    the query vectors s·G + h in tiles of ``tile_rows`` rows. Returns the
    output and how many times each (b, s, head) was written."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    rows = tile_rows(S * G, D)
    assert rows == 128 or D > 128, "narrow tiles under 128 rows split keys over warps"
    DP = 8 * d_tiles(D)
    out = np.full(q.shape, np.nan, np.float32)
    writes = np.zeros((B, S, Hq), np.int64)
    for b in range(B):
        n_new = min(int(true_lens[b]), S)
        for hkv in range(Hkv):
            for v_lo in range(0, S * G, rows):
                vec = v_lo + np.arange(rows)
                s, h = vec // G, vec % G
                s_end = min(-(-(v_lo + rows) // G), S)
                q_hi = min(s_end, n_new)
                live = s < q_hi
                kept = s < S  # rows past S·G are dead: never written
                o = np.zeros((rows, D), np.float32)
                if v_lo // G < q_hi:
                    qt = np.zeros((rows, DP), np.float32)
                    qt[live, :D] = q[b, s[live], hkv * G + h[live]]
                    kv_end = min(int(start[b]) + min(s_end, n_new), T)
                    o = tile_attend(qt, k[b, :, hkv], v[b, :, hkv], int(start[b]) + s,
                                    live, kv_end, D)
                out[b, s[kept], hkv * G + h[kept]] = o[kept]
                np.add.at(writes, (b, s[kept], hkv * G + h[kept]), 1)
    return out, writes


_TILINGS = [
    # G, D, S, T, lens, starts
    (7, 128, 32, 200, [32, 1], [150, 199]),  # 224 vectors: token 18's heads straddle
    (7, 256, 32, 150, [32, 20], [100, 0]),   # wide: 64-row tiles, D split over 2 warps
    (4, 160, 32, 120, [32, 0], [80, 5]),     # wide, 20 d-tiles over 2 warps
    (7, 20, 32, 100, [32, 3], [60, 90]),     # D = 20 padded to 32, G = 7
    (1, 256, 16, 90, [16, 9], [70, 0]),      # G = 1: 16-row tiles, D over 8 warps
]


@pytest.mark.parametrize("G,D,S,T,lens,starts", _TILINGS)
def test_tilings_of_any_group_and_wide_heads_match_pallas(G, D, S, T, lens, starts):
    """The q tiles cover every (token, head) once, dead rows are never
    written, padded queries are zeros, and the emulated arithmetic stays
    within the tolerance of the Pallas kernel and within a quarter of it of
    an f64 oracle. (With the accumulator's rounding toward zero modelled,
    these cases read 0.7e-6 to 1.8e-6 against the oracle; the card reads
    1.7e-6 to 3.4e-6 at D = 160 and 256, ``chip_smoke.py`` phase 3.)"""
    rng = np.random.default_rng(G * 1000 + D)
    Hkv = 2 if G > 1 else 3
    B = len(lens)
    q = rng.standard_normal((B, S, G * Hkv, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    st, tl = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    got, writes = emulate_ragged(q, k, v, st, tl)
    assert np.all(writes == 1)
    for b, n in enumerate(lens):
        assert np.all(got[b, n:] == 0)
    want = np.asarray(jax_ragged_extend(q, k, v, st, tl, block_q=16, block_k=16,
                                        interpret=True))
    assert float(np.abs(got - want).max()) <= ATTN_TOL
    # an f64 oracle per live query vector
    for b in range(B):
        for s_ in range(lens[b]):
            pos = starts[b] + s_
            for hq in range(G * Hkv):
                kk, vv = k[b, :pos + 1, hq // G], v[b, :pos + 1, hq // G]
                w = kk.astype(np.float64) @ q[b, s_, hq].astype(np.float64) / math.sqrt(D)
                w = np.exp(w - w.max())
                ref64 = (w / w.sum()) @ vv.astype(np.float64)
                assert float(np.abs(got[b, s_, hq] - ref64).max()) * 4 <= ATTN_TOL
