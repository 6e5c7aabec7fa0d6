"""The bf16 wgmma tile loop of ``fused_sgmv``, emulated in numpy.

``src/repro_torch/kernels/csrc/fused_sgmv_wgmma.cu`` runs bf16
``fused_sgmv`` where ``sgmv.bf16_path`` says "wgmma" (M = B·S > 16 rows,
d_in and d_out multiples of 8, 16-byte bases). It computes y = x·W +
scale·(x·A[id])·B[id] in three kernels, split over d_in as the source's
``make_plan`` says (``sgmv.wgmma_plan`` reads it; each case here names the
plan the card takes at its shape):

1. The shrink: for each batch row of id >= 0 and each part z of d_in (k
   stages of 64), h_z = scale·(x·A[id]) over the part's k, one mma.sync
   chain of k16 steps, each step's 16 products summed exactly and added to
   the f32 accumulator rounding toward zero; ranks pad to rs = 32·ceil(r/32)
   with zeros. h = h_0 + h_1 + ... in part order (f32), added by the last
   part's block to finish.
2. The tile loop over 128-row tiles, two warpgroups of 64 rows each: x·W
   over the part's k stages, one k16 chain into the f32 accumulator. Then
   part z = 0 adds the expand: for each adapter id live in the tile (in
   batch row order, once however many rows carry it), for each stage of 32
   ranks, its two k16 steps j: A = h[rows, ranks of j] with rows of other
   ids (and past M) zeroed, split into bf16 hi + lo; acc += lo·B[id][ranks
   of j] then hi·B[id], each a k16 chain step rounding toward zero (a
   warpgroup with no row of the id skips them).
3. y = bf16(acc) where d_in is not split, else bf16 of the parts' f32
   partial tiles added in part order.

Columns never interact, so the emulation takes every column of a row tile
at once. It is held against the reference's Pallas kernel in interpret mode
at the reference's bf16 tolerance, and against the port's plain f32
version within one bf16 rounding plus ``SGMV_TOL`` of max and 2^-16 of
max: the bar that ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``
hold the kernel to on the card. The rest pins ``sgmv.bf16_path``; the
plan itself is C (``tests/test_torch_cuda_kernels.py`` pins it).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_sgmv as jax_fused_sgmv
from repro_torch.kernels import ref

sg = importlib.import_module("repro_torch.kernels.sgmv")

SGMV_TOL = 1e-4  # chip_smoke.SGMV_TOL: times max|plain|
BF16_SPLIT_REL = 2.0 ** -16  # chip_smoke.BF16_SPLIT_REL
TOL = dict(rtol=2e-2, atol=2e-1)  # the reference's bf16 tolerance (tests/test_kernels.py)
F32 = np.float32
TILE_M, K = 128, 64  # fused_sgmv_wgmma.cu's BM (rows of a tile) and BK (k of a stage)


def bf16(a: np.ndarray) -> np.ndarray:
    """f32 to the nearest bf16 (ties to even), as f32 values."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(F32)


def rz32(x: np.ndarray) -> np.ndarray:
    """f64 to f32 rounded toward zero: the tensor cores' accumulator."""
    y = x.astype(F32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, F32(0)), y).astype(F32)


def chain(acc, a, b):
    """acc + a·b one k16 step at a time, each step's products summed
    exactly (bf16 products are exact in f64) and added rounding toward zero."""
    for k0 in range(0, a.shape[1], 16):
        s = slice(k0, k0 + 16)
        acc = rz32(acc.astype(np.float64) + a[:, s].astype(np.float64) @ b[s].astype(np.float64))
    return acc


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), F32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def shrink(x, lora_a, ids, S, rs, parts, kper, scale):
    """Kernel 1: h (M, rs), its parts added in order."""
    Bn, d_in = len(ids), x.shape[1]
    Kp = -(-d_in // K) * K
    hp = np.zeros((parts, Bn * S, rs), F32)
    for b, i in enumerate(ids):
        if i < 0:
            continue  # zeros, A unread
        rows = slice(b * S, (b + 1) * S)
        xb, ab = _pad(x[rows], S, Kp), _pad(lora_a[i], Kp, rs)
        for z in range(parts):
            k = slice(z * kper * K, min((z + 1) * kper * K, Kp))
            hp[z, rows] = (F32(scale) * chain(np.zeros((S, rs), F32), xb[:, k], ab[k])).astype(F32)
    h = hp[0]
    for z in range(1, parts):
        h = (h + hp[z]).astype(F32)
    return h


def split_hi_lo(a):
    """f32 a as bf16 hi + lo, hi rounded to nearest and lo the rounded rest."""
    hi = bf16(a)
    return hi, bf16((a - hi).astype(F32))


def _kper(KT, parts):
    """k stages a part when KT stages split into ``parts``, none empty."""
    kper = -(-KT // parts)
    assert -(-KT // kper) == parts, "a plan with an empty part"
    return kper


def emulate(x, w, lora_a, lora_b, ids, S, scale, sp=1, bp=1):
    """fused_sgmv_wgmma.cu on bf16 values as f32 arrays: x (B, S, d_in),
    d_in split into ``sp`` parts in the shrink and ``bp`` in the tile loop.
    Returns y (B, S, d_out) as bf16 values."""
    Bn, _, d_in = x.shape
    N, _, r = lora_a.shape
    d_out = w.shape[1]
    M = Bn * S
    rs = -(-r // 32) * 32
    KT = -(-d_in // K)
    skper, bkper = _kper(KT, sp), _kper(KT, bp)
    xf = x.reshape(M, d_in)
    h = shrink(xf, lora_a, ids, S, rs, sp, skper, scale)
    Mp, Kp = -(-M // TILE_M) * TILE_M, KT * K
    xp, wp = _pad(xf, Mp, Kp), _pad(w, Kp, d_out)
    hp = _pad(h, Mp, rs)
    row_id = np.full(Mp, -1)
    row_id[:M] = np.repeat(ids, S)
    bp_pad = np.zeros((N, rs, d_out), F32)
    bp_pad[:, :r] = lora_b
    parts = []
    for z in range(bp):
        acc = np.zeros((Mp, d_out), F32)
        for m0 in range(0, M, TILE_M):
            k = slice(z * bkper * K, min((z + 1) * bkper * K, Kp))
            rows = slice(m0, m0 + TILE_M)
            acc[rows] = chain(acc[rows], xp[rows, k], wp[k])
            if z > 0:
                continue
            segs = ids[m0 // S:(min(m0 + TILE_M, M) - 1) // S + 1]
            lead = [i for p, i in enumerate(segs) if i >= 0 and i not in segs[:p]]
            for i in lead:
                for e0 in range(0, r, 32):
                    for c in range(2):
                        wr = slice(m0 + 64 * c, m0 + 64 * c + 64)
                        keep = row_id[wr] == i
                        if not keep.any():
                            continue  # the warpgroup skips the products
                        for j in range(2):
                            ks = slice(e0 + 16 * j, e0 + 16 * j + 16)
                            a = np.where(keep[:, None], hp[wr, ks], F32(0))
                            hi, lo = split_hi_lo(a)
                            acc[wr] = chain(acc[wr], lo, bp_pad[i, ks])
                            acc[wr] = chain(acc[wr], hi, bp_pad[i, ks])
        parts.append(acc[:M])
    y = parts[0]
    for p in parts[1:]:
        y = (y + p).astype(F32)
    return bf16(y).reshape(Bn, S, d_out)


def one_rounding_excess(got, want32, atol):
    """chip_smoke.one_rounding_err: the largest excess of |got - bf16(want)|
    over one bf16 spacing at |want| plus ``atol`` (<= 0 holds)."""
    _, e = np.frexp(want32)
    spacing = np.where(want32 == 0, 0.0, np.ldexp(1.0, e - 8))
    return float((np.abs(got - bf16(want32)) - spacing - atol).max())


def _inputs(B, S, d_in, d_out, r, N, ids, seed, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d_in), F32)
    w = rng.standard_normal((d_in, d_out), F32) * d_in ** -0.5
    a = rng.standard_normal((N, d_in, r), F32) * d_in ** -0.5
    b = rng.standard_normal((N, r, d_out), F32) * 0.1
    if positive:
        x, w, a, b = (np.abs(t) for t in (x, w, a, b))
    return (*(bf16(t) for t in (x, w, a, b)), np.asarray(ids, np.int32))


_CASES = [
    # B, S, d_in, d_out, r, N, ids, scale, positive, then the plan of an
    # H100 (132 SMs) at the shape: the shrink's and the tile loop's parts
    (2, 2016, 64, 256, 32, 4, [1, 2], 1.0, False, 1, 1),        # S = 2016: a tile straddles rows
    (4, 37, 256, 320, 16, 3, [-1, 2, 0, 2], 0.5, False, 1, 2),  # 128-row tiles over 4 batch rows
    (3, 37, 128, 256, 1, 3, [0, -1, 0], 2.0, False, 1, 1),      # rank 1, a repeated id
    (3, 40, 128, 256, 12, 3, [2, 2, -1], 0.25, False, 1, 1),    # rank 12
    (2, 64, 256, 256, 32, 3, [0, 1], 1.0, False, 1, 2),         # rank 32
    (2, 50, 128, 256, 128, 3, [1, -1], 0.5, False, 1, 1),       # rank 128: two expand stages
    (2, 40, 256, 576, 32, 4, [3, 0], 1.0, False, 1, 2),         # deepseek kv_a's d_out = 576
    (2, 37, 4096, 256, 32, 2, [1, 0], 1.0, True, 8, 8),         # d_in = 4096, all positive
    (8, 32, 1024, 256, 32, 8, [0, 1, 2, 3, 4, 5, 6, -1], 1.0, False, 2, 8),  # d_in in 8 parts
    # other plans on the same arithmetic: one chain over d_in = 4096, the
    # shrink in 4 and 8 parts
    (2, 37, 4096, 256, 32, 2, [1, 0], 1.0, True, 1, 1),
    (4, 37, 256, 320, 16, 3, [-1, 2, 0, 2], 0.5, False, 4, 1),
    (8, 32, 1024, 256, 32, 8, [0, 1, 2, 3, 4, 5, 6, -1], 1.0, False, 8, 4),
]


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale,positive,sp,bp", _CASES)
def test_wgmma_loop_matches_pallas_and_one_rounding_of_f32(B, S, d_in, d_out, r, N, ids,
                                                           scale, positive, sp, bp):
    x, w, a, b, idv = _inputs(B, S, d_in, d_out, r, N, ids, seed=S * 7 + d_in + r, positive=positive)
    assert sg.bf16_path(B * S, d_in, d_out, (0, 0, 0, 0), torch.bfloat16) == "wgmma"
    got = emulate(x, w, a, b, idv, S, scale, sp, bp)
    jx, jw, ja, jb = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, w, a, b))
    want = np.asarray(jax_fused_sgmv(jx, jw, ja, jb, idv, scale=scale, block_s=min(S, 128),
                                     block_o=128, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())
    t = [torch.from_numpy(v) for v in (x, w, a, b)]
    plain = ref.fused_sgmv_ref(*(v.to(torch.bfloat16) for v in t), torch.from_numpy(idv), scale)
    want32 = ref.fused_sgmv_ref(*t, torch.from_numpy(idv), scale).numpy()
    atol = SGMV_TOL * float(plain.float().abs().max()) + BF16_SPLIT_REL * float(np.abs(want32).max())
    assert one_rounding_excess(got, want32, atol) <= 0


@pytest.mark.parametrize("ids", [[-1, 2, 0, 2], [1, -1, -1, 1], [-1, -1, -1, -1]])
def test_rows_of_id_minus_one_are_the_base_product_bit_for_bit(ids):
    """The expand adds exact zeros to a row of another id or of id -1, so
    every such row equals the launch with every id -1, bit for bit."""
    x, w, a, b, idv = _inputs(4, 37, 128, 256, 16, 3, ids, seed=5)
    got = emulate(x, w, a, b, idv, 37, 1.5)
    base = emulate(x, w, a, b, np.full(4, -1, np.int32), 37, 1.5)
    dead = idv < 0
    assert np.array_equal(got[dead], base[dead])


def test_rounding_toward_zero_stays_inside_the_bar_at_d_in_4096():
    """All-positive inputs over d_in = 4096 (256 k16 steps rounding toward
    zero in one chain, no f32 flush): within one bf16 rounding of an f64
    oracle plus a quarter of the bar's absolute term, and the drift of the
    f32 sum itself below 2^-15 of it."""
    x, w, a, b, idv = _inputs(1, 40, 4096, 256, 32, 1, [0], seed=3, positive=True)
    xf = x[0]
    acc = chain(np.zeros((40, 256), F32), xf, w)
    exact = xf.astype(np.float64) @ w.astype(np.float64)
    assert float(np.abs(acc - exact).max() / np.abs(exact).max()) < 2.0 ** -15
    got = emulate(x, w, a, b, idv, 40, 1.0)[0]
    h = xf.astype(np.float64) @ a[0].astype(np.float64)
    want = exact + h @ b[0].astype(np.float64)
    atol = (SGMV_TOL + BF16_SPLIT_REL) * float(np.abs(want).max())
    assert one_rounding_excess(got, want.astype(F32), atol / 4) <= 0


def test_hi_lo_split_keeps_h_to_2_to_the_minus_17():
    """h = hi + lo + e with |e| <= 2^-17·|h| (hi: h rounded to bf16, lo:
    the rest rounded), so the expand's two products keep h's 16 bits."""
    rng = np.random.default_rng(0)
    h = (rng.standard_normal(100_000) * np.exp(rng.uniform(-20, 20, 100_000))).astype(F32)
    hi, lo = split_hi_lo(h)
    err = np.abs(h.astype(np.float64) - hi - lo)
    assert np.all(err <= 2.0 ** -17 * np.abs(h.astype(np.float64)))


# ------------------------------------------------------------ the path rule
@pytest.mark.parametrize("name,M,d_in,d_out,ptr,path", [
    ("qwen3-0.6b q, 8 x 2016", 16128, 1024, 2048, 0, "wgmma"),
    ("qwen3-0.6b k, 8 x 2016", 16128, 1024, 1024, 0, "wgmma"),
    ("qwen3-0.6b o, 8 x 256", 2048, 2048, 1024, 0, "wgmma"),
    ("the 8 x 32 extend", 256, 1024, 2048, 0, "wgmma"),
    ("deepseek kv_a", 512, 2048, 576, 0, "wgmma"),
    ("llama-7b q, 2 x 512", 1024, 4096, 4096, 0, "wgmma"),
    ("just past the skinny path", 17, 1024, 1024, 0, "wgmma"),
    ("a decode step of 8 rows", 8, 1024, 2048, 0, "skinny"),
    ("16 rows", 16, 2048, 1024, 0, "cluster"),
    ("16 rows, d_in % 4", 16, 97, 64, 0, "mma"),
    ("d_out % 8", 148, 256, 324, 0, "mma"),
    ("d_in % 8", 148, 100, 320, 0, "mma"),
    ("an 8-byte base", 148, 256, 256, 8, "mma"),
    # the cluster loop: W of 2^22 elements, or 2^21 past 8 rows (the rows
    # measured on the card are listed beside sgmv.CLUSTER_MIN_WEIGHTS)
    ("llama-7b q, a decode step", 2, 4096, 4096, 0, "cluster"),
    ("llama-7b q, 4 rows", 4, 4096, 4096, 0, "cluster"),
    ("rwkv6-1.6b r, 8 rows", 8, 2048, 2048, 0, "cluster"),
    ("rwkv6-1.6b r, 16 rows", 16, 2048, 2048, 0, "cluster"),
    ("qwen3-0.6b o, 12 rows", 12, 2048, 1024, 0, "cluster"),
    ("rwkv6-1.6b r, a decode step", 2, 2048, 2048, 0, "cluster"),
    ("deepseek q, a decode step", 2, 2048, 3072, 0, "cluster"),
    ("recurrentgemma q, 8 rows", 8, 2560, 2560, 0, "cluster"),
    ("qwen3-0.6b q, 9 rows", 9, 1024, 2048, 0, "cluster"),
    ("one row of llama-7b q", 1, 4096, 4096, 0, "cluster"),
    ("just under 2^22 at 8 rows", 8, 2048, 2040, 0, "skinny"),
    ("just under 2^21 at 16 rows", 16, 1024, 2040, 0, "skinny"),
    ("deepseek kv_a, a decode step", 2, 2048, 576, 0, "skinny"),
    ("recurrentgemma k, a decode step", 2, 2560, 256, 0, "skinny"),
    ("seamless q, a decode step", 2, 1024, 1024, 0, "skinny"),
    ("8 rows, d_out % 8", 8, 4096, 4092, 0, "skinny"),
    ("8 rows, d_in % 8", 8, 4092, 4096, 0, "skinny"),
    ("8 rows, an 8-byte base", 8, 4096, 4096, 8, "skinny"),
    ("16 rows, an 8-byte base", 16, 2048, 1024, 8, "skinny"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_path_rule(name, M, d_in, d_out, ptr, path, dtype):
    """bf16 as listed; f32 takes the skinny loop for every launch of at
    most 16 rows and mma.sync for every tiled launch (the cluster and wgmma
    loops are bf16 only)."""
    if dtype == torch.float32:
        path = {"wgmma": "mma", "cluster": "skinny"}.get(path, path)
    for i in range(4):  # x, W, A and B: any one off 16 bytes moves the launch
        ptrs = [4096, 8192, 12288, 16384]
        ptrs[i] += ptr
        assert sg.bf16_path(M, d_in, d_out, ptrs, dtype) == path
