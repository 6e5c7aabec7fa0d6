"""The bf16 wgmma tile loop of ``flash_prefill``, emulated in numpy.

``src/repro_torch/kernels/csrc/attention_wgmma.cuh`` runs bf16
``flash_prefill`` and ``flash_prefill_ragged`` on Hopper's warpgroup
products. For each q tile of 128 query vectors s·G + h of one (row, kv
head), its two consumer warpgroups of 64 rows each do, per K/V tile of BK =
64 keys:

1. S = Q·Kᵀ in one wgmma chain over all of D, one k16 step at a time (the
   first step from a zero accumulator), each step's 16 products summed
   exactly and added to the f32 accumulator rounding toward zero. (The
   kernel pads D to a multiple of 64 with zeros in Q and K: the extra steps
   add exact zeros, which leave a sum rounded toward zero as it is.)
2. x = S · (log2(e)/√D) in f32, -inf where the key is past the row's token
   (only on K/V tiles that reach past the q tile's first token); an online
   softmax in base 2: m' = max(m, max x), α = 2^(m - m'), p = 2^(x - m'),
   each thread's share of l (its 2 columns of every n8 block) kept apart
   and summed over the row's quad of lanes at the end.
3. P goes from the accumulator fragment to the A fragment of the register
   form: n8 block j of a row's scores is the k16 step j / 2's half
   j % 2, its columns 2t, 2t + 1 the A register's k pair. P splits into
   bf16 hi + lo; O = α·O, then lo·V and hi·V accumulate into O one k16
   step at a time (rounding toward zero), V read MN-major as it lies.
4. The output is O·(1/l) rounded once to bf16, and exact zeros for rows of
   tokens past the live ones; keys from the q tile's end to S in its last
   K/V tile are zeroed in V before P·V.

The emulation builds the A fragments register by register as the kernel
does, and is held against the reference's Pallas kernels in interpret mode
at the reference's bf16 tolerance, and against the port's plain f32 version
within one bf16 rounding of it plus ``ATTN_TOL`` and 2^-16 of its largest
magnitude: the bar that ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` hold the kernel to on the card. The
second half pins ``flash_prefill.bf16_path``, the rule that sends a launch
to this loop or to ``attention_tc.cuh``'s.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_prefill as jax_flash_prefill
from repro.kernels import flash_prefill_ragged as jax_flash_prefill_ragged
from repro.kernels import ragged_extend as jax_ragged_extend
from repro_torch.kernels import ref

fp = importlib.import_module("repro_torch.kernels.flash_prefill")
rex = importlib.import_module("repro_torch.kernels.ragged_extend")

ROWS = 128  # query vectors of a q tile
ATTN_TOL = 1e-5  # chip_smoke.ATTN_TOL
BF16_SPLIT_REL = 2.0 ** -16  # chip_smoke.BF16_SPLIT_REL
TOL = dict(rtol=2e-2, atol=2e-1)  # the reference's bf16 tolerance (tests/test_kernels.py)
F32 = np.float32
LOG2E = F32(1.4426950408889634)


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


def wgmma_chain(acc, a, b):
    """acc + a·b one k16 step at a time, each step's products summed
    exactly (bf16 products are exact in f64) and added rounding toward zero."""
    for k0 in range(0, a.shape[1], 16):
        s = slice(k0, k0 + 16)
        acc = rz32(acc.astype(np.float64) + a[:, s].astype(np.float64) @ b[s].astype(np.float64))
    return acc


BK = 64  # attention_wgmma.cuh: keys of a K/V tile
PART_TILES = 4  # ragged_split.cuh: K/V tiles of a KV part, about


def acc_coords(n_blocks: int):
    """The m64nN accumulator fragment: (rows, cols) of register i of the
    thread (warp w, lane 4g + t), shaped (128 threads, 4·n_blocks)."""
    th = np.arange(128)
    w, g, t = th // 32, (th % 32) // 4, th % 4
    i = np.arange(4 * n_blocks)
    j, e = i // 4, i % 4
    rows = 16 * w[:, None] + g[:, None] + 8 * (e[None] >= 2)
    cols = 8 * j[None] + 2 * t[:, None] + (e[None] & 1)
    return rows, cols


def a_fragments(p: np.ndarray) -> list[np.ndarray]:
    """P (64, BK) through the kernel's registers: each thread's accumulator
    values sc[4j + i] packed as ph[j / 2][2·(j % 2) + (i >= 2)], half i & 1,
    then read back as the register form's A (a0 (g, 2t..), a1 (g + 8, 2t..),
    a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..) per warp): one (64, 16) A per k16
    step."""
    BK = p.shape[1]
    rows, cols = acc_coords(BK // 8)
    sc = p[rows, cols]  # (128 threads, BK / 2): the accumulator as it lies
    regs = np.zeros((128, BK // 16, 4, 2), F32)  # [thread][k16 step][register][half]
    for j in range(BK // 8):
        for i in range(4):
            regs[:, j // 2, 2 * (j % 2) + (i >= 2), i & 1] = sc[:, 4 * j + i]
    th = np.arange(128)
    w, g, t = th // 32, (th % 32) // 4, th % 4
    out = []
    for step in range(BK // 16):
        a = np.full((64, 16), np.nan, F32)
        for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            for half in range(2):
                a[16 * w + g + dr, 2 * t + dk + half] = regs[:, step, reg, half]
        assert not np.isnan(a).any()
        out.append(a)
    return out


def warpgroup(q_rows, k, v, s_row, live, s_first, q_hi, S, D, st=0, T=None, u0=0, nt=None,
              partial=False):
    """One consumer warpgroup's 64 rows over K/V tiles u0 .. u0 + nt - 1 of
    the keys [0, kv_end), kv_end = min(st + q_hi, T) (T = S, st = 0: a fresh
    sequence; all of them by default). q_rows (64, D) bf16 values (zeros
    where not live) of tokens s_row at positions st + s_row, k and v (T, D)
    of one kv head. Returns (out rows (64, D) bf16 values, m, l) or, with
    ``partial``, (Σ p·v (64, D) f32, m·ln 2, l) for the combine pass. A
    warpgroup with no live row issues no products."""
    T = S if T is None else T
    DP = 64 * -(-D // 64)
    sl2 = F32(LOG2E / np.sqrt(F32(D)))
    m = np.full(64, -np.inf, F32)
    lq = np.zeros((64, 4), F32)  # each lane's share of l
    o = np.zeros((64, DP), F32)
    kv_end = min(st + q_hi, T)
    kv_tiles = -(-kv_end // BK)
    nt = kv_tiles - u0 if nt is None else nt
    for u in range(u0, u0 + nt if live.any() else u0):
        t = u * BK + np.arange(BK)
        kt = np.zeros((BK, D), F32)
        vt = np.zeros((BK, DP), F32)
        kt[t < T] = k[t[t < T]]
        vt[t < T, :D] = v[t[t < T]]
        if u == kv_tiles - 1:
            vt[t >= kv_end] = 0  # later tokens, padding or cache past the frontier
        sc = wgmma_chain(np.zeros((64, BK), F32), q_rows, kt.T)
        x = (sc * sl2).astype(F32)
        if (u + 1) * BK > st + s_first + 1:  # a key past the q tile's first position
            x = np.where(t[None] > st + s_row[:, None], F32(-np.inf), x)
        mn = np.maximum(m, x.max(1))
        mu = np.where(mn == -np.inf, F32(0), mn)
        al = np.exp2(m - mu).astype(F32)
        p = np.exp2(x - mu[:, None]).astype(F32)
        ps = np.zeros((64, 4), F32)
        for j in range(BK // 8):
            for t4 in range(4):
                ps[:, t4] = ps[:, t4] + (p[:, 8 * j + 2 * t4] + p[:, 8 * j + 2 * t4 + 1])
        lq = (lq * al[:, None] + ps).astype(F32)
        m = mn
        o = (o * al[:, None]).astype(F32)
        for step, a in enumerate(a_fragments(p)):
            hi = bf16(a)
            lo = bf16(a - hi)  # a - hi is exact in f32
            vs = vt[16 * step:16 * step + 16]
            o = wgmma_chain(o, lo, vs)
            o = wgmma_chain(o, hi, vs)
    l = (lq[:, 0] + lq[:, 1]) + (lq[:, 2] + lq[:, 3])  # the quad's shuffles
    if partial:
        return o[:, :D], (m * F32(np.log(2.0))).astype(F32), l
    f = (F32(1) / np.maximum(l, F32(1e-30))).astype(F32)
    rows = np.where(live[:, None], bf16((o * f[:, None]).astype(F32)), F32(0))
    return rows[:, :D], m, l


def emulate(q, k, v, true_lens=None):
    """flash_prefill (``true_lens`` None) or flash_prefill_ragged on bf16
    values as f32 arrays, head-major: one block per (row, kv head, q tile).
    Returns the output and how many times each (b, h, s) was written."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    out = np.full(q.shape, np.nan, F32)
    writes = np.zeros((B, H, S), np.int64)
    for b in range(B):
        n = S if true_lens is None else min(max(int(true_lens[b]), 0), S)
        for hkv in range(Hkv):
            for v_lo in range(0, S * G, ROWS):
                q_hi = min(-(-(v_lo + ROWS) // G), S, n)
                vec = v_lo + np.arange(ROWS)
                s, h = vec // G, vec % G
                kept = s < S  # rows past the S·G vectors: never written
                tile = np.zeros((ROWS, D), F32)
                if v_lo // G < q_hi:
                    live = s < q_hi
                    for c in range(2):
                        r = slice(64 * c, 64 * c + 64)
                        qr = np.zeros((64, D), F32)
                        lv = live[r]
                        qr[lv] = q[b, hkv * G + h[r][lv], s[r][lv]]
                        tile[r] = warpgroup(qr, k[b, hkv], v[b, hkv], s[r], lv, v_lo // G,
                                            q_hi, S, D)[0]
                out[b, hkv * G + h[kept], s[kept]] = tile[kept]
                np.add.at(writes, (b, hkv * G + h[kept], s[kept]), 1)
    return out, writes


def one_rounding_excess(got, want32, atol):
    """chip_smoke.one_rounding_err: the largest excess of |got - bf16(want)|
    over one bf16 spacing at |want| plus ``atol`` (<= 0 holds)."""
    w = want32.astype(np.float64)
    _, e = np.frexp(want32)
    spacing = np.where(want32 == 0, 0.0, np.ldexp(1.0, e - 8))
    return float((np.abs(got - bf16(want32)) - spacing - atol).max())


_CASES = [
    # B, H, Hkv, S, D, true_lens
    (1, 2, 1, 150, 64, None),           # G = 2: 2 q tiles, 2 K/V tiles of 128
    (2, 7, 1, 75, 128, [0, 75]),        # G = 7: heads straddle tiles; a row of length 0
    (1, 8, 1, 60, 256, None),           # G = 8 (gemma-2b), 64-key tiles, O 64 x 256
    (2, 4, 4, 140, 160, [1, 140]),      # G = 1, D = 160 padded to 192 in P·V; length 1
    (2, 14, 2, 40, 128, [40, 23]),      # G = 7, ragged inside a q tile
    (1, 16, 2, 33, 64, None),           # G = 8, S not a tile multiple
]


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (bf16(rng.standard_normal(shape, F32))
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    return q, k, v


@pytest.mark.parametrize("B,H,Hkv,S,D,lens", _CASES)
def test_wgmma_loop_matches_pallas_and_one_rounding_of_f32(B, H, Hkv, S, D, lens):
    """Every (row, head, token) written once; rows past a row's length exact
    zeros; within the reference's bf16 tolerance of its Pallas kernel (and
    2e-2 of max, chip_smoke's BF16_TOL); each element within one bf16
    rounding of the plain f32 version + ATTN_TOL + 2^-16 of max."""
    q, k, v = _inputs(B, H, Hkv, S, D, seed=S * 7 + D)
    tl = None if lens is None else np.asarray(lens, np.int32)
    got, writes = emulate(q, k, v, tl)
    assert np.all(writes == 1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    if tl is None:
        want = jax_flash_prefill(jq, jk, jv, block_q=32, block_k=32, interpret=True)
        want32 = ref.flash_prefill_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    else:
        want = jax_flash_prefill_ragged(jq, jk, jv, tl, block_q=32, block_k=32,
                                        interpret=True)
        want32 = ref.flash_prefill_ragged_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                              torch.from_numpy(tl))
        for b, n in enumerate(lens):
            assert np.all(got[b, :, n:] == 0)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())
    want32 = want32.numpy()
    atol = ATTN_TOL + BF16_SPLIT_REL * float(np.abs(want32).max())
    assert one_rounding_excess(got, want32, atol) <= 0


def test_p_fragments_keep_the_key_order():
    """The accumulator-to-A conversion moves no value across keys: each k16
    step's A is the scores of its 16 keys, in order, for every row."""
    p = np.arange(64 * 128, dtype=F32).reshape(64, 128)
    for step, a in enumerate(a_fragments(p)):
        assert np.array_equal(a, p[:, 16 * step:16 * step + 16])


def test_rounding_toward_zero_stays_inside_the_bar_at_full_length():
    """One (row, kv head) of qwen3-0.6b's 8 x 2016 prefill (G = 2, D = 128),
    its last q tile's first warpgroup (the longest accumulator chains: 32
    K/V tiles, 252 products of P·V a column), emulated with the tensor
    cores' rounding toward zero: within one bf16 rounding of an f64 oracle
    plus a quarter of the bar's absolute term."""
    S, D, G = 2016, 128, 2
    rng = np.random.default_rng(11)
    q = bf16(rng.standard_normal((G, S, D), F32))
    k = bf16(rng.standard_normal((S, D), F32))
    v = bf16(rng.standard_normal((S, D), F32))
    v_lo = (S * G - 1) // ROWS * ROWS
    vec = v_lo + np.arange(64)
    s, h = vec // G, vec % G
    live = s < S
    got = warpgroup(q[h, s], k, v, s, live, v_lo // G, S, S, D)[0]
    sc = np.einsum("rd,td->rt", q[h, s].astype(np.float64), k.astype(np.float64)) / np.sqrt(D)
    sc = np.where(np.arange(S)[None] <= s[:, None], sc, -np.inf)
    w = np.exp(sc - sc.max(1, keepdims=True))
    want = ((w / w.sum(1, keepdims=True)) @ v.astype(np.float64)).astype(F32)
    atol = ATTN_TOL + BF16_SPLIT_REL * float(np.abs(want).max())
    assert one_rounding_excess(got, want, atol / 4) <= 0


# ------------------------------------------------------- ragged_extend
def emulate_ragged(q, k, v, start, true_lens, n_split):
    """bf16 ragged_extend on ``csrc/ragged_extend_wgmma.cu``: q (B, S, Hq, D)
    and k, v (B, T, Hkv, D) bf16 values as f32 arrays. One block per (q tile
    of 128 vectors, row, kv head, KV part): a tile whose keys make one part
    writes its rows (zeros past the live tokens); the parts of a split tile
    write (Σ p·v, m·ln 2, l) and the combine pass merges them in part order
    (M = max m, w = e^(m - M), Σ w·o / Σ w·l, rounded once) and writes the
    zeros of padded queries. ``n_split``: the launch's part count
    (``ragged_extend_wgmma_kv_parts``); a tile takes min(n_split, one part
    a PART_TILES of its K/V tiles). Returns the output and the writes of
    each (b, s, head) by the attention blocks."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    out = np.full(q.shape, np.nan, F32)
    writes = np.zeros((B, S, Hq), np.int64)
    parts_of = {}  # (b, s, h) -> the partials of its split tile, in part order
    for b in range(B):
        n, st = min(max(int(true_lens[b]), 0), S), int(start[b])
        for hkv in range(Hkv):
            for v_lo in range(0, S * G, ROWS):
                vec = v_lo + np.arange(ROWS)
                s, h = vec // G, vec % G
                kept = s < S
                q_hi = min(-(-(v_lo + ROWS) // G), S, n)
                if v_lo // G >= q_hi:
                    if n_split == 1:  # zeros; else the combine writes them
                        out[b, s[kept], hkv * G + h[kept]] = 0
                        np.add.at(writes, (b, s[kept], hkv * G + h[kept]), 1)
                    continue
                live = s < q_hi
                kv_tiles = -(-min(st + q_hi, T) // BK)
                parts = min(-(-kv_tiles // PART_TILES), n_split)
                tile = np.zeros((ROWS, D), F32)
                for part in range(parts):
                    u0 = part * kv_tiles // parts
                    nt = (part + 1) * kv_tiles // parts - u0
                    for c in range(2):
                        r = slice(64 * c, 64 * c + 64)
                        qr = np.zeros((64, D), F32)
                        lv = live[r]
                        qr[lv] = q[b, s[r][lv], hkv * G + h[r][lv]]
                        res = warpgroup(qr, k[b, :, hkv], v[b, :, hkv], s[r], lv, v_lo // G,
                                        q_hi, S, D, st=st, T=T, u0=u0, nt=nt,
                                        partial=parts > 1)
                        if parts == 1:
                            tile[r] = res[0]
                            continue
                        for i in np.flatnonzero(lv):
                            key = (b, int(s[r][i]), hkv * G + int(h[r][i]))
                            parts_of.setdefault(key, []).append(
                                (res[0][i], res[1][i], res[2][i]))
                if parts == 1:
                    out[b, s[kept], hkv * G + h[kept]] = tile[kept]
                    np.add.at(writes, (b, s[kept], hkv * G + h[kept]), 1)
    if n_split > 1:  # the combine pass
        for b in range(B):
            n = min(max(int(true_lens[b]), 0), S)
            out[b, n:] = 0
        for (b, s_, h), states in parts_of.items():
            M = F32(-1e30)
            for _, m, _ in states:
                M = max(M, m)
            L = F32(0)
            for _, m, l in states:
                L = F32(L + F32(l * np.exp(F32(m - M))))
            a = np.zeros(D, F32)
            for o, m, _ in states:
                a = (a + o * np.exp(F32(m - M))).astype(F32)
            out[b, s_, h] = bf16(a * (F32(1) / max(L, F32(1e-30))))
    return out, writes


_RAGGED = [
    # B, S, T, Hq, Hkv, D, lens, starts, n_split: the engine's buckets cut to
    # size, each with the part count its launch would take on an H100
    (4, 16, 300, 4, 2, 64, [0, 1, 16, 9], [0, 299, 200, 37], 2),   # riders, a 0 row
    (3, 8, 600, 14, 2, 128, [8, 1, 5], [592, 599, 0], 3),          # G = 7 over tiles
    (2, 20, 260, 8, 1, 256, [20, 13], [240, 0], 2),                # G = 8, D = 256
    (3, 70, 600, 2, 2, 160, [70, 1, 33], [530, 599, 10], 3),       # G = 1, D = 160
    (2, 40, 700, 4, 2, 64, [40, 1], [600, 699], 1),                # one part a tile
    (2, 5, 100, 4, 1, 32, [5, 3], [95, 0], 1),                     # a frontier at T
    (2, 8, 2048, 2, 1, 64, [8, 5], [2040, 1500], 8),               # 8 parts, 6 parts
]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,lens,starts,n_split", _RAGGED)
def test_ragged_wgmma_loop_matches_pallas_and_one_rounding_of_f32(B, S, T, Hq, Hkv, D, lens,
                                                                 starts, n_split):
    """The KV split and its combine, decode riders (one live query at a
    long start), padded queries and empty rows exact zeros, warpgroups with
    no live row; against the Pallas kernel (interpret) and the plain f32
    version at chip_smoke's bars."""
    rng = np.random.default_rng(S + T + D)
    q = bf16(rng.standard_normal((B, S, Hq, D), F32))
    k = bf16(rng.standard_normal((B, T, Hkv, D), F32))
    v = bf16(rng.standard_normal((B, T, Hkv, D), F32))
    tl, st = np.asarray(lens, np.int32), np.asarray(starts, np.int32)
    got, writes = emulate_ragged(q, k, v, st, tl, n_split)
    assert not np.isnan(got).any()
    for b, n in enumerate(lens):
        assert np.all(got[b, n:] == 0)
    if n_split == 1:
        assert np.all(writes == 1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_ragged_extend(jq, jk, jv, st, tl, block_q=16, block_k=16,
                                        interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())
    want32 = ref.ragged_extend_ref(*(torch.from_numpy(a) for a in (q, k, v, st, tl))).numpy()
    atol = ATTN_TOL + BF16_SPLIT_REL * float(np.abs(want32).max())
    assert one_rounding_excess(got, want32, atol) <= 0


@pytest.mark.parametrize("name,B,S,T,Hq,Hkv,D,ptr,path", [
    ("qwen3-0.6b bucket", 8, 256, 2048, 16, 8, 128, 0, "wgmma"),
    ("llama-7b", 8, 256, 2048, 32, 32, 128, 0, "wgmma"),
    ("qwen2-vl-7b", 8, 256, 2048, 28, 4, 128, 0, "wgmma"),
    ("stablelm-12b", 8, 256, 2048, 32, 8, 160, 0, "wgmma"),
    ("gemma-2b", 8, 256, 2048, 8, 1, 256, 0, "wgmma"),
    ("seamless-m4t", 8, 256, 2048, 16, 16, 64, 0, "wgmma"),
    ("a decode rider bucket", 8, 1, 2048, 16, 8, 128, 0, "wgmma"),
    ("D = 20", 4, 64, 700, 8, 8, 20, 0, "mma"),
    ("D = 36", 2, 16, 64, 4, 1, 36, 0, "mma"),
    ("D = 272", 1, 8, 64, 2, 1, 272, 0, "mma"),
    ("an 8-byte base", 8, 256, 2048, 16, 8, 128, 8, "mma"),
])
def test_ragged_bf16_path_rule(name, B, S, T, Hq, Hkv, D, ptr, path):
    assert rex.bf16_path(B, S, T, Hq, Hkv, D, (4096 + ptr, 8192, 12288)) == path
    assert rex.bf16_path(B, S, T, Hq, Hkv, D, (4096, 8192, 12288 + ptr)) == path


# ------------------------------------------------------------ the path rule
def _strides(B, H, Hkv, S, D, transposed):
    """The b, h, s element strides of q, k and v: head-major tensors, or
    (B, S, H, D) tensors transposed to head-major, as gqa_full passes them."""
    def one(h):
        return (S * h * D, D, h * D) if transposed else (h * S * D, S * D, D)
    return (*one(H), *one(Hkv), *one(Hkv))


@pytest.mark.parametrize("name,B,H,Hkv,S,D,transposed,ptr,path", [
    ("qwen3-0.6b static", 8, 16, 8, 2016, 128, True, 0, "wgmma"),
    ("qwen3-0.6b head-major", 8, 16, 8, 2016, 128, False, 0, "wgmma"),
    ("stablelm-12b static", 2, 32, 8, 2048, 160, True, 0, "wgmma"),
    ("gemma-2b static", 2, 8, 1, 2048, 256, True, 0, "wgmma"),
    ("qwen2-vl-7b static", 2, 28, 4, 300, 128, True, 0, "wgmma"),
    ("seamless-m4t static", 2, 16, 16, 512, 64, True, 0, "wgmma"),
    ("D = 16", 1, 4, 4, 33, 16, False, 0, "wgmma"),
    ("D = 20", 2, 6, 2, 77, 20, False, 0, "mma"),        # not a multiple of 16
    ("D = 36", 2, 4, 1, 300, 36, True, 0, "mma"),        # 72-byte rows
    ("D = 272", 1, 2, 1, 16, 272, False, 0, "mma"),      # past 256
    ("an 8-byte base", 2, 16, 8, 64, 128, True, 8, "mma"),
])
def test_bf16_path_rule(name, B, H, Hkv, S, D, transposed, ptr, path):
    strides = _strides(B, H, Hkv, S, D, transposed)
    assert fp.bf16_path(D, strides, (4096 + ptr, 8192, 12288)) == path


def test_bf16_path_rule_needs_positive_16_byte_strides():
    good = _strides(2, 16, 8, 64, 128, True)
    assert fp.bf16_path(128, good, (0, 0, 0)) == "wgmma"
    for i in range(9):
        for bad in (0, good[i] + 4):  # a broadcast dimension, an 8-byte step
            strides = good[:i] + (bad,) + good[i + 1:]
            assert fp.bf16_path(128, strides, (0, 0, 0)) == "mma"


def test_bf16_path_of_gqa_full_views():
    """gqa_full's q/k/v, (B, S, H, D) tensors transposed to head-major, at
    qwen3-0.6b, stablelm-12b and gemma-2b widths, take the wgmma loop."""
    for H, Hkv, D in ((16, 8, 128), (32, 8, 160), (8, 1, 256)):
        q = torch.zeros((2, 8, H, D), dtype=torch.bfloat16).transpose(1, 2)
        k = torch.zeros((2, 8, Hkv, D), dtype=torch.bfloat16).transpose(1, 2)
        strides = (*q.stride()[:3], *k.stride()[:3], *k.stride()[:3])
        assert fp.bf16_path(D, strides, (q.data_ptr(), k.data_ptr(), k.data_ptr())) == "wgmma"
