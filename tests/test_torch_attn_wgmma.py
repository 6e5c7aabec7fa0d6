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
from repro_torch.kernels import ref

fp = importlib.import_module("repro_torch.kernels.flash_prefill")

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


def warpgroup(q_rows, k, v, s_row, live, s_first, q_hi, S, D):
    """One consumer warpgroup's 64 rows over K/V tiles 0 .. ceil(q_hi / BK)
    - 1. q_rows (64, D) bf16 values (zeros where not live), k and v (S, D)
    of one kv head. Returns (out rows (64, D) bf16 values, m, l)."""
    DP = 64 * -(-D // 64)
    sl2 = F32(LOG2E / np.sqrt(F32(D)))
    m = np.full(64, -np.inf, F32)
    lq = np.zeros((64, 4), F32)  # each lane's share of l
    o = np.zeros((64, DP), F32)
    nt = -(-q_hi // BK)
    for u in range(nt):
        t = u * BK + np.arange(BK)
        kt = np.zeros((BK, D), F32)
        vt = np.zeros((BK, DP), F32)
        kt[t < S] = k[t[t < S]]
        vt[t < S, :D] = v[t[t < S]]
        if u == nt - 1:
            vt[t >= q_hi] = 0  # later tokens or padding: zeroed before P·V
        sc = wgmma_chain(np.zeros((64, BK), F32), q_rows, kt.T)
        x = (sc * sl2).astype(F32)
        if (u + 1) * BK > s_first + 1:  # a key past the q tile's first token
            x = np.where(t[None] > s_row[:, None], F32(-np.inf), x)
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
