"""The bf16 split loop of ``paged_attention``, emulated in numpy.

``csrc/paged_attention.cu``'s split loop (``paged_attention.bf16_path``:
bf16, G <= 16, G·D <= 512, D a multiple of 8; the loop itself takes any
G <= 16) runs ``paged_attention.split_plan``
blocks per (row, kv head), one thread-block cluster each. Block s takes
the s-th contiguous, equal share of the row's live 64-token tiles
(``paged_attention.split_share``); its thread 0 loads each tile's K and V
by TMA in boxes of gcd(page, 64) tokens, each inside one page, from a
window of 256 table entries that the block reloads where a row needs more.
Each of its 8 consumer warps attends keys 8w .. 8w + 7 of every tile with
a state of its own, on the bf16 values widened to f32: scores q·k / √D
(-1e30 past the length), an online softmax (m' = max(m, max s),
α = e^(m - m'), p = e^(s - m'), l' = α·l + Σ p, acc' = α·acc + p·V). The
warps' states meet in order (M = max m_w, f_w = e^(m_w - M), L = Σ f_w·l_w,
A = Σ f_w·acc_w) into the block's, and the cluster merge takes the
blocks' the same way, ranks in order, out = A / L rounded once to bf16,
and zeros for a row of length 0.

The emulation follows that plan in f32 and is held against the
reference's Pallas kernel in interpret mode on the bf16 inputs (the
reference's bf16 tolerance, and 2e-2 of max, chip_smoke's BF16_TOL) and
against the port's plain f32 version on the upcast inputs within one bf16
rounding plus ``ATTN_TOL`` and 2^-16 of max: the bars of
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py`` on the card.
It checks that every live token is read once, from its own page, and none
past the length. The path rule is pinned at the end.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jax_paged_attention
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import (SPLIT_MAX, SPLIT_TOKENS, bf16_path,
                                                 split_plan, split_share)

F32 = np.float32
NEG = F32(-1e30)
WIN = 256  # csrc: split::WIN, table entries a block holds
ATTN_TOL = 1e-5  # chip_smoke.ATTN_TOL
BF16_SPLIT_REL = 2.0 ** -16  # chip_smoke.BF16_SPLIT_REL
TOL = dict(rtol=2e-2, atol=2e-1)  # the reference's bf16 tolerance (tests/test_kernels.py)


def bf16(a):
    """f32 to the nearest bf16 (ties to even), as f32 values."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(F32)


def one_rounding_excess(got, want32, atol):
    """chip_smoke.one_rounding_err: the largest excess of |got - bf16(want)|
    over one bf16 spacing at |want| plus ``atol`` (<= 0 holds)."""
    _, e = np.frexp(want32)
    spacing = np.where(want32 == 0, 0.0, np.ldexp(1.0, e - 8))
    return float((np.abs(got - bf16(want32)) - spacing - atol).max())


def merge(m, l, acc):
    """States (m, l, acc) stacked on a first axis, merged in its order."""
    M = m.max(0)
    L = np.zeros_like(l[0])
    A = np.zeros_like(acc[0])
    for mw, lw, aw in zip(m, l, acc):
        f = np.exp(mw - M).astype(F32)
        L = (L + lw * f).astype(F32)
        A = (A + aw * f[:, None]).astype(F32)
    return M, L, A


def split_emulate(q, kp, vp, tables, lengths, n_split):
    """The split loop on f32 arrays of bf16 values. Returns the output
    (bf16 values), the tokens each (b, kv head) read in order, and the
    window reloads."""
    B, H, D = q.shape
    _, page, Hkv, _ = kp.shape
    pages = tables.shape[1]
    G, T = H // Hkv, pages * page
    bt = math.gcd(page, SPLIT_TOKENS)
    out = np.zeros((B, H, D), F32)
    seen, reloads = {}, 0
    scale = F32(math.sqrt(D))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            states = []
            for s in range(n_split):
                j0, j1 = split_share(int(lengths[b]), T, n_split, s)
                m = np.full((8, G), NEG, F32)  # each consumer warp's state
                l = np.zeros((8, G), F32)
                acc = np.zeros((8, G, D), F32)
                win0 = j0 * SPLIT_TOKENS // page
                window = tables[b, win0:win0 + WIN]
                for u in range(j0, j1):
                    t0, t1 = u * SPLIT_TOKENS, min((u + 1) * SPLIT_TOKENS, n)
                    if (t1 - 1) // page >= win0 + WIN:  # the block reloads its window
                        win0 = t0 // page
                        window = tables[b, win0:win0 + WIN]
                        reloads += 1
                    toks = []
                    for t in range(t0, t1, bt):  # one box: bt tokens of one page
                        assert t // page == (t + bt - 1) // page
                        toks += [(int(window[t // page - win0]), t % page + i, t + i)
                                 for i in range(bt) if t + i < t1]
                    seen.setdefault((b, h), []).extend(t for _, _, t in toks)
                    for w in range(0, len(toks), 8):  # warp w // 8: 8 keys of the tile
                        ks = toks[w:w + 8]
                        k = np.stack([kp[p, o, h] for p, o, _ in ks])
                        v = np.stack([vp[p, o, h] for p, o, _ in ks])
                        sc = ((qg @ k.T) / scale).astype(F32)
                        mw, lw, aw = m[w // 8], l[w // 8], acc[w // 8]
                        mn = np.maximum(mw, sc.max(1))
                        p = np.exp(sc - mn[:, None]).astype(F32)
                        al = np.exp(mw - mn).astype(F32)
                        l[w // 8] = (lw * al + p.sum(1)).astype(F32)
                        acc[w // 8] = (aw * al[:, None] + p @ v).astype(F32)
                        m[w // 8] = mn
                states.append(merge(m, l, acc))
            _, L, A = merge(*(np.stack(x) for x in zip(*states)))  # ranks in order
            inv = F32(1) / np.maximum(L, F32(1e-30)) if n > 0 else np.zeros(G, F32)
            out[b, h * G:(h + 1) * G] = bf16(A * inv[:, None])
    return out, seen, reloads


def _inputs(B, H, Hkv, D, page, pages, seed, extra=3):
    rng = np.random.default_rng(seed)
    P = B * pages + extra
    q = bf16(rng.standard_normal((B, H, D), F32))
    kp = bf16(rng.standard_normal((P, page, Hkv, D), F32))
    vp = bf16(rng.standard_normal((P, page, Hkv, D), F32))
    tables = rng.permutation(P)[: B * pages].reshape(B, pages).astype(np.int32)
    return q, kp, vp, tables


_CASES = [
    # B, H, Hkv, D, page, pages, lens, sms
    (4, 2, 2, 64, 8, 24, [0, 1, 7, 9], 8),              # G = 1, 8-token pages, page ± 1
    (3, 4, 2, 128, 16, 12, [15, 17, 192], 132),         # G = 2 (qwen3), 16-token pages
    (3, 7, 1, 128, 128, 2, [129, 256, 300], 4),         # G = 7 (qwen2-vl), T, past T
    (2, 8, 1, 256, 16, 9, [144, 63], 132),              # G = 8, D = 256 (gemma-2b)
    (3, 16, 1, 160, 8, 20, [160, 65, 1], 16),           # G = 16, D = 160
    (2, 16, 2, 64, 128, 3, [383, 0], 2),                # G = 8, one block a row
    (5, 4, 4, 128, 8, 30, [240, 241, 239, 64, 65], 11),  # G = 1, tiles across 8 pages
]


@pytest.mark.parametrize("B,H,Hkv,D,page,pages,lens,sms", _CASES)
def test_split_loop_matches_pallas_and_one_rounding_of_f32(B, H, Hkv, D, page, pages, lens,
                                                          sms):
    q, kp, vp, tables = _inputs(B, H, Hkv, D, page, pages, seed=D + page + B)
    ln = np.asarray(lens, np.int32)
    n_split = split_plan(B, Hkv, sms)
    got, seen, _ = split_emulate(q, kp, vp, tables, ln, n_split)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp))
    want = np.asarray(jax_paged_attention(jq, jk, jv, tables, ln, interpret=True)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())
    want32 = ref.paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, tables, ln))).numpy()
    atol = ATTN_TOL + BF16_SPLIT_REL * float(np.abs(want32).max())
    assert one_rounding_excess(got, want32, atol) <= 0
    T = page * pages
    for b, n in enumerate(lens):
        n = min(max(n, 0), T)
        for h in range(Hkv):  # every live token once, in order; none past
            assert seen.get((b, h), []) == list(range(n))
        if n == 0:
            assert np.all(got[b] == 0)


def test_split_loop_reloads_its_table_window():
    """One block over a row of 1024 pages of 8 tokens: the block's window of
    256 table entries is reloaded three times, and the output is the plain
    f32 version's within one bf16 rounding."""
    B, H, Hkv, D, page, pages = 1, 2, 1, 16, 8, 1024
    q, kp, vp, tables = _inputs(B, H, Hkv, D, page, pages, seed=5)
    ln = np.asarray([pages * page - 3], np.int32)
    got, seen, reloads = split_emulate(q, kp, vp, tables, ln, split_plan(B, Hkv, 1))
    assert split_plan(B, Hkv, 1) == 2 and reloads == 2  # two blocks, 512 pages each
    got1, _, reloads1 = split_emulate(q, kp, vp, tables, ln, 1)
    assert reloads1 == 3
    want32 = ref.paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, tables, ln))).numpy()
    atol = ATTN_TOL + BF16_SPLIT_REL * float(np.abs(want32).max())
    for out in (got, got1):
        assert one_rounding_excess(out, want32, atol) <= 0
    assert seen[(0, 0)] == list(range(int(ln[0])))


@pytest.mark.parametrize("n_split", range(1, SPLIT_MAX + 1))
def test_split_shares_cover_every_live_tile_once(n_split):
    T = 2048
    for length in (0, 1, 63, 64, 65, 129, 500, 2047, 2048, 2049, 5000, -3):
        n_live = -(-min(max(length, 0), T) // SPLIT_TOKENS)
        shares = [split_share(length, T, n_split, s) for s in range(n_split)]
        tiles = [u for j0, j1 in shares for u in range(j0, j1)]
        assert tiles == list(range(n_live))  # contiguous, in rank order, once
        sizes = [j1 - j0 for j0, j1 in shares]
        assert max(sizes) - min(sizes) <= 1  # equal shares


def test_split_plan_gives_a_few_blocks_an_sm():
    """qwen3-0.6b's decode (B = 8, 8 kv heads) on an H100: 5 blocks a
    cluster, 320 blocks; llama-7b's 32 kv heads: 2; gemma-2b's one: 8 (the
    most a portable cluster holds); never fewer than 1."""
    assert split_plan(8, 8, 132) == 5
    assert split_plan(8, 32, 132) == 2
    assert split_plan(8, 1, 132) == SPLIT_MAX
    assert split_plan(64, 32, 132) == 1
    for B in (1, 2, 8, 64):
        for Hkv in (1, 2, 4, 8, 32):
            n = split_plan(B, Hkv, 132)
            assert 1 <= n <= SPLIT_MAX
            assert n == SPLIT_MAX or B * Hkv * n >= 2 * 132 or n == 1


@pytest.mark.parametrize("name,B,G,Hkv,D,ptr,path", [
    ("qwen3-0.6b", 8, 2, 8, 128, 0, "split"),
    ("llama-7b", 8, 1, 32, 128, 0, "split"),
    ("qwen2-vl-7b", 8, 7, 4, 128, 0, "chunk"),     # G·D past 512: the chunk loop wins
    ("stablelm-12b", 8, 4, 8, 160, 0, "chunk"),
    ("gemma-2b", 8, 8, 1, 256, 0, "chunk"),
    ("seamless-m4t", 2, 1, 16, 64, 0, "split"),
    ("G·D = 512", 2, 4, 8, 128, 0, "split"),
    ("G·D = 512, D = 256", 2, 2, 8, 256, 0, "split"),
    ("G·D = 520", 2, 13, 8, 40, 0, "chunk"),
    ("G·D = 576", 2, 9, 8, 64, 0, "chunk"),
    ("G = 16", 2, 16, 1, 32, 0, "split"),
    ("G = 17", 2, 17, 1, 8, 0, "chunk"),           # past the split loop's heads
    ("G = 128", 2, 128, 1, 256, 0, "chunk"),
    ("D = 20", 4, 3, 8, 20, 0, "chunk"),           # no multiple of 8
    ("D = 12", 3, 4, 1, 12, 0, "chunk"),
    ("an 8-byte base", 8, 2, 8, 128, 8, "chunk"),
    ("B·Hkv past 65535", 4096, 2, 32, 128, 0, "chunk"),
])
def test_paged_bf16_path_rule(name, B, G, Hkv, D, ptr, path):
    assert bf16_path(B, G, Hkv, D, (4096 + ptr, 8192, 12288)) == path
    assert bf16_path(B, G, Hkv, D, (4096, 8192 + ptr, 12288)) == path
