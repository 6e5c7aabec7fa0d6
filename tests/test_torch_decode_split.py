"""The decode kernels' decompositions, emulated in plain PyTorch on the CPU.

``csrc/fused_sgmv.cu``'s skinny path (M <= 16 rows) splits d_in over
blocks: each k split writes a partial of x·W per 64-column slab and, from
the block of the first batch row carrying each live adapter id, a partial
of x·A[id] for every row of that id; a second kernel adds the partials in
split order and then scale·h·B[id]. ``csrc/paged_attention.cu`` covers
each row's table in chunks of 64 tokens (32 for a head dim past 128), one
block per (chunk, kv head, row), with the group's heads in blocks of 8
where G is not 1, 2, 4 or 8; a live chunk writes its softmax state (m, l,
Σp·v) and a second kernel merges the live chunks in order.

The emulations below follow those plans (``sgmv.skinny_plan``,
``paged_attention.chunk_plan``, mirrors of the CUDA sources' own) and are
held against the JAX Pallas kernels in interpret mode, called as
``tests/test_torch_kernels.py`` calls them, and against the port's plain
versions. Tolerance: atol = rtol = 1e-5 (f32 on every side; only the order
of the sums differs). The plans are checked to cover every k row, output
column and live token exactly once.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels import fused_sgmv as jax_fused_sgmv
from repro.kernels import paged_attention as jax_paged_attention
from repro.kernels import sgmv as jax_sgmv
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import chunk_plan, chunk_tokens
from repro_torch.kernels.sgmv import SKINNY_COLS, SKINNY_KS, skinny_plan

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ fused_sgmv
def _k_ranges(d_in, splits, kper):
    """The k rows of each split: ring stages [z·kper, (z + 1)·kper)."""
    step = kper * SKINNY_KS
    return [(z * step, min((z + 1) * step, d_in)) for z in range(splits)]


def _shrink_leads(ids):
    """Batch row -> whether its shrink block works: the first row of a live id."""
    return [int(i) >= 0 and int(i) not in [int(j) for j in ids[:b]]
            for b, i in enumerate(ids)]


def skinny_emulate(x, w, a, b, ids, scale, sms):
    """The skinny path's two passes with ``w`` (fused_sgmv) or without
    (``w is None``, sgmv). Returns y (B, S, d_out) and the writes of pass 1
    as {(kind, split, row): count}, kind "w" per output column slab or "h"."""
    B, S, d_in = x.shape
    M, r, d_out = B * S, a.shape[2], b.shape[2]
    xf = x.reshape(M, d_in)
    row_ids = [int(ids[m // S]) for m in range(M)]
    cols, splits, kper = skinny_plan(M, d_in, d_out, w is not None, sms)
    part = torch.full((splits, M, d_out), float("nan"))
    hpart = torch.full((splits, M, r), float("nan"))
    writes = {}
    leads = _shrink_leads(ids)
    for z, (k0, k1) in enumerate(_k_ranges(d_in, splits, kper)):
        for c in range(cols):  # W blocks: every row, one 64-column slab
            n0, n1 = c * SKINNY_COLS, min((c + 1) * SKINNY_COLS, d_out)
            part[z, :, n0:n1] = xf[:, k0:k1] @ w[k0:k1, n0:n1]
            for n in range(n0, n1):
                writes[("w", z, n)] = writes.get(("w", z, n), 0) + 1
        for bb in range(B):  # shrink blocks
            if not leads[bb]:
                continue
            aid = int(ids[bb])
            rows = [m for m in range(M) if row_ids[m] == aid]
            hpart[z, rows] = xf[rows, k0:k1] @ a[aid, k0:k1]
            for m in rows:
                writes[("h", z, m)] = writes.get(("h", z, m), 0) + 1
    y = torch.zeros((M, d_out))
    for m in range(M):  # pass 2: splits in order, then the delta
        if w is not None:
            acc = part[0, m].clone()
            for z in range(1, splits):
                acc = acc + part[z, m]
            y[m] = acc
        if row_ids[m] >= 0:
            h = hpart[0, m].clone()
            for z in range(1, splits):
                h = h + hpart[z, m]
            y[m] = y[m] + (scale * h) @ b[row_ids[m]]
    return y.reshape(B, S, d_out), writes, (cols, splits, kper)


def _sgmv_inputs(B, S, d_in, d_out, r, N, ids, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d_in), np.float32)
    w = rng.standard_normal((d_in, d_out), np.float32) * d_in ** -0.5
    a = rng.standard_normal((N, d_in, r), np.float32) * d_in ** -0.5
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.1
    if ids == "none":
        idv = np.full((B,), -1, np.int32)
    elif ids == "one":
        idv = np.full((B,), N - 1, np.int32)
    else:  # a negative id, a repeated id, the rest drawn
        idv = rng.integers(0, N, size=(B,)).astype(np.int32)
        idv[0] = -1
        idv[-1] = idv[min(1, B - 1)]
    return x, w, a, b, idv


_SKINNY = [
    # B, S, d_in, d_out, r, N, ids, sms
    (8, 1, 128, 256, 32, 8, "mixed", 132),   # decode: more splits than stages
    (8, 1, 256, 320, 32, 8, "mixed", 6),     # a few stages per split
    (8, 1, 100, 72, 4, 3, "mixed", 132),     # d_in off the 32-row stage, r = 4
    (8, 1, 2052, 64, 64, 3, "mixed", 8),     # 2048 + 4 rows, r = 64
    (1, 1, 64, 68, 8, 2, "one", 132),        # M = 1, a part-filled column slab
    (16, 1, 96, 128, 16, 4, "none", 132),    # M = 16, every id -1
    (2, 8, 96, 132, 8, 3, "one", 4),         # S = 8: one adapter, 16 rows
]


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,sms", _SKINNY)
def test_skinny_fused_sgmv_split_matches_pallas(B, S, d_in, d_out, r, N, ids, sms):
    x, w, a, b, idv = _sgmv_inputs(B, S, d_in, d_out, r, N, ids, seed=d_in + d_out)
    got, writes, (cols, splits, kper) = skinny_emulate(
        *map(torch.from_numpy, (x, w, a, b, idv)), 0.5, sms)
    want = jax_fused_sgmv(x, w, a, b, idv, scale=0.5, block_s=16, block_o=64,
                          interpret=True)
    plain = ref.fused_sgmv_ref(*map(torch.from_numpy, (x, w, a, b, idv)), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    # each output column once per split; h once per split for each live row
    M = B * S
    assert all(writes[("w", z, n)] == 1 for z in range(splits) for n in range(d_out))
    live_rows = [m for m in range(M) if idv[m // S] >= 0]
    assert sorted(k[1:] for k in writes if k[0] == "h") == sorted(
        (z, m) for z in range(splits) for m in live_rows)
    assert len(writes) == splits * (d_out + len(live_rows))


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,sms", _SKINNY)
def test_skinny_sgmv_split_matches_pallas(B, S, d_in, d_out, r, N, ids, sms):
    x, _, a, b, idv = _sgmv_inputs(B, S, d_in, d_out, r, N, ids, seed=d_in + 1)
    xt, at, bt, it = map(torch.from_numpy, (x, a, b, idv))
    got, writes, (cols, _, _) = skinny_emulate(xt, None, at, bt, it, 2.0, sms)
    want = jax_sgmv(x, a, b, idv, scale=2.0, block_s=16, block_o=64, interpret=True)
    plain = ref.sgmv_ref(*map(torch.from_numpy, (x, a, b, idv)), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert cols == 0 and not any(k[0] == "w" for k in writes)
    dead = idv < 0  # a row of id -1 is exact zeros
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))


@pytest.mark.parametrize("M,d_in,d_out,has_base,sms", [
    (8, 1024, 2048, True, 132),   # the q projection at decode
    (8, 1024, 1024, True, 132),   # k, v
    (8, 2048, 1024, True, 132),   # o
    (8, 1024, 2048, False, 132),  # sgmv
    (1, 100, 4, True, 132),
    (16, 2052, 68, True, 132),
    (16, 32, 4096, True, 132),    # one stage of k
    (3, 8192, 64, False, 1),
])
def test_skinny_plan_covers_every_k_row_once(M, d_in, d_out, has_base, sms):
    cols, splits, kper = skinny_plan(M, d_in, d_out, has_base, sms)
    ranges = _k_ranges(d_in, splits, kper)
    rows = [k for k0, k1 in ranges for k in range(k0, k1)]
    assert rows == list(range(d_in))  # every k row once, in split order
    assert all(k0 < k1 for k0, k1 in ranges)  # no empty split
    assert cols * SKINNY_COLS >= d_out > (cols - 1) * SKINNY_COLS if has_base else cols == 0
    # about two W blocks (shrink blocks without the base term) an SM where
    # d_in has the stages for it, in at most 16 splits
    per_split = cols if has_base else M
    KT = -(-d_in // SKINNY_KS)
    assert splits <= 16
    assert splits * per_split >= min(2 * sms, KT * per_split, 16 * per_split) // 2


def test_skinny_plan_fills_the_card_at_decode():
    """Every decode projection of qwen3-0.6b gets 256 W blocks, about two
    per SM of an H100 (132 SMs), whatever its d_out."""
    for d_in, d_out in ((1024, 2048), (1024, 1024), (2048, 1024)):
        cols, splits, _ = skinny_plan(8, d_in, d_out, True, 132)
        assert cols * splits == 256


# ------------------------------------------------------- paged_attention
def paged_emulate(q, kp, vp, tables, lengths):
    """The chunk kernel's states and the merge, in plain PyTorch. Returns
    the output and the chunks each (b, kv head) attended."""
    B, H, D = q.shape
    _, page, Hkv, _ = kp.shape
    pages = tables.shape[1]
    G, T = H // Hkv, pages * page
    nc, ct = chunk_plan(page, pages, D), chunk_tokens(D)
    gb = G if G in (1, 2, 4, 8) else 8  # heads of a block of the scores
    out = torch.zeros((B, H, D))
    seen = {}
    for bb in range(B):
        n = min(max(int(lengths[bb]), 0), T)
        for h in range(Hkv):
            states = []
            for c in range(nc):
                t0 = c * ct
                if t0 >= n:  # the block returns at once
                    continue
                toks = list(range(t0, min(t0 + ct, n)))
                seen.setdefault((bb, h), []).extend(toks)
                rows = [(int(tables[bb, t // page]), t % page) for t in toks]
                k = torch.stack([kp[p, o, h] for p, o in rows])  # (live, D)
                v = torch.stack([vp[p, o, h] for p, o in rows])
                # the scores of the heads block by block, the last one cut at G
                qg = q[bb, h * G:(h + 1) * G]
                s = torch.cat([qg[g0:g0 + gb] @ k.T for g0 in range(0, G, gb)])
                s = s / math.sqrt(D)  # (G, live)
                m = s.max(-1).values
                p = torch.exp(s - m[:, None])
                states.append((m, p.sum(-1), p @ v))
            if not states:
                continue  # a row of length 0: zeros
            mx = torch.stack([m for m, _, _ in states]).max(0).values
            L = torch.zeros(G)
            A = torch.zeros((G, D))
            for m, l, acc in states:  # live chunks in order
                f = torch.exp(m - mx)
                L = L + l * f
                A = A + acc * f[:, None]
            out[bb, h * G:(h + 1) * G] = A / torch.clamp(L, min=1e-30)[:, None]
    return out, seen


_PAGED = [
    # B, H, Hkv, D, page, pages, lens
    (4, 4, 2, 16, 16, 8, [0, 1, 64, 65]),             # a chunk boundary ± 1, empty chunks
    (3, 8, 1, 32, 128, 2, [256, 257, 127]),          # past the table (clamped), G = 8
    (5, 4, 4, 16, 8, 10, [79, 80, 81, 7, 0]),        # 8-token pages, G = 1
    (2, 8, 2, 64, 24, 6, [143, 100]),                # chunks straddle 24-token pages
    (3, 4, 1, 12, 16, 9, [144, 63, 1000]),           # D = 12, G = 4, a table of 144
    (3, 14, 2, 16, 16, 6, [0, 33, 96]),              # G = 7: heads in blocks of 8
    (2, 24, 2, 8, 8, 5, [40, 17]),                   # G = 12: two blocks, one cut
    (3, 8, 1, 256, 16, 5, [80, 31, 33]),             # D = 256: 32-token chunks, G = 8
    (2, 7, 1, 160, 32, 3, [96, 65]),                 # D = 160, G = 7
]


@pytest.mark.parametrize("B,H,Hkv,D,page,pages,lens", _PAGED)
def test_paged_chunks_match_pallas(B, H, Hkv, D, page, pages, lens):
    rng = np.random.default_rng(B * 10 + D + page)
    P = B * pages + 3
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    tables = rng.permutation(P)[: B * pages].reshape(B, pages).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    got, seen = paged_emulate(*map(torch.from_numpy, (q, kp, vp, tables, ln)))
    want = jax_paged_attention(q, kp, vp, tables, ln, interpret=True)
    plain = ref.paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, tables, ln)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    T = page * pages
    for bb, n in enumerate(lens):
        n = min(max(n, 0), T)
        for h in range(Hkv):  # every live token once, in order; none past
            assert seen.get((bb, h), []) == list(range(n))
        if n == 0:
            assert torch.equal(got[bb], torch.zeros_like(got[bb]))


@pytest.mark.parametrize("page,pages,D", [(128, 16, 128), (16, 65, 128), (8, 3, 64),
                                          (24, 5, 128), (128, 64, 128), (8, 1, 16),
                                          (128, 5, 256), (16, 65, 160), (8, 3, 256)])
def test_paged_chunk_plan_covers_every_page_once(page, pages, D):
    nc, ct = chunk_plan(page, pages, D), chunk_tokens(D)
    assert ct == (32 if D > 128 else 64)
    T = page * pages
    assert (nc - 1) * ct < T <= nc * ct
    for n in (0, 1, ct, T - 1, T):
        live = -(-n // ct)  # the chunks the merge reads
        toks = [t for c in range(live)
                for t in range(c * ct, min((c + 1) * ct, n))]
        assert toks == list(range(n))
        touched = sorted({t // page for t in toks})
        assert touched == list(range(-(-n // page)))  # each live page, none past
