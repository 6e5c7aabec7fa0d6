"""The bf16 decode loop of ``fused_sgmv`` on thread-block clusters, emulated
in numpy.

``src/repro_torch/kernels/csrc/fused_sgmv_cluster.cu`` runs bf16
``fused_sgmv`` where ``sgmv.bf16_path`` says "cluster" (M = B·S <= 16 rows,
d_in and d_out multiples of 8, 16-byte bases) in one launch, split as
``sgmv.cluster_plan`` (the mirror of the source's ``make_plan``) says:

1. The shrink, one cluster of cs blocks per live id (the first batch row
   that carries it): block z takes k rows ``k_ranges[z]`` of x and A[id] in
   stages (128 rows at r <= 32, else 64). At a rank r % 8 == 0, two
   m16n8k16 chains over them (the even and the odd k16 steps, as x·W below),
   added, give block z's part of h for the id's rows. At any other rank its thread (rank rho, row, k lane l) adds x[row,
   k]·A[k, rho] for the stage rows k = l, l + KL, .. in stage order, f32
   FMA of exact bf16 products (KL = min(256 / (RP·NRP), 32), RP and NRP the
   rank and the id's rows rounded up to powers of two; 1 where RP·NRP >
   256); the lanes meet by a butterfly (pairs at distance 1, 2, 4, ..) into
   block z's part of h, and a W block reads h = scale·(the parts added in
   rank order).
2. Each W slab of 128 columns, one cluster of cs blocks: block z adds
   x[:, k_z]·W[k_z, slab] over stages of 64 rows, m16n8k16 steps (each
   step's 16 products summed exactly, added to the f32 accumulator
   rounding toward zero; rows past the block's k are zeros).
3. Block z owns units [z·U/cs, (z + 1)·U/cs) of the slab's U = M·32
   outputs of 4 columns. For each, the blocks' accumulators are added in
   rank order; where the row carries a live id, the expand joins them: 8
   lanes, lane l adding h[row, k]·B[id][k, n] for k = l, l + 8, .. in f32
   FMA, met by a butterfly (pairs at distance 1, 2, 4). y = bf16 of that,
   rounded once.

Columns never interact, so the emulation takes every slab at once. It is
held against the reference's Pallas kernel in interpret mode at the
reference's bf16 tolerance, and against the port's plain f32 version within
one bf16 rounding plus ``SGMV_TOL`` of max and 2^-16 of max, the bar
``chip_smoke.py`` holds the kernel to on the card. The plan tests check
the mirror against the source's constants and the limits the launch needs.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_sgmv as jax_fused_sgmv
from repro_torch.kernels import ref
from test_torch_sgmv_wgmma import BF16_SPLIT_REL, SGMV_TOL, TOL, bf16, chain, one_rounding_excess

sg = importlib.import_module("repro_torch.kernels.sgmv")

F32 = np.float32
SOURCE = Path(sg.__file__).parent / "csrc" / "fused_sgmv_cluster.cu"
THREADS = 256
UNITS = 32  # output units (4 columns) of a slab row
KL = 8  # lanes of a unit in the expand's sum over ranks
H100_SMS = 132


def h100_capacity(cs):
    """Clusters of cs blocks an H100 holds at once, modeled: three blocks an
    SM (the kernel's launch bounds) in 8 GPCs of 16 or 18 SMs, a cluster
    inside one GPC."""
    gpcs = [18, 18, 16, 16, 16, 16, 16, 16]
    return sum(3 * n // cs for n in gpcs)


def _leads(ids):
    return [int(i) for p, i in enumerate(ids) if i >= 0 and int(i) not in [int(j) for j in ids[:p]]]


def shrink(xf, a, ids, S, scale, plan):
    """Pass 1: h (M, r) for the rows of live ids (NaN elsewhere: never read)."""
    M, r = xf.shape[0], a.shape[2]
    rp = 1
    while rp < r:
        rp *= 2
    h = np.full((M, r), np.nan, F32)
    row_ids = np.repeat(ids, S)
    for i in _leads(ids):
        rows = np.flatnonzero(row_ids == i)
        if r % 8 == 0:  # the tensor cores: two k16 chains (even, odd steps), added
            parts = []
            for k0, k1 in plan["k_ranges"]:
                p = [np.zeros((len(rows), r), F32), np.zeros((len(rows), r), F32)]
                for n, s0 in enumerate(range(k0, k1, 16)):
                    p[n % 2] = chain(p[n % 2], xf[rows, s0:min(s0 + 16, k1)],
                                     a[i, s0:min(s0 + 16, k1)])
                parts.append((p[0] + p[1]).astype(F32))
            v = parts[0]
            for p in parts[1:]:
                v = (v + p).astype(F32)
            h[rows] = (F32(scale) * v).astype(F32)
            continue
        nrp = 1
        while nrp < len(rows):
            nrp *= 2
        # k lanes of a (row, rank), a butterfly of shuffles at the end
        kl = min(THREADS // (rp * nrp), 32) if rp * nrp <= THREADS else 1
        ksr = 2 * sg.CLUSTER_KS if r <= 32 else sg.CLUSTER_KS  # rows of a shrink stage
        parts = []
        for k0, k1 in plan["k_ranges"]:
            lanes = np.zeros((kl, len(rows), r), F32)
            for kb in range(k0, k1, ksr):
                kn = min(ksr, k1 - kb)
                for kk in range(kn):
                    l = kk % kl
                    lanes[l] = (lanes[l] + xf[rows, kb + kk][:, None] * a[i, kb + kk][None, :]).astype(F32)
            off = 1
            while off < kl:
                lanes = (lanes + lanes[np.arange(kl) ^ off]).astype(F32)
                off *= 2
            parts.append(lanes[0])
        v = parts[0]
        for p in parts[1:]:
            v = (v + p).astype(F32)
        h[rows] = (F32(scale) * v).astype(F32)
    return h


def expand(h, b, ids, S, d_out):
    """Step 3's delta (M, d_out): the 8 lanes of each output over the ranks
    in f32 FMA (the product exact in float64, one rounding a step), met by
    a butterfly; zeros on rows of id -1."""
    M, r = h.shape
    row_ids = np.repeat(ids, S)
    delta = np.zeros((M, d_out), F32)
    for m in np.flatnonzero(row_ids >= 0):
        lanes = np.zeros((KL, d_out), F32)
        for k in range(r):
            lanes[k % KL] = (lanes[k % KL].astype(np.float64)
                             + np.float64(h[m, k]) * b[row_ids[m], k].astype(np.float64)).astype(F32)
        off = 1
        while off < KL:
            lanes = (lanes + lanes[np.arange(KL) ^ off]).astype(F32)
            off *= 2
        delta[m] = lanes[0]
    return delta


def emulate(x, w, a, b, ids, S, scale, plan, writes=None):
    """fused_sgmv_cluster.cu on bf16 values as f32 arrays, split by
    ``plan``: y (B, S, d_out) as bf16 values. ``writes`` (a dict) counts
    each block's k rows and the output units of its share."""
    Bn, _, d_in = x.shape
    d_out = w.shape[1]
    M = Bn * S
    xf = x.reshape(M, d_in)
    h = shrink(xf, a, ids, S, scale, plan)
    cs = plan["cs"]
    y = None
    for z, (k0, k1) in enumerate(plan["k_ranges"]):
        acc = np.zeros((M, d_out), F32)
        for kb in range(k0, k1, sg.CLUSTER_KS):
            for s0 in range(kb, kb + sg.CLUSTER_KS, 16):  # k16 steps, zeros past k1
                s1 = min(s0 + 16, k1)
                if s0 < s1:
                    acc = chain(acc, xf[:, s0:s1], w[s0:s1])
                    if writes is not None:
                        for k in range(s0, s1):
                            writes[("k", k)] = writes.get(("k", k), 0) + 1
        if writes is not None:  # the units block z merges (the same in every slab)
            U = M * UNITS
            for u in range(z * U // cs, (z + 1) * U // cs):
                writes[("u", u)] = writes.get(("u", u), 0) + 1
        y = acc if y is None else (y + acc).astype(F32)
    live = np.repeat(ids, S) >= 0
    y[live] = (y[live] + expand(h, b, ids, S, d_out)[live]).astype(F32)
    return bf16(y).reshape(Bn, S, d_out)


def _inputs(B, S, d_in, d_out, r, N, ids, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d_in), F32)
    w = rng.standard_normal((d_in, d_out), F32) * d_in ** -0.5
    a = rng.standard_normal((N, d_in, r), F32) * d_in ** -0.5
    b = rng.standard_normal((N, r, d_out), F32) * 0.1
    return (*(bf16(t) for t in (x, w, a, b)), np.asarray(ids, np.int32))


def _plan(B, S, d_in, d_out, cs=None):
    """The plan an H100 takes (the modeled capacity), or one of ``cs``."""
    if cs is None:
        return sg.cluster_plan(B * S, S, d_in, d_out, H100_SMS, h100_capacity)
    return sg.cluster_plan(B * S, S, d_in, d_out, H100_SMS, lambda c: 10 ** 6 if c <= cs else 0)


_CASES = [
    # B, S, d_in, d_out, r, N, ids, scale, cs (None: the H100's plan)
    (1, 1, 1024, 2048, 32, 4, [2], 1.0, None),                     # M = 1
    (2, 1, 2048, 576, 32, 3, [1, -1], 0.5, None),                   # M = 2, deepseek kv_a 576
    (8, 1, 1024, 2048, 32, 8, [-1, 0, 1, 2, 3, 4, 5, 7], 1.0, None),  # qwen3-0.6b q, 7 live ids
    (8, 1, 1024, 1024, 1, 8, [-1, 0, 1, 2, 3, 4, 5, 7], 2.0, None),  # rank 1
    (8, 1, 512, 384, 128, 8, [3, 0, -1, 1, 6, 2, 5, 4], 1.0, 4),    # rank 128, 4 blocks
    (16, 1, 512, 256, 32, 8, [0, 1, 1, -1, 2, 0, 3, 3, 4, 5, 6, 7, 7, -1, 2, 1], 1.0, None),  # M = 16, repeats
    (2, 1, 2560, 256, 32, 4, [0, 0], 1.0, None),                   # recurrentgemma k: 2 slabs, one id
    (2, 8, 512, 256, 16, 3, [1, -1], 0.25, 8),                      # S = 8: 16 rows
    (4, 4, 256, 320, 12, 3, [2, 0, 2, -1], 1.5, 1),                 # rank 12, S = 4, one block
    (4, 1, 256, 136, 32, 3, [-1, -1, -1, -1], 1.0, 16),             # every id -1, a 8-column slab
    (1, 16, 256, 256, 32, 2, [1], 1.0, 4),      # 16 rows of one id: more than a rank's 8 slots
    (2, 4, 256, 128, 128, 3, [2, 2], 0.5, 2),   # rank 128 (2 slots), 8 rows of one id
]


@pytest.mark.parametrize("B,S,d_in,d_out,r,N,ids,scale,cs", _CASES)
def test_cluster_loop_matches_pallas_and_one_rounding_of_f32(B, S, d_in, d_out, r, N, ids,
                                                             scale, cs):
    x, w, a, b, idv = _inputs(B, S, d_in, d_out, r, N, ids, seed=d_in + d_out + r)
    plan = _plan(B, S, d_in, d_out, cs)
    writes = {}
    got = emulate(x, w, a, b, idv, S, scale, plan, writes)
    # every k row once a block's range, every output unit once a share
    assert all(writes[("k", k)] == 1 for k in range(d_in))
    assert sorted(k[1] for k in writes if k[0] == "u") == list(range(B * S * UNITS))
    jx, jw, ja, jb = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, w, a, b))
    want = np.asarray(jax_fused_sgmv(jx, jw, ja, jb, idv, scale=scale, block_s=min(S, 16),
                                     block_o=128, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())
    t = [torch.from_numpy(v) for v in (x, w, a, b)]
    plain = ref.fused_sgmv_ref(*(v.to(torch.bfloat16) for v in t), torch.from_numpy(idv), scale)
    want32 = ref.fused_sgmv_ref(*t, torch.from_numpy(idv), scale).numpy()
    atol = SGMV_TOL * float(plain.float().abs().max()) + BF16_SPLIT_REL * float(np.abs(want32).max())
    assert one_rounding_excess(got, want32, atol) <= 0


@pytest.mark.parametrize("ids,cs", [([-1, 2, 0, 2], 4), ([1, -1, -1, 1], 16), ([-1, 0, 1, 2], 1)])
def test_rows_of_id_minus_one_are_the_base_product_bit_for_bit(ids, cs):
    """A row of id -1 gets nothing from the expand and its x·W sums run in
    the same order whatever the other ids: it equals the launch with every
    id -1, bit for bit."""
    x, w, a, b, idv = _inputs(4, 1, 512, 256, 16, 3, ids, seed=5)
    plan = _plan(4, 1, 512, 256, cs)
    got = emulate(x, w, a, b, idv, 1, 1.5, plan)
    base = emulate(x, w, a, b, np.full(4, -1, np.int32), 1, 1.5, plan)
    dead = idv < 0
    assert np.array_equal(got[dead], base[dead])


# ------------------------------------------------------------------ the plan
def _source_constants():
    text = SOURCE.read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_plan_mirrors_the_source():
    """sgmv.py's geometry is the source's, and the source's shared memory
    (static: the ring and the small arrays) leaves room for the three blocks
    an SM of its launch bounds inside the H100's 48 KB of static shared
    memory a block and 228 KB an SM."""
    c = _source_constants()
    assert (c["CN"], c["KS"], c["MAX_CS"], c["MAX_M"], c["THREADS"]) == (
        sg.CLUSTER_COLS, sg.CLUSTER_KS, sg.CLUSTER_MAX_CS, sg.SKINNY_MAX_M, THREADS)
    assert c["MAX_R"] == sg.MAX_RANK and c["KL"] == KL
    text = SOURCE.read_text()
    assert "WP = CN + 8;" in text and "XP = KS + 8;" in text and "UR = CN / 4;" in text
    assert UNITS == sg.CLUSTER_COLS // 4
    ring = 2 * c["STAGES"] * (c["KS"] * (c["CN"] + 8) + c["MAX_M"] * (c["KS"] + 8))
    # the ring, and the ids, each row's index among the live ids, a
    # shrink's rows, its count of them and the leads' mask
    smem = ring + 4 * (3 * c["MAX_M"] + 2)
    assert smem <= 48 * 1024 and 3 * (smem + 1024) <= 228 * 1024
    # after the stream the ring holds a W block's f32 partial, h's rows and
    # the deltas of its units (all of a slab's at cs = 1)
    assert 4 * c["MAX_M"] * (c["CN"] + 8 + c["MAX_R"]) + 16 * c["MAX_M"] * UNITS <= ring
    assert "__launch_bounds__(THREADS, 3)" in text


@pytest.mark.parametrize("M,S,d_in,d_out", [
    (8, 1, 1024, 2048), (8, 1, 1024, 1024), (8, 1, 2048, 1024),  # qwen3-0.6b q, k, o
    (2, 1, 4096, 4096), (2, 1, 2048, 3072), (2, 1, 2048, 576),   # llama-7b q; deepseek q, kv_a
    (2, 1, 2048, 2048), (2, 1, 2560, 2560), (2, 1, 2560, 256),   # rwkv6 r; recurrentgemma q, k
    (2, 1, 1024, 1024), (16, 1, 1024, 2048), (16, 1, 2048, 576),  # seamless q; 16 rows
    (1, 1, 64, 8), (16, 16, 8, 4096), (4, 2, 136, 1000),
])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_covers_every_row_and_column_once_and_stays_co_resident(M, S, d_in, d_out, sms):
    d_out = -(-d_out // 8) * 8
    capacity = h100_capacity if sms == 132 else (lambda cs: 3 * sms // cs)
    plan = sg.cluster_plan(M, S, d_in, d_out, sms, capacity)
    cs, cols, nb = plan["cs"], plan["cols"], plan["nb"]
    assert cs in (1, 2, 4, 8, 16) and nb == M // S
    assert (cols - 1) * sg.CLUSTER_COLS < d_out <= cols * sg.CLUSTER_COLS
    ks = plan["k_ranges"]
    assert len(ks) == cs and ks[0][0] == 0 and ks[-1][1] == d_in
    assert all(k0 < k1 and k0 % 8 == 0 and k1 % 8 == 0 for k0, k1 in ks)
    assert all(ks[i][1] == ks[i + 1][0] for i in range(cs - 1))
    # the whole grid co-resident, about two W blocks an SM at most
    assert cols + nb <= capacity(cs) and plan["blocks"] == (cols + nb) * cs
    assert cs == 1 or cols * cs <= 2 * sms
    # the largest size that does: twice as large breaks a limit
    big = 2 * cs
    assert big > sg.CLUSTER_MAX_CS or cols * big > 2 * sms or 8 * big > d_in \
        or cols + nb > capacity(big)


def test_plan_is_none_where_no_cluster_size_fits():
    assert sg.cluster_plan(16, 1, 1024, 2048, 132, lambda cs: 10) is None


# the cluster sizes the H100's plans take at phase 9's decode shapes
@pytest.mark.parametrize("d_in,d_out,M,cs", [
    (1024, 2048, 8, 16), (1024, 1024, 8, 16), (2048, 1024, 8, 16), (4096, 4096, 2, 8),
    (2560, 2560, 2, 8), (2560, 256, 2, 16), (2048, 576, 2, 16),
])
def test_plan_at_the_decode_shapes(d_in, d_out, M, cs):
    assert sg.cluster_plan(M, 1, d_in, d_out, H100_SMS, h100_capacity)["cs"] == cs


@pytest.mark.parametrize("M,r", [(2, 32), (16, 128)])
def test_scratch_of_h_is_the_streams_outside_a_capture_and_the_launchs_inside(monkeypatch, M, r):
    """Outside a graph capture a launch takes its device and stream's scratch
    (zeros when made, the same tensor at every launch: no memset, no
    allocation); inside one, zeros of its own for cs·M·r words, so a graph's
    replay shares no scratch with a launch beside it."""
    monkeypatch.setattr(sg, "_cluster_h", {})
    dev = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    h = sg.cluster_h(dev, 7, M, r)
    assert h.dtype == torch.int64 and not h.any()
    assert h.numel() == sg.CLUSTER_MAX_CS * sg.SKINNY_MAX_M * sg.MAX_RANK
    assert sg.cluster_h(dev, 7, M, r) is h and sg.cluster_h(dev, 8, M, r) is not h
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    g1, g2 = sg.cluster_h(dev, 7, M, r), sg.cluster_h(dev, 7, M, r)
    assert g1.numel() == g2.numel() == sg.CLUSTER_MAX_CS * M * r
    assert g1.data_ptr() != g2.data_ptr() and g1.data_ptr() != h.data_ptr()
    assert not g1.any() and not g2.any()
