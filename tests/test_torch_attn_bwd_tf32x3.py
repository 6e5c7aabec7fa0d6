"""The 3xTF32 arithmetic of the two backward kernels, emulated in numpy.

``src/repro_torch/kernels/csrc/flash_prefill_bwd.cu`` and ``lora_grad.cu``
run every product on the tensor cores with TF32 operands (10 explicit
mantissa bits): each f32 operand splits into hi = tf32(a) and lo =
tf32(a - hi), and each k8 step adds lo·hi, hi·lo and hi·hi to an f32
accumulator that rounds toward zero. These tests follow the kernels'
order:

- ``flash_prefill_bwd``'s dK/dV block (a 64-key kv tile of one kv head):
  for each head of the group and each q tile of 32 queries (16 past
  D = 160) from the tile's diagonal, S = Q·Kᵀ and dP = dO·Vᵀ with a fresh
  accumulator per 32 of D joined in f32; P = exp(S/√D - lse) and dS =
  P·(dP - Δ) in f32; dV and dK each add the q tile's Pᵀ·dO and dSᵀ·Q as a
  fresh accumulator, joined in f32; dK times 1/√D at the end. dQ is
  folded into those blocks while the partials fit their budget: each forms
  the q tile's dS·K over its 64 keys in a fresh accumulator, times 1/√D,
  and the sum kernel adds a query's partials in kv tile order. Past the
  budget dQ has a pass of its own: per staged K/V tile (64 keys, 32 past
  D = 128) each key warp of a row group adds its keys' dS·K as a fresh
  accumulator to its sum, and the key warps' sums add in order, times
  1/√D.
- ``lora_grad``: h = x·A[id] and g = dy·B[id]ᵀ each 32 rows of d a fresh
  accumulator, the shrink's parts of d (where it splits) added in order;
  dA and dB each 64 tokens a fresh accumulator, the parts of the sequence
  added in order, then times the scale; dx + scale·(g·A[id]ᵀ) per 64
  tokens. The plans come from ``sgmv.lora_grad_plan`` and
  ``flash_prefill.bwd_plan`` on a card of 132 SMs, as the wrappers pass
  them to the kernels.

Each emulation stays within a tenth of ``GRAD_TOL`` (1e-4 of the largest
gradient, ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``) of an
f64 oracle, one TF32 product in place of any one 3xTF32 product misses
``GRAD_TOL``, and at a reduced shape the whole kernels' emulation matches
``jax.grad`` of the reference's causal ``sdpa`` and of its base product
plus ``lora_delta``, called as ``tests/test_torch_train_grads.py`` calls
them. Each k8 step's products are summed exactly and rounded once toward
zero into the accumulator; Δ, a CUDA-core sum, is taken in f64 and
rounded to f32 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as jattention
from repro.models import common as jcommon
from repro_torch.kernels.flash_prefill import bwd_plan
from repro_torch.kernels.sgmv import lora_grad_plan

GRAD_TOL = 1e-4  # chip_smoke.GRAD_TOL: times max|gradient|
MARGIN = 10.0
SMS = 132  # an H100's SMs
f32 = np.float32


def tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, to nearest,
    ties away from zero, on the bits of the f32 (finite inputs). A copy of
    tests/test_torch_tf32x3.py's."""
    u = np.ascontiguousarray(a, f32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(f32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(a, f32)
    hi = tf32(a)
    return hi, tf32(a - hi)  # a - hi is exact in f32


def rz32(x: np.ndarray) -> np.ndarray:
    """f64 to f32 rounded toward zero: the tensor cores' accumulator."""
    y = x.astype(f32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, f32(0)), y).astype(f32)


def mma(a, b, passes=3):
    """a·b from a fresh accumulator: 3xTF32 (lo·hi, hi·lo, hi·hi) or one
    TF32 product (hi·hi), one k8 step at a time (K zero-padded to 8)."""
    pad = -a.shape[1] % 8
    a = np.pad(np.asarray(a, f32), ((0, 0), (0, pad)))
    b = np.pad(np.asarray(b, f32), ((0, pad), (0, 0)))
    ahi, alo = split(a)
    bhi, blo = split(b)
    terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3 else [(ahi, bhi)]
    acc = np.zeros((a.shape[0], b.shape[1]), f32)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        for pa, pb in terms:
            acc = rz32(acc.astype(np.float64)
                       + pa[:, s].astype(np.float64) @ pb[s].astype(np.float64))
    return acc


def pad_rows(a, n):
    return np.pad(a, ((0, n - len(a)),) + ((0, 0),) * (a.ndim - 1))


def d_tiles(D: int) -> int:
    """csrc/flash_prefill_bwd.cu: d_tiles."""
    return 4 if D <= 32 else 8 if D <= 64 else 16 if D <= 128 else 20 if D <= 160 else 32


PRODUCTS = ("qk", "dov", "pdo", "dsq", "dsk")  # S, dP, dV, dK, dQ


def scores(x, y, passes=3):
    """x·yᵀ over the padded head dim, each 32 of D in a fresh accumulator
    joined in f32 (QK_FLUSH)."""
    acc = np.zeros((len(x), len(y)), f32)
    for d0 in range(0, x.shape[1], 32):
        acc = (acc + mma(x[:, d0:d0 + 32], y[:, d0:d0 + 32].T, passes)).astype(f32)
    return acc


def p_ds(sc, dp, lse, delta, s, t, S, D):
    """P and dS in f32 for queries s and keys t (causal, queries < S)."""
    valid = (s < S)[:, None] & (t[None, :] <= s[:, None])
    scale = f32(1) / np.sqrt(f32(D))
    p = np.where(valid, np.exp((sc * scale).astype(f32) - lse[:, None]), f32(0)).astype(f32)
    return p, (p * (dp - delta[:, None]).astype(f32)).astype(f32)


def dkdv_block(q, k, v, do, lse, delta, k0, D, one=None):
    """One dK/dV block: keys k0 .. k0 + 63 of one kv head. q, do (G', S, DP)
    for the heads of its part, k, v (S, DP), lse, delta (G', S). ``one``
    names a product run as one TF32 product. Returns (dk·(1/√D), dv), 64
    rows (dk, dv of the part before any sum over parts)."""
    S, DP = k.shape
    bq = 16 if d_tiles(D) == 32 else 32
    ps = {n: 1 if n == one else 3 for n in PRODUCTS}
    kt, vt = pad_rows(k[k0:k0 + 64], 64), pad_rows(v[k0:k0 + 64], 64)
    dk = np.zeros((64, DP), f32)
    dv = np.zeros((64, DP), f32)
    t = k0 + np.arange(64)
    for h in range(len(q)):
        for q0 in range(k0, S, bq):
            qt, dot = pad_rows(q[h, q0:q0 + bq], bq), pad_rows(do[h, q0:q0 + bq], bq)
            s = q0 + np.arange(bq)
            ls = pad_rows(lse[h, q0:q0 + bq], bq)
            dl = pad_rows(delta[h, q0:q0 + bq], bq)
            p, ds = p_ds(scores(qt, kt, ps["qk"]), scores(dot, vt, ps["dov"]), ls, dl, s, t,
                         S, D)
            dv = (dv + mma(p.T, dot, ps["pdo"])).astype(f32)
            dk = (dk + mma(ds.T, qt, ps["dsq"])).astype(f32)
    return (dk * (f32(1) / np.sqrt(f32(D)))).astype(f32), dv


def dq_rows(q, k, v, do, lse, delta, q0, n, D, one=None):
    """dQ of queries q0 .. q0 + n - 1 of one head: q, do (S, DP), k, v
    (S, DP) of its kv head, lse, delta (S,). Each 64-key kv tile's block
    forms its dS·K for those queries at or past its first key in a fresh
    accumulator, times 1/√D; the partials add in tile order from zero."""
    S, DP = q.shape
    ps = {name: 1 if name == one else 3 for name in PRODUCTS}
    s = q0 + np.arange(n)
    qt, dot, ls, dl = q[s], do[s], lse[s], delta[s]
    dq = np.zeros((n, DP), f32)
    scale = f32(1) / np.sqrt(f32(D))
    for t0 in range(0, q0 + n, 64):
        kt, vt = pad_rows(k[t0:t0 + 64], 64), pad_rows(v[t0:t0 + 64], 64)
        t = t0 + np.arange(64)
        _, ds = p_ds(scores(qt, kt, ps["qk"]), scores(dot, vt, ps["dov"]), ls, dl, s, t,
                     S, D)
        part = (mma(ds, kt, ps["dsk"]) * scale).astype(f32)
        dq = np.where((s >= t0)[:, None], dq + part, dq).astype(f32)
    return dq


def dq_tile(D: int) -> tuple[int, int]:
    """csrc/flash_prefill_bwd.cu: DqTile, the separate dQ pass's keys of a
    staged K/V tile and keys of a warp's share (row groups of 16 queries:
    8 warps over 4 row groups, 2 past D = 160)."""
    DT = d_tiles(D)
    kb = 32 if DT > 16 else 64
    return kb, kb // (8 // (2 if DT > 20 else 4))


def dq_rows_separate(q, k, v, do, lse, delta, q0, n, D, one=None):
    """dQ of queries q0 .. q0 + n - 1 of one head by the separate pass: q,
    do (S, DP), k, v (S, DP), lse, delta (S,). Per staged K/V tile each key
    warp adds its keys' dS·K to its own sum as a fresh accumulator; the key
    warps' sums add in order, times 1/√D."""
    S, DP = q.shape
    ps = {name: 1 if name == one else 3 for name in PRODUCTS}
    kb, kw = dq_tile(D)
    s = q0 + np.arange(n)
    qt, dot, ls, dl = q[s], do[s], lse[s], delta[s]
    sums = np.zeros((kb // kw, n, DP), f32)
    for t0 in range(0, q0 + n, kb):
        kt, vt = pad_rows(k[t0:t0 + kb], kb), pad_rows(v[t0:t0 + kb], kb)
        _, ds = p_ds(scores(qt, kt, ps["qk"]), scores(dot, vt, ps["dov"]), ls, dl, s,
                     t0 + np.arange(kb), S, D)
        for w in range(kb // kw):
            keys = slice(w * kw, (w + 1) * kw)
            sums[w] = (sums[w] + mma(ds[:, keys], kt[keys], ps["dsk"])).astype(f32)
    dq = sums[0]
    for w in range(1, kb // kw):
        dq = (dq + sums[w]).astype(f32)
    return (dq * (f32(1) / np.sqrt(f32(D)))).astype(f32)


def forward64(q, k, v):
    """The f64 forward of one group: q (G, S, D), k, v (S, D) -> o, lse."""
    S, D = k.shape
    sc = q.astype(np.float64) @ k.T.astype(np.float64) / np.sqrt(D)
    sc = np.where(np.tril(np.ones((S, S), bool)), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    w = np.exp(sc - m)
    lse = (m + np.log(w.sum(-1, keepdims=True)))[..., 0]
    return (w / w.sum(-1, keepdims=True)) @ v.astype(np.float64), lse


def backward64(q, k, v, do):
    """The f64 oracle of one group: q, do (G, S, D), k, v (S, D)."""
    S, D = k.shape
    q, k, v, do = (a.astype(np.float64) for a in (q, k, v, do))
    o, lse = forward64(q, k, v)
    sc = q @ k.T / np.sqrt(D)
    p = np.where(np.tril(np.ones((S, S), bool)), np.exp(sc - lse[..., None]), 0.0)
    ds = p * (do @ v.T - (do * o).sum(-1, keepdims=True))
    dq = ds @ k / np.sqrt(D)
    dk = np.einsum("gst,gsd->td", ds, q) / np.sqrt(D)
    dv = np.einsum("gst,gsd->td", p, do)
    return dq, dk, dv, o, lse


def group_case(G, D, S, seed):
    """One kv group: q, do (G, S, D), k, v (S, D) standard normal, and the
    forward's o and lse, Δ, as f32 (the kernels' inputs) with the f64
    oracle's gradients."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((G, S, D), f32) for _ in range(2))
    k, v = (rng.standard_normal((S, D), f32) for _ in range(2))
    dq, dk, dv, o, lse = backward64(q, k, v, do)
    delta = (do.astype(np.float64) * o.astype(f32)).sum(-1).astype(f32)
    DP = 8 * d_tiles(D)
    padd = lambda a: np.pad(a, ((0, 0),) * (a.ndim - 1) + ((0, DP - D),))  # noqa: E731
    ins = (padd(q), padd(k), padd(v), padd(do), lse.astype(f32), delta)
    return ins, (dq, dk, dv)


def err(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.fixture(scope="module")
def qwen3_row():
    """qwen3-0.6b's heads (G = 2, D = 128) over a 512-token row."""
    return group_case(2, 128, 512, seed=0)


@pytest.fixture(scope="module")
def wide_row():
    """stablelm-12b's D = 160 at G = 4 over a 160-token row."""
    return group_case(4, 160, 160, seed=1)


def _check_dkdv(ins, want, D, one=None):
    q, k, v, do, lse, delta = ins
    dk, dv = dkdv_block(q, k, v, do, lse, delta, 0, D, one)
    return err(dk[:, :D], want[1][:64]), err(dv[:, :D], want[2][:64])


def _check_dq(ins, want, D, h, q0, one=None, rows=dq_rows):
    q, k, v, do, lse, delta = ins
    n = min(64, len(k) - q0)
    got = rows(q[h], k, v, do[h], lse[h], delta[h], q0, n, D, one)
    return err(got[:, :D], want[0][h, q0:q0 + n])


def test_qwen3_blocks_keep_the_tolerance_with_margin(qwen3_row):
    """The dK/dV block of keys 0..63 (both heads, 16 q tiles each: the most
    work of any block) and the dQ of the last 64 queries of head 1 (the
    partials of all 8 kv tiles' blocks and their sum) stay within a tenth of
    GRAD_TOL of the oracle."""
    ins, want = qwen3_row
    assert max(_check_dkdv(ins, want, 128)) * MARGIN <= GRAD_TOL
    assert _check_dq(ins, want, 128, 1, 448) * MARGIN <= GRAD_TOL


def test_wide_head_blocks_keep_the_tolerance_with_margin(wide_row):
    """D = 160: 20 d-tiles, 5 for each of the four warps that share 32 keys
    of dK and dV and of the four that share a q row of dS·K."""
    ins, want = wide_row
    assert max(_check_dkdv(ins, want, 160)) * MARGIN <= GRAD_TOL
    assert _check_dq(ins, want, 160, 3, 64) * MARGIN <= GRAD_TOL


@pytest.mark.parametrize("row,D,h,q0", [("qwen3_row", 128, 1, 448), ("wide_row", 160, 3, 64)])
def test_separate_dq_keeps_the_tolerance_with_margin(request, row, D, h, q0):
    """The separate dQ pass (past the fold's budget): the last 64 queries of
    qwen3's head 1 (8 K/V tiles of 64 keys, two key warps of 32) and 64
    queries of D = 160 (K/V tiles of 32, two key warps of 16) stay within a
    tenth of GRAD_TOL of the oracle."""
    ins, want = request.getfixturevalue(row)
    assert _check_dq(ins, want, D, h, q0, rows=dq_rows_separate) * MARGIN <= GRAD_TOL


@pytest.mark.parametrize("product", ("qk", "dov", "dsk"))
def test_separate_dq_one_tf32_product_misses_the_tolerance(qwen3_row, product):
    """The separate pass's three products each pay three: one TF32 product
    for S, dP or dS·K makes its dQ miss GRAD_TOL."""
    ins, want = qwen3_row
    e = _check_dq(ins, want, 128, 1, 448, product, rows=dq_rows_separate)
    assert e > GRAD_TOL, e


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_misses_the_tolerance(qwen3_row, product):
    """Why each product pays three: one TF32 product for S, dP, dV or dK
    makes the dK/dV block miss GRAD_TOL, and for S, dP or dS·K the dQ."""
    ins, want = qwen3_row
    errs = list(_check_dkdv(ins, want, 128, product))
    if product in ("qk", "dov", "dsk"):
        errs.append(_check_dq(ins, want, 128, 1, 448, product))
    assert max(errs) > GRAD_TOL, errs


def emulate_flash_bwd(q, k, v, do, o, lse, fold=None):
    """flash_prefill_bwd.cu over every block: q, do, o (B, H, S, D), k, v
    (B, Hkv, S, D), lse (B, H, S), all f32. ``fold`` overrides the plan's
    choice of the dQ design. Returns (dq, dk, dv)."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    DP = 8 * d_tiles(D)
    padd = lambda a: np.pad(a, ((0, 0),) * (a.ndim - 1) + ((0, DP - D),))  # noqa: E731
    delta = (do.astype(np.float64) * o).sum(-1).astype(f32)
    qp, kp, vp, dop = padd(q), padd(k), padd(v), padd(do)
    hs, planned = bwd_plan(B, S, H, Hkv, D, SMS)
    rows = dq_rows if (planned if fold is None else fold) else dq_rows_separate
    dq = np.zeros((B, H, S, DP), f32)
    dk = np.zeros((B, Hkv, S, DP), f32)
    dv = np.zeros((B, Hkv, S, DP), f32)
    for b in range(B):
        for hkv in range(Hkv):
            hq = slice(hkv * G, (hkv + 1) * G)
            for k0 in range(0, S, 64):
                n = min(64, S - k0)
                for hp in range(hs):  # the parts' sums, added in order
                    heads = slice(hkv * G + hp * G // hs, hkv * G + (hp + 1) * G // hs)
                    pk, pv = dkdv_block(qp[b, heads], kp[b, hkv], vp[b, hkv], dop[b, heads],
                                        lse[b, heads], delta[b, heads], k0, D)
                    dk[b, hkv, k0:k0 + n] = (dk[b, hkv, k0:k0 + n] + pk[:n]).astype(f32)
                    dv[b, hkv, k0:k0 + n] = (dv[b, hkv, k0:k0 + n] + pv[:n]).astype(f32)
            for h in range(hq.start, hq.stop):
                dq[b, h] = rows(qp[b, h], kp[b, hkv], vp[b, hkv], dop[b, h], lse[b, h],
                                delta[b, h], 0, S, D)
    return dq[..., :D], dk[..., :D], dv[..., :D]


def _jax_case(B, H, Hkv, S, D):
    """Numpy inputs, the forward's o and lse, and ``jax.vjp`` of the
    reference's causal ``sdpa`` on head-major inputs: (q, k, v, do, o,
    lse), (dq, dk, dv)."""
    rng = np.random.default_rng(2)
    q, do = (rng.standard_normal((B, H, S, D), f32) for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, S, D), f32) for _ in range(2))

    def jfun(q, k, v):
        pos = jnp.arange(S)[None, :]
        out = jattention.sdpa(*(t.transpose(0, 2, 1, 3) for t in (q, k, v)),
                              jcommon.causal_mask(pos, pos))
        return out.transpose(0, 2, 1, 3)

    o, vjp = jax.vjp(jfun, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    o = np.asarray(o)
    sc = np.einsum("bkgsd,bktd->bkgst", q.reshape(B, Hkv, -1, S, D).astype(np.float64),
                   k.astype(np.float64)) / np.sqrt(D)
    sc = np.where(np.tril(np.ones((S, S), bool)), sc, -np.inf)
    lse = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + sc.max(-1)
    return (q, k, v, do, o, lse.reshape(B, H, S).astype(f32)), [np.asarray(w) for w in want]


@pytest.mark.parametrize("B,H,Hkv,S,D", [(2, 4, 2, 70, 20), (1, 6, 2, 40, 160)])
def test_emulated_flash_bwd_matches_jax_grad(B, H, Hkv, S, D):
    """Every block of the kernel (head parts included: these shapes split
    the heads of a group; dQ folded, as the plan has it) against
    ``jax.vjp`` of the reference's causal ``sdpa`` on head-major inputs,
    from the same numpy inputs."""
    hs, fold = bwd_plan(B, S, H, Hkv, D, SMS)
    assert hs > 1 and fold
    ins, want = _jax_case(B, H, Hkv, S, D)
    for g, w in zip(emulate_flash_bwd(*ins), want):
        assert err(g, w) <= GRAD_TOL / MARGIN


@pytest.mark.parametrize("B,H,Hkv,S,D", [(1, 4, 2, 100, 128), (1, 4, 1, 70, 256)])
def test_emulated_separate_dq_matches_jax_grad(B, H, Hkv, S, D):
    """The separate dQ pass, as past the fold's budget, against ``jax.vjp``
    of the reference's causal ``sdpa``: at D = 128 (K/V tiles of 64, two
    key warps) and D = 256 (tiles of 32, four key warps of 8 keys)."""
    ins, want = _jax_case(B, H, Hkv, S, D)
    got = emulate_flash_bwd(*ins, fold=False)
    for g, w in zip(got, want):
        assert err(g, w) <= GRAD_TOL / MARGIN


# ---------------------------------------------------------------- lora_grad
LORA_PRODUCTS = ("h", "g", "da", "db", "dx")


def emulate_lora_grad(x, dy, a, b, ids, scale, dx, one=None):
    """lora_grad.cu: x (B, S, d_in), dy (B, S, d_out), a (N, d_in, r), b
    (N, r, d_out), ids (B,); dx (B, S, d_in) is added into (a copy is
    returned). ``one`` names a product run as one TF32 product. Returns
    (da, db, dx)."""
    B, S, d_in = x.shape
    N, _, r = a.shape
    d_out = b.shape[2]
    ps = {n: 1 if n == one else 3 for n in LORA_PRODUCTS}
    r8, (ks_h, kper_h), (ks_g, kper_g), (ms, sper), _ = lora_grad_plan(
        B, S, N, d_in, d_out, r, SMS)
    pad_r = lambda m: np.pad(m, ((0, 0), (0, r8 - r)))  # noqa: E731
    h = np.zeros((B, S, r8), f32)
    g = np.zeros((B, S, r8), f32)
    for bi in range(B):
        if ids[bi] < 0:
            continue
        for out, src, w, ks, kper, name in (
                (h, x[bi], pad_r(a[ids[bi]]), ks_h, kper_h, "h"),
                (g, dy[bi], pad_r(b[ids[bi]].T), ks_g, kper_g, "g")):
            total = np.zeros((S, r8), f32)
            for part in range(ks):
                acc = np.zeros((S, r8), f32)
                for k0 in range(part * kper, min(len(w), (part + 1) * kper), 32):
                    k1 = min(k0 + 32, (part + 1) * kper, len(w))
                    acc = (acc + mma(src[:, k0:k1], w[k0:k1], ps[name])).astype(f32)
                total = (total + acc).astype(f32)  # the outer kernel's staged sum
            out[bi] = total
    da_parts = np.zeros((ms, N, d_in, r8), f32)
    db_parts = np.zeros((ms, N, d_out, r8), f32)
    dx = dx.copy()
    for n in range(N):
        for part in range(ms):
            s_lo, s_hi = part * sper, min(S, (part + 1) * sper)
            for bi in range(B):
                if ids[bi] != n:
                    continue
                for t0 in range(s_lo, s_hi, 64):
                    t1 = min(t0 + 64, s_hi)
                    da_parts[part, n] = (da_parts[part, n] + mma(
                        x[bi, t0:t1].T, g[bi, t0:t1], ps["da"])).astype(f32)
                    db_parts[part, n] = (db_parts[part, n] + mma(
                        dy[bi, t0:t1].T, h[bi, t0:t1], ps["db"])).astype(f32)
                    delta = mma(g[bi, t0:t1], pad_r(a[n]).T, ps["dx"])
                    dx[bi, t0:t1] = (dx[bi, t0:t1] + (f32(scale) * delta).astype(f32)
                                     ).astype(f32)
    da, db = da_parts[0], db_parts[0]
    if ms > 1:  # lora_grad_sum_kernel: the parts in order from zero
        da, db = np.zeros_like(da), np.zeros_like(db)
        for part in range(ms):
            da = (da + da_parts[part]).astype(f32)
            db = (db + db_parts[part]).astype(f32)
    da = (da * f32(scale)).astype(f32)[..., :r]
    db = (db * f32(scale)).astype(f32)[..., :r].transpose(0, 2, 1)
    return da, db, dx


def lora64(x, dy, a, b, ids, scale):
    """The f64 oracle: (da, db, dx delta)."""
    x, dy, a, b = (t.astype(np.float64) for t in (x, dy, a, b))
    da, db, delta = np.zeros_like(a), np.zeros_like(b), np.zeros_like(x)
    for bi, n in enumerate(ids):
        if n < 0:
            continue
        h, g = x[bi] @ a[n], dy[bi] @ b[n].T
        da[n] += scale * x[bi].T @ g
        db[n] += scale * h.T @ dy[bi]
        delta[bi] = scale * g @ a[n].T
    return da, db, delta


@pytest.fixture(scope="module")
def lora_q():
    """qwen3-0.6b's q projection (1024 -> 2048, rank 32): 3 batch rows of
    512 tokens, all of id 0 (the shrink splits d_in in 4 parts and d_out
    in 8, the outer products the sequence in 6), scale 2.0, inputs drawn as
    chip_smoke's lora_grad_case draws them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 512, 1024), f32)
    dy = rng.standard_normal((3, 512, 2048), f32)
    a = (rng.standard_normal((1, 1024, 32)) / 32).astype(f32)
    b = (rng.standard_normal((1, 32, 2048)) * 0.1).astype(f32)
    ids = np.zeros(3, np.int64)
    base = rng.standard_normal(x.shape, f32)
    return (x, dy, a, b, ids, 2.0, base), lora64(x, dy, a, b, ids, 2.0)


def _lora_errs(case, want, one=None):
    x, dy, a, b, ids, scale, base = case
    da, db, dx = emulate_lora_grad(x, dy, a, b, ids, scale, base, one)
    return {"da": err(da, want[0]), "db": err(db, want[1]),
            "dx": err(dx - base, want[2])}


def test_lora_grad_keeps_the_tolerance_with_margin(lora_q):
    case, want = lora_q
    plan = lora_grad_plan(3, 512, 1, 1024, 2048, 32, SMS)
    assert plan[1][0] > 1 and plan[2][0] > 1 and plan[3][0] > 1  # every split
    errs = _lora_errs(case, want)
    assert max(errs.values()) * MARGIN <= GRAD_TOL, errs


@pytest.mark.parametrize("product", LORA_PRODUCTS)
def test_lora_grad_one_tf32_product_misses_the_tolerance(lora_q, product):
    case, want = lora_q
    errs = _lora_errs(case, want, product)
    assert max(errs.values()) > GRAD_TOL, errs


@pytest.mark.parametrize("ids", [[1, -1, 1], [-1, -1, 0], [0, 2, 1]])
def test_emulated_lora_grad_matches_jax_grad(ids):
    """The whole kernel at a reduced shape that splits both reductions
    (d_in in 2 parts, the sequence in 3) against ``jax.vjp`` of the
    reference's base product plus ``lora_delta``; an adapter with no row
    gets exact zeros."""
    rng = np.random.default_rng(4)
    B, S, d_in, d_out, r, N = 3, 200, 600, 136, 12, 3
    x, dy = rng.standard_normal((B, S, d_in), f32), rng.standard_normal((B, S, d_out), f32)
    w = (rng.standard_normal((d_in, d_out)) * 0.03).astype(f32)
    a = (rng.standard_normal((N, d_in, r)) * 0.05).astype(f32)
    b = (rng.standard_normal((N, r, d_out)) * 0.05).astype(f32)
    ids = np.asarray(ids, np.int32)
    plan = lora_grad_plan(B, S, N, d_in, d_out, r, SMS)
    assert plan[1][0] == 2 and plan[3][0] == 3

    def jfun(x, w, a, b):
        return x @ w + jcommon.lora_delta(x, a, b, jnp.asarray(ids), 0.5)

    _, vjp = jax.vjp(jfun, *map(jnp.asarray, (x, w, a, b)))
    jx, _, ja, jb = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    base = (dy.astype(np.float64) @ w.T.astype(np.float64)).astype(f32)  # dy·Wᵀ
    da, db, dx = emulate_lora_grad(x, dy, a, b, ids, 0.5, base)
    for got, want in ((da, ja), (db, jb), (dx, jx)):
        assert err(got, want) <= GRAD_TOL / MARGIN
    for n in range(N):
        if n not in ids:
            assert not da[n].any() and not db[n].any()
