"""The 3xTF32 arithmetic of the tiled ``fused_sgmv`` kernel, emulated in numpy.

The tiled path of ``src/repro_torch/kernels/csrc/fused_sgmv.cu`` runs the
base product x·W and the LoRA expand h·B[id] on the tensor cores with TF32
operands (10 explicit mantissa bits). Each f32 operand splits into
hi = tf32(a) and lo = tf32(a - hi); each k8 step adds lo·hi, hi·lo and hi·hi
to one f32 accumulator, and lo·lo is dropped. The shrink h = scale·x·A[id]
runs in f32 on the CUDA cores.

These tests pin the argument that lets the kernel keep the f32 parity
tolerance of ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``
(1e-4 of the largest reference magnitude): at the widths of the q
projection in the engine's 256-token prefill bucket (1024 -> 2048, rank 32,
ids as ``chip_smoke.sgmv_case`` draws them, rows cut to 256) the emulated
kernel stays within a tenth of that tolerance of an f64 product, and one
TF32 product per term does not stay within it. The emulation sums each k8
step's eight products exactly and rounds once into the f32 accumulator; the
tensor core's own rounding inside a step is not modelled.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

SGMV_TOL = 1e-4  # chip_smoke.SGMV_TOL: times max|ref|
MARGIN = 10.0


def tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, to nearest,
    ties away from zero, on the bits of the f32 (finite inputs)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(a, np.float32)
    hi = tf32(a)
    return hi, tf32(a - hi)  # a - hi is exact in f32


def mma_sum(acc, terms, K):
    """Add the products of ``terms`` [(a (M, K), b (K, N)), ...] to the f32
    accumulator, one k8 step at a time, in the kernel's order."""
    for k0 in range(0, K, 8):
        s = slice(k0, k0 + 8)
        for pa, pb in terms:
            acc = (acc.astype(np.float64)
                   + pa[:, s].astype(np.float64) @ pb[s].astype(np.float64)
                   ).astype(np.float32)
    return acc


def product(a, b, acc, passes: int):
    """acc + a·b with 3xTF32 (``passes`` 3) or one TF32 product (1)."""
    K = a.shape[1]
    pad = -K % 8  # the kernel zero-fills a part-filled k8 step
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    ahi, alo = split(a)
    bhi, blo = split(b)
    terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3 else [(ahi, bhi)]
    return mma_sum(acc, terms, K + pad)


def case(base: bool, seed: int = 0, B: int = 8, S: int = 32, d_in: int = 1024,
         d_out: int = 2048, N: int = 8, r: int = 32):
    """x, W, A, B, ids and scale as chip_smoke.sgmv_case draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d_in), np.float32)
    w = (rng.standard_normal((d_in, d_out), np.float32) * d_in ** -0.5
         if base else None)
    a = rng.standard_normal((N, d_in, r), np.float32) * np.float32(d_in ** -0.5)
    b = rng.standard_normal((N, r, d_out), np.float32) * np.float32(0.1)
    ids = np.array([-1, 0, 1, 2, 3, 4, 5, 7][:B], np.int32)
    return x, w, a, b, ids, 1.0


def emulate(x, w, a, b, ids, scale, passes: int = 3):
    """The tiled kernel's arithmetic: y = x·W (tensor cores) + h·B[id]
    (tensor cores) with h = scale·x·A[id] in f32."""
    B, S, d_in = x.shape
    d_out = b.shape[2]
    y = np.zeros((B, S, d_out), np.float32)
    for i, idx in enumerate(ids):
        acc = np.zeros((S, d_out), np.float32)
        if w is not None:
            acc = product(x[i], w, acc, passes)
        if idx >= 0:
            h = (np.float32(scale) * (x[i] @ a[idx])).astype(np.float32)
            acc = product(h, b[idx], acc, passes)
        y[i] = acc
    return y


def exact(x, w, a, b, ids, scale):
    x64 = x.astype(np.float64)
    y = np.zeros(x.shape[:2] + (b.shape[2],), np.float64)
    if w is not None:
        y += x64 @ w.astype(np.float64)
    for i, idx in enumerate(ids):
        if idx >= 0:
            y[i] += scale * (x64[i] @ a[idx].astype(np.float64)) @ b[idx].astype(np.float64)
    return y


@pytest.mark.parametrize("kind", ["normal", "wide", "tiny"])
def test_split_is_two_tf32_values_within_2_pow_22(kind):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(100_000).astype(np.float32)
    if kind == "wide":
        a *= np.float32(2.0) ** rng.integers(-60, 60, a.shape).astype(np.float32)
    elif kind == "tiny":
        a *= np.float32(1e-20)
    hi, lo = split(a)
    for part in (hi, lo):  # the 13 bits below TF32's mantissa are clear
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    a64 = a.astype(np.float64)
    assert np.all(np.abs(a64 - hi) <= 2.0 ** -11 * np.abs(a64))
    assert np.all(np.abs(a64 - hi - lo) <= 2.0 ** -22 * np.abs(a64))


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing at 1
    got = tf32(np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                         -(one + ulp / 2)], np.float32))
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                            -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("base", [True, False], ids=["fused_sgmv", "sgmv"])
def test_3xtf32_keeps_the_f32_tolerance_with_margin(base):
    args = case(base)
    want = exact(*args)
    got = emulate(*args)
    tol = SGMV_TOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err * MARGIN <= tol, (err, tol)
    # the port's plain version (f32 on the CPU) meets the same bound
    x, w, a, b, ids, scale = (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                              for v in args)
    plain = (ref.fused_sgmv_ref(x, w, a, b, ids, scale) if base
             else ref.sgmv_ref(x, a, b, ids, scale)).numpy()
    assert float(np.abs(plain - want).max()) * MARGIN <= tol


def test_one_tf32_product_misses_the_tolerance():
    """Why the kernel pays three products: one TF32 product per term keeps
    ~11 bits, and the base product's error then passes the tolerance."""
    args = case(True)
    want = exact(*args)
    got = emulate(*args, passes=1)
    tol = SGMV_TOL * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) > tol
