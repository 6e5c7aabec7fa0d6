"""The port's plain kernel versions against the reference's Pallas kernels.

Each case feeds the same numpy inputs (fixed seed) to the JAX Pallas kernel
in interpret mode, called as ``tests/test_kernels.py`` calls it, to the
reference's jnp oracle (``repro.kernels.ref``), and to the port's wrapper on
CPU tensors, which takes the plain PyTorch version. Tolerance: atol = rtol
= 1e-5 (f32 on both sides; only the order of the sums differs).

The CUDA kernels against these plain versions are in
``tests/test_torch_cuda_kernels.py``, which needs no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_prefill as jax_flash_prefill
from repro.kernels import flash_prefill_ragged as jax_flash_prefill_ragged
from repro.kernels import fused_sgmv as jax_fused_sgmv
from repro.kernels import paged_attention as jax_paged_attention
from repro.kernels import ragged_extend as jax_ragged_extend
from repro.kernels import ref as jref
from repro.kernels import sgmv as jax_sgmv
from repro_torch.kernels import (
    build,
    flash_prefill,
    flash_prefill_ragged,
    fused_sgmv,
    ops,
    paged_attention,
    ragged_extend,
    sgmv,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(got_torch, *jax_outs):
    got = got_torch.numpy()
    for want in jax_outs:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    return got


@pytest.mark.parametrize("B,S,d_in,r,d_out,N,ids", [
    (2, 16, 64, 8, 64, 3, [1, -1]),            # a negative id
    (4, 7, 96, 16, 320, 2, [-1, -1, -1, -1]),  # all negative: x·W alone
    (8, 1, 128, 32, 256, 8, [0, 7, -1, 3, 3, 5, 6, 1]),  # decode, S = 1
    (3, 37, 64, 4, 96, 4, [2, 0, 3]),          # S not a multiple of a tile
])
def test_fused_sgmv_plain_matches_pallas(B, S, d_in, r, d_out, N, ids):
    rng = np.random.default_rng(B * 100 + S)
    x = rng.standard_normal((B, S, d_in), np.float32)
    w = rng.standard_normal((d_in, d_out), np.float32) * 0.1
    a = rng.standard_normal((N, d_in, r), np.float32) * 0.1
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.1  # non-zero B
    ids = np.asarray(ids, np.int32)
    want = jax_fused_sgmv(x, w, a, b, ids, scale=0.5, block_s=16, block_o=64,
                          interpret=True)
    oracle = jref.fused_sgmv_ref(x, w, a, b, ids, scale=0.5)
    got = _both(fused_sgmv(*map(torch.from_numpy, (x, w, a, b, ids)), scale=0.5),
                want, oracle)
    base = x @ w
    for i in np.flatnonzero(ids < 0):  # a negative id drops the delta
        np.testing.assert_allclose(got[i], base[i], **TOL)


@pytest.mark.parametrize("start,lens,S,T", [
    ([0, 5, 30], [8, 1, 0], 8, 40),            # partial / decode rider / idle
    ([3, 60, 0, 17], [16, 4, 16, 1], 16, 96),
    ([10, 0], [1, 1], 1, 50),                  # S = 1, T not a tile multiple
    ([0, 40], [37, 0], 40, 100),               # S and T off the 16-tiles
])
def test_ragged_extend_plain_matches_pallas(start, lens, S, T):
    B, H, Hkv, D = len(start), 4, 2, 16
    rng = np.random.default_rng(S * 7 + T)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    st, tl = np.asarray(start, np.int32), np.asarray(lens, np.int32)
    want = jax_ragged_extend(q, k, v, st, tl, block_q=16, block_k=16,
                             interpret=True)
    oracle = jref.ragged_extend_ref(q, k, v, st, tl)
    got = _both(ragged_extend(*map(torch.from_numpy, (q, k, v, st, tl))),
                want, oracle)
    for b in range(B):  # padded queries and idle rows are exact zeros
        assert np.all(got[b, tl[b]:] == 0)


@pytest.mark.parametrize("B,H,Hkv,D,page,pages,lens", [
    (3, 4, 2, 16, 8, 3, [0, 1, 24]),       # empty row, one token, full
    (2, 8, 1, 32, 16, 4, [17, 64]),        # MQA, length off the page grid
    (4, 4, 4, 16, 8, 2, [5, 16, 9, 17]),   # MHA; 17 > table width (clamped)
])
def test_paged_attention_plain_matches_pallas(B, H, Hkv, D, page, pages, lens):
    rng = np.random.default_rng(B * 10 + D)
    P = B * pages + 2
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    tables = rng.permutation(P)[: B * pages].reshape(B, pages).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    want = jax_paged_attention(q, kp, vp, tables, ln, interpret=True)
    oracle = jref.paged_attention_ref(q, kp, vp, tables, ln)
    got = _both(paged_attention(*map(torch.from_numpy, (q, kp, vp, tables, ln))),
                want, oracle)
    for b in np.flatnonzero(ln == 0):  # an empty row is zeros, not mean(V)
        assert np.all(got[b] == 0)


@pytest.mark.parametrize("B,S,d_in,r,d_out,N,ids", [
    (2, 16, 64, 8, 64, 3, [1, -1]),            # a negative id
    (4, 7, 96, 16, 320, 2, [-1, -1, -1, -1]),  # all negative: zeros
    (8, 1, 128, 32, 256, 8, [0, 7, -1, 3, 3, 5, 6, 1]),  # decode, S = 1
    (3, 37, 64, 4, 96, 4, [2, 0, 3]),          # S not a multiple of a tile
])
def test_sgmv_plain_matches_pallas(B, S, d_in, r, d_out, N, ids):
    rng = np.random.default_rng(B * 100 + S + 1)
    x = rng.standard_normal((B, S, d_in), np.float32)
    a = rng.standard_normal((N, d_in, r), np.float32) * 0.1
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.1
    ids = np.asarray(ids, np.int32)
    want = jax_sgmv(x, a, b, ids, scale=0.5, block_s=16, block_o=64,
                    interpret=True)
    oracle = jref.sgmv_ref(x, a, b, ids, scale=0.5)
    got = _both(sgmv(*map(torch.from_numpy, (x, a, b, ids)), scale=0.5),
                want, oracle)
    for i in np.flatnonzero(ids < 0):  # a negative id gives a zero row
        assert np.all(got[i] == 0)


@pytest.mark.parametrize("B,H,Hkv,S,D,block", [
    (2, 4, 2, 64, 32, 16),    # GQA, S a block multiple
    (1, 4, 2, 100, 32, 32),   # S not a block multiple: the masked tail
    (2, 8, 1, 37, 16, 16),    # MQA, S off the blocks
    (1, 2, 2, 16, 16, 16),    # MHA, one block
])
def test_flash_prefill_plain_matches_pallas(B, H, Hkv, S, D, block):
    rng = np.random.default_rng(S * 3 + H)
    q = rng.standard_normal((B, H, S, D), np.float32)
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    want = jax_flash_prefill(q, k, v, block_q=block, block_k=block,
                             interpret=True)
    oracle = jref.flash_prefill_ref(q, k, v)
    _both(flash_prefill(*map(torch.from_numpy, (q, k, v))), want, oracle)


@pytest.mark.parametrize("S,lens", [
    (64, [64, 33, 1, 0]),     # full, ragged, one token, empty
    (40, [0, 40, 17]),        # S off the blocks
    (16, [0, 0]),             # every row empty
])
def test_flash_prefill_ragged_plain_matches_pallas(S, lens):
    B, H, Hkv, D = len(lens), 4, 2, 16
    rng = np.random.default_rng(S + B)
    q = rng.standard_normal((B, H, S, D), np.float32)
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    tl = np.asarray(lens, np.int32)
    want = jax_flash_prefill_ragged(q, k, v, tl, block_q=16, block_k=16,
                                    interpret=True)
    oracle = jref.flash_prefill_ragged_ref(q, k, v, tl)
    got = _both(flash_prefill_ragged(*map(torch.from_numpy, (q, k, v, tl))),
                want, oracle)
    for b in range(B):  # padded queries and empty rows are exact zeros
        assert np.all(got[b, :, tl[b]:] == 0)
    full = np.flatnonzero(tl == S)  # a full row is the plain kernel's
    if full.size:
        plain = flash_prefill(*map(torch.from_numpy, (q, k, v))).numpy()
        np.testing.assert_array_equal(got[full], plain[full])


def test_flash_prefill_reads_transposed_views():
    """gqa_full hands the kernel (B, S, H, D) tensors transposed to
    head-major: the wrapper takes the views as they are."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 24, 2, 16), np.float32))
    got = flash_prefill(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = jax_flash_prefill(*(np.ascontiguousarray(t.transpose(1, 2).numpy())
                               for t in (q, k, v)),
                             block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_plain_versions_keep_autograd():
    """The CPU branch is plain PyTorch: gradients flow through it (on the
    card fused_sgmv and flash_prefill have backward kernels and the
    serving-only kernels refuse autograd, tests/test_torch_cuda_kernels.py)."""
    q = torch.randn((1, 2, 8, 4), requires_grad=True)
    kv = torch.randn((1, 1, 8, 4), requires_grad=True)
    flash_prefill(q, kv, kv).sum().backward()
    assert q.grad is not None and kv.grad is not None
    x = torch.randn((2, 3, 8), requires_grad=True)
    a = torch.randn((2, 8, 4), requires_grad=True)
    sgmv(x, a, torch.randn((2, 4, 6)), torch.tensor([1, -1])).sum().backward()
    assert x.grad is not None and a.grad is not None


def test_cpu_dispatch_counts_no_launch():
    """A CPU tensor takes the plain version: no kernel is launched."""
    ops.reset_launch_counts()
    x = torch.zeros((1, 2, 8))
    fused_sgmv(x, torch.zeros((8, 4)), torch.zeros((1, 8, 2)),
               torch.zeros((1, 2, 4)), torch.zeros((1,), dtype=torch.int32))
    sgmv(x, torch.zeros((1, 8, 2)), torch.zeros((1, 2, 4)),
         torch.zeros((1,), dtype=torch.int32))
    qkv = torch.zeros((1, 2, 2, 4))
    flash_prefill(qkv, qkv, qkv)
    flash_prefill_ragged(qkv, qkv, qkv, torch.ones((1,), dtype=torch.int32))
    qg = qkv.clone().requires_grad_(True)  # the backward's plain version too
    flash_prefill(qg, qkv, qkv).sum().backward()
    xg = x.clone().requires_grad_(True)
    fused_sgmv(xg, torch.zeros((8, 4)), torch.zeros((1, 8, 2)),
               torch.zeros((1, 2, 4)), torch.zeros((1,), dtype=torch.int32)).sum().backward()
    assert ops.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert set(build.KERNELS) == {
        "fused_sgmv", "sgmv", "ragged_extend", "paged_attention",
        "flash_prefill", "flash_prefill_ragged", "flash_prefill_bwd", "lora_grad"}
