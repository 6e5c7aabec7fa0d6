"""The port's plain kernel versions in bf16 against the reference's Pallas
kernels in bf16 (interpret mode).

The same numpy inputs (fixed seed) are rounded to bf16 on both sides (both
round to nearest even, so both packages see the same bits) and go through
the reference's Pallas kernel, called as ``tests/test_kernels.py`` calls it,
and the port's wrapper on CPU tensors, which takes the plain version.
Tolerance: the reference's own bf16 tolerance (``tests/test_kernels.py``:
rtol 2e-2, atol 10 times that); the two differ only where XLA and PyTorch
sum in another order and round the bf16 output. Every plain version must
also equal its f32 version on the same (upcast) inputs, rounded once to
bf16: the port rounds no intermediate that the reference keeps in f32.
Besides the reference's cases: ``ragged_extend`` (which the reference
tests in f32 only), ranks 1, 12 and 128, a head dim of 20 and a group of 7.
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
from repro.kernels import sgmv as jax_sgmv
from repro_torch.kernels import (
    flash_prefill,
    flash_prefill_ragged,
    fused_sgmv,
    paged_attention,
    ragged_extend,
    sgmv,
)

TOL = dict(rtol=2e-2, atol=2e-1)  # tests/test_kernels.py, bf16


def _bf16(*arrays):
    """Each numpy f32 array as (jax bf16, torch bf16) holding the same bits."""
    out = []
    for a in arrays:
        j = jnp.asarray(a).astype(jnp.bfloat16)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
        assert np.array_equal(np.asarray(j).view(np.uint16), t.view(torch.int16).numpy()
                              .view(np.uint16))
        out.append((j, t))
    return out


def _check(got, want_jax, f32_again):
    """``got`` (torch bf16) within the reference's bf16 tolerance of the
    Pallas result, and equal to the f32 plain version rounded once."""
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_jax.astype(jnp.float32)), **TOL)
    assert torch.equal(got, f32_again.to(torch.bfloat16))


def _up(*ts):
    return [t.float() for t in ts]


@pytest.mark.parametrize("B,S,d_in,r,d_out,N,bs,bo", [
    (2, 16, 64, 8, 64, 3, 16, 32),
    (1, 7, 96, 16, 320, 2, 32, 64),    # S, d_out non-multiples of blocks
    (8, 1, 128, 64, 256, 8, 128, 128),  # decode: S = 1
    (3, 100, 64, 4, 72, 2, 32, 32),    # both dims ragged
    (2, 9, 64, 1, 40, 2, 16, 40),      # rank 1
    (3, 5, 48, 12, 56, 3, 16, 56),     # rank 12
    (2, 8, 64, 128, 64, 2, 16, 64),    # rank 128
])
def test_fused_sgmv_bf16_plain_matches_pallas(B, S, d_in, r, d_out, N, bs, bo):
    rng = np.random.default_rng(B * 1000 + S * 10 + r)
    (jx, x), (jw, w), (ja, a), (jb, b) = _bf16(
        rng.standard_normal((B, S, d_in), np.float32),
        rng.standard_normal((d_in, d_out), np.float32) * 0.1,
        rng.standard_normal((N, d_in, r), np.float32) * 0.1,
        rng.standard_normal((N, r, d_out), np.float32) * 0.1)
    ids = rng.integers(-1, N, size=(B,)).astype(np.int32)
    want = jax_fused_sgmv(jx, jw, ja, jb, ids, scale=0.5, block_s=bs, block_o=bo,
                          interpret=True)
    tids = torch.from_numpy(ids)
    got = fused_sgmv(x, w, a, b, tids, scale=0.5)
    _check(got, want, fused_sgmv(*_up(x, w, a, b), tids, scale=0.5))


@pytest.mark.parametrize("B,S,d_in,r,d_out,N", [
    (2, 16, 64, 8, 64, 3),
    (1, 7, 96, 16, 320, 2),   # ragged S, non-multiple d_out
    (8, 1, 128, 64, 256, 8),  # decode: S = 1
    (3, 6, 64, 1, 48, 2),     # rank 1
    (2, 11, 40, 12, 24, 3),   # rank 12
])
def test_sgmv_bf16_plain_matches_pallas(B, S, d_in, r, d_out, N):
    rng = np.random.default_rng(B * 100 + S + r)
    (jx, x), (ja, a), (jb, b) = _bf16(
        rng.standard_normal((B, S, d_in), np.float32),
        rng.standard_normal((N, d_in, r), np.float32) * 0.1,
        rng.standard_normal((N, r, d_out), np.float32) * 0.1)
    ids = rng.integers(-1, N, size=(B,)).astype(np.int32)
    want = jax_sgmv(jx, ja, jb, ids, scale=0.5, block_s=32, block_o=64 if d_out % 64 == 0
                    else d_out, interpret=True)
    tids = torch.from_numpy(ids)
    _check(sgmv(x, a, b, tids, scale=0.5), want, sgmv(*_up(x, a, b), tids, scale=0.5))


@pytest.mark.parametrize("B,H,Hkv,D,page,pages_per_seq,P", [
    (2, 4, 2, 32, 8, 3, 16),
    (3, 8, 1, 64, 16, 4, 32),  # MQA
    (1, 4, 4, 128, 8, 2, 8),   # MHA
    (2, 7, 1, 20, 8, 3, 8),    # G = 7, D = 20
])
def test_paged_attention_bf16_plain_matches_pallas(B, H, Hkv, D, page, pages_per_seq, P):
    rng = np.random.default_rng(H * 10 + D)
    (jq, q), (jk, k), (jv, v) = _bf16(
        rng.standard_normal((B, H, D), np.float32),
        rng.standard_normal((P, page, Hkv, D), np.float32),
        rng.standard_normal((P, page, Hkv, D), np.float32))
    tables = rng.permutation(P)[:B * pages_per_seq].reshape(B, pages_per_seq)
    tables = tables.astype(np.int32)
    lengths = rng.integers(1, page * pages_per_seq + 1, size=(B,)).astype(np.int32)
    want = jax_paged_attention(jq, jk, jv, tables, lengths, interpret=True)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lengths)
    _check(paged_attention(q, k, v, tt, tl), want, paged_attention(*_up(q, k, v), tt, tl))


@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk", [
    (2, 4, 4, 64, 32, 16, 16),
    (1, 8, 2, 128, 64, 32, 64),  # GQA, uneven blocks
    (2, 2, 1, 96, 32, 32, 32),   # MQA, S not a multiple of the block
    (1, 7, 1, 40, 20, 16, 16),   # G = 7, D = 20
])
def test_flash_prefill_bf16_plain_matches_pallas(B, H, Hkv, S, D, bq, bk):
    rng = np.random.default_rng(S + D)
    (jq, q), (jk, k), (jv, v) = _bf16(
        rng.standard_normal((B, H, S, D), np.float32),
        rng.standard_normal((B, Hkv, S, D), np.float32),
        rng.standard_normal((B, Hkv, S, D), np.float32))
    want = jax_flash_prefill(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    _check(flash_prefill(q, k, v), want, flash_prefill(*_up(q, k, v)))


@pytest.mark.parametrize("lens,H,Hkv,S,D", [
    ([48, 0, 17], 4, 2, 48, 32),
    ([9, 20], 7, 1, 24, 20),  # G = 7, D = 20
])
def test_flash_prefill_ragged_bf16_plain_matches_pallas(lens, H, Hkv, S, D):
    rng = np.random.default_rng(len(lens) + D)
    B = len(lens)
    (jq, q), (jk, k), (jv, v) = _bf16(
        rng.standard_normal((B, H, S, D), np.float32),
        rng.standard_normal((B, Hkv, S, D), np.float32),
        rng.standard_normal((B, Hkv, S, D), np.float32))
    tl = np.asarray(lens, np.int32)
    want = jax_flash_prefill_ragged(jq, jk, jv, tl, block_q=16, block_k=16,
                                    interpret=True)
    tt = torch.from_numpy(tl)
    got = flash_prefill_ragged(q, k, v, tt)
    _check(got, want, flash_prefill_ragged(*_up(q, k, v), tt))
    assert torch.equal(got[1 if lens[1] == 0 else 0, :, max(lens):],
                       torch.zeros_like(got[0, :, max(lens):]))


@pytest.mark.parametrize("starts,lens,S,T,H,Hkv,D", [
    ([16, 48], [32, 17], 32, 96, 4, 2, 32),  # mid-cache, ragged lens
    ([96, 5], [32, 0], 32, 128, 4, 2, 32),   # frontier at the edge, empty row
    ([10, 0, 30], [1, 12, 5], 12, 40, 7, 1, 20),  # G = 7, D = 20, a decode rider
])
def test_ragged_extend_bf16_plain_matches_pallas(starts, lens, S, T, H, Hkv, D):
    rng = np.random.default_rng(T + D)
    B = len(starts)
    (jq, q), (jk, k), (jv, v) = _bf16(
        rng.standard_normal((B, S, H, D), np.float32),
        rng.standard_normal((B, T, Hkv, D), np.float32),
        rng.standard_normal((B, T, Hkv, D), np.float32))
    st, tl = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    want = jax_ragged_extend(jq, jk, jv, st, tl, block_q=16, block_k=16, interpret=True)
    tst, ttl = torch.from_numpy(st), torch.from_numpy(tl)
    got = ragged_extend(q, k, v, tst, ttl)
    _check(got, want, ragged_extend(*_up(q, k, v), tst, ttl))
    for b, n in enumerate(lens):  # padded queries are exact zeros
        assert not got[b, n:].any()
