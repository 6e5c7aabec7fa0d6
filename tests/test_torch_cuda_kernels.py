"""CUDA kernels of the port against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip without one; the card
is detected inside the ``cuda`` fixture, never at import. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Inputs come from numpy with a fixed seed. Tolerances: fused_sgmv 1e-4 of
the largest reference magnitude (f32 sums of up to 2048 terms, in another
order); the attention kernels 1e-5 absolute (softmax weights times
unit-scale values).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_sgmv, paged_attention, ragged_extend, ref
from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("B,S,d_in,d_out,r,N", [
    (8, 1, 1024, 2048, 32, 8),   # decode rows: the skinny path
    (8, 1, 2048, 1024, 32, 8),
    (2, 8, 1024, 1024, 16, 3),   # 16 rows of two adapters: skinny
    (3, 5, 100, 328, 8, 2),      # skinny, a part-filled column block
    (5, 1, 97, 64, 4, 2),        # few rows, d_in % 4 != 0: the tiled path
    (4, 37, 96, 320, 16, 3),
    (2, 256, 1024, 1024, 32, 8),
])
def test_fused_sgmv_cuda_matches_plain(cuda, B, S, d_in, d_out, r, N):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, d_in), np.float32)
    w = rng.standard_normal((d_in, d_out), np.float32) * 0.03
    a = rng.standard_normal((N, d_in, r), np.float32) * 0.03
    b = rng.standard_normal((N, r, d_out), np.float32) * 0.03
    ids = rng.integers(-1, N, size=(B,)).astype(np.int32)
    ids[0] = -1
    args = [_t(v, cuda) for v in (x, w, a, b, ids)]
    for zero_w in (False, True):
        if zero_w:
            args[1] = torch.zeros_like(args[1])
        before = ops.launch_counts()["fused_sgmv"]
        got = fused_sgmv(*args, scale=2.0)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_sgmv"] == before + 1
        want = ref.fused_sgmv_ref(*args, scale=2.0)
        tol = 1e-4 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol
        # a negative id drops the delta: the row is exactly x·W
        assert torch.equal(got[0], torch.zeros_like(got[0])) or not zero_w


@pytest.mark.parametrize("B,S,T,H,Hkv,D", [
    (8, 256, 2048, 16, 8, 128),
    (4, 19, 200, 4, 2, 128),
    (3, 1, 96, 8, 8, 64),
])
def test_ragged_extend_cuda_matches_plain(cuda, B, S, T, H, Hkv, D):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    lens = np.array([[0, 1, 37 % (S + 1), S][i % 4] for i in range(B)], np.int32)
    start = np.array([min(T - int(lens[i]), 5 + 311 * i) for i in range(B)],
                     np.int32)
    args = [_t(a, cuda) for a in (q, k, v, start, lens)]
    got = ragged_extend(*args)
    torch.cuda.synchronize()
    want = ref.ragged_extend_ref(*args)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # true_lens == 0


@pytest.mark.parametrize("B,T,H,Hkv,D,page", [
    (8, 2048, 16, 8, 128, 128),
    (5, 1040, 8, 2, 128, 16),  # 65 pages per row, split over many blocks
    (4, 96, 8, 2, 128, 32),
    (2, 64, 4, 4, 64, 16),
])
def test_paged_attention_cuda_matches_plain(cuda, B, T, H, Hkv, D, page):
    rng = np.random.default_rng(2)
    pages = T // page
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((B * pages, page, Hkv, D), np.float32)
    vp = rng.standard_normal((B * pages, page, Hkv, D), np.float32)
    tables = rng.permutation(B * pages).reshape(B, pages).astype(np.int32)
    lens = np.array([[0, 1, 129 % (T + 1), T][i % 4] for i in range(B)], np.int32)
    lens[-1] = T + 1  # an inactive row's start + 1 may point past the table
    args = [_t(a, cuda) for a in (q, kp, vp, tables, lens)]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # length 0


def test_cuda_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((2, 3, 8), device=cuda, dtype=torch.float64)
    w = torch.zeros((8, 4), device=cuda)
    a = torch.zeros((1, 8, 4), device=cuda)
    b = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_sgmv(x, w, a, b, torch.zeros(2, dtype=torch.int64))
