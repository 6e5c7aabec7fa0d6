"""The attention kernels' log-sum-exp output (``return_lse``) on the card,
against the plain versions. Needs an NVIDIA GPU with nvcc (sm_90a) and
skips without one; the card is detected inside the ``cuda`` fixture, never
at import. This file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_lse.py

Each loop of ``paged_attention`` (``chunk``: f32 and bf16 at G·D > 512;
``split``: bf16) and ``ragged_extend`` (``mma``: f32, and bf16 at a head
dim no multiple of 16; ``wgmma``: bf16), with rows of local count 0 (a
time shard of the cache whose slots all lie past a row's position) and
queries past the cache's end: the output within 1e-5 (f32) or 2e-2 of
its largest magnitude (bf16), the same bits as the launch without the
flag, and lse -inf exactly where the plain version's is and within 1e-5 of
max(1, |lse|) elsewhere.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


def _held(got, want, got_lse, want_lse, dtype):
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(got_lse), empty)
    g, w = got_lse[~empty], want_lse[~empty]
    assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= 1e-5


# (dtype, H, Hkv, D, page, the loop bf16_path picks)
PAGED = [(torch.float32, 8, 1, 256, 32, "chunk"), (torch.float32, 16, 8, 128, 128, "chunk"),
         (torch.bfloat16, 8, 1, 256, 32, "chunk"), (torch.bfloat16, 16, 8, 128, 128, "split")]


@pytest.mark.parametrize("dtype,H,Hkv,D,page,path", PAGED)
def test_paged_attention_lse(cuda, dtype, H, Hkv, D, page, path):
    rng = np.random.default_rng(0)
    B, T = 4, 160 if page == 32 else 512
    pages = T // page
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(cuda, dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal((B * pages, page, Hkv, D), np.float32))
              .to(cuda, dtype) for _ in range(2))
    tables = torch.arange(B * pages, dtype=torch.int32, device=cuda).view(B, pages)
    lens = torch.tensor([0, 1, T // 2 + 3, T], dtype=torch.int32, device=cuda)
    before = ops.path_launch_counts()["paged_attention"][path]
    got, got_lse = ops.paged_attention(q, kp, vp, tables, lens, return_lse=True)
    assert ops.path_launch_counts()["paged_attention"][path] == before + 1
    want, want_lse = ref.paged_attention_ref(q, kp, vp, tables, lens, return_lse=True)
    _held(got, want, got_lse, want_lse, dtype)
    assert torch.equal(got, ops.paged_attention(q, kp, vp, tables, lens))
    assert bool((got[0] == 0).all())


# (dtype, S, H, Hkv, D, the loop)
RAGGED = [(torch.float32, 4, 8, 1, 256, "mma"), (torch.float32, 32, 16, 8, 128, "mma"),
          (torch.bfloat16, 4, 8, 1, 256, "wgmma"), (torch.bfloat16, 32, 16, 8, 128, "wgmma"),
          (torch.bfloat16, 4, 8, 2, 20, "mma")]


@pytest.mark.parametrize("dtype,S,H,Hkv,D,path", RAGGED)
def test_ragged_extend_lse(cuda, dtype, S, H, Hkv, D, path):
    """Rows with no live query, a query at the cache's last slot and past
    it (it sees every key below T), and long rows whose KV range splits."""
    rng = np.random.default_rng(1)
    B, T = 4, 160 if S == 4 else 2048
    q = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, T, Hkv, D), np.float32)).to(cuda, dtype)
            for _ in range(2))
    start = torch.tensor([0, 0, 40, T - 3], dtype=torch.int32, device=cuda)
    lens = torch.tensor([0, 1, S - 1, S], dtype=torch.int32, device=cuda)
    before = ops.path_launch_counts()["ragged_extend"][path]
    got, got_lse = ops.ragged_extend(q, k, v, start, lens, return_lse=True)
    assert ops.path_launch_counts()["ragged_extend"][path] == before + 1
    want, want_lse = ref.ragged_extend_ref(q, k, v, start, lens, return_lse=True)
    _held(got, want, got_lse, want_lse, dtype)
    assert torch.equal(got, ops.ragged_extend(q, k, v, start, lens))
