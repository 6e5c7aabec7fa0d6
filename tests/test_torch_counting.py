"""The port's kernel counts (``repro_torch.kernels.counting``).

(a) Its copies of the reference's four analytic counters give the
reference's dicts exactly, over the reference's own schedule. (b) The
reference's invariants (``tests/test_kernels.py``: trimmed grids strictly
cheaper, the fused projection a single pass over x) hold at the port's own
tiles. (c) ``bound_ms(work(...))`` gives the bounds ``chip_smoke.py``
printed on the card and PERF.md records, at phase 3's shapes.
"""

import numpy as np
import pytest
import torch

from repro.kernels import counting as ref
from repro.kernels.flash_prefill import _tri_schedule as ref_tri_schedule
from repro_torch.kernels import counting
from repro_torch.kernels.paged_attention import chunk_tokens
from repro_torch.kernels.sgmv import skinny_plan

# ------------------------------------------------- (a) the reference's counters
FLASH = [  # (B, H, Hkv, S, D, keywords)
    (1, 4, 2, 512, 64, dict(block_q=64, block_k=64, variant="block_skip")),
    (1, 4, 2, 512, 64, dict(block_q=64, block_k=64, variant="rect")),
    (4, 4, 2, 512, 64, dict(block_q=64, block_k=64, true_lens=[512, 300, 64, 0])),
    (2, 8, 8, 200, 32, dict(block_q=32, block_k=64, true_lens=[200, 17])),
    (2, 8, 1, 200, 32, dict(block_q=128, block_k=32, variant="rect", true_lens=[5, 200])),
    (3, 6, 2, 96, 16, dict(itemsize=2)),
]


@pytest.mark.parametrize("B,H,Hkv,S,D,kw", FLASH)
def test_flash_prefill_counts_equal_the_reference(B, H, Hkv, S, D, kw):
    assert counting.flash_prefill_counts(B, H, Hkv, S, D, **kw) == \
        ref.flash_prefill_counts(B, H, Hkv, S, D, **kw)


PAGED = [  # (B, H, Hkv, D, page_size, pages_per_seq, lengths, keywords)
    (4, 8, 2, 64, 16, 16, [256, 131, 7, 0], dict(trimmed=True)),
    (4, 8, 2, 64, 16, 16, [256, 131, 7, 0], dict(trimmed=False)),
    (8, 16, 8, 128, 128, 16, [0, 1, 129, 2048, 2048, 129, 1, 2049], {}),
    (2, 7, 1, 32, 8, 65, [513, 520], dict(itemsize=2, trimmed=False)),
]


@pytest.mark.parametrize("B,H,Hkv,D,ps,pages,lengths,kw", PAGED)
def test_paged_attention_counts_equal_the_reference(B, H, Hkv, D, ps, pages, lengths, kw):
    assert counting.paged_attention_counts(B, H, Hkv, D, ps, pages, lengths, **kw) == \
        ref.paged_attention_counts(B, H, Hkv, D, ps, pages, lengths, **kw)


RAGGED = [  # (B, H, Hkv, S, T, D, start, true_lens, keywords)
    (2, 4, 2, 128, 512, 64, [0, 384], [128, 65], dict(trimmed=True)),
    (2, 4, 2, 128, 512, 64, [0, 384], [128, 65], dict(trimmed=False)),
    (4, 8, 2, 64, 256, 32, [0, 200, 10, 0], [0, 1, 37, 64],
     dict(block_q=16, block_k=64)),
    (3, 4, 4, 32, 96, 16, [60, 0, 64], [32, 5, 0], dict(block_q=64, block_k=32,
                                                         itemsize=2, trimmed=False)),
]


@pytest.mark.parametrize("B,H,Hkv,S,T,D,start,lens,kw", RAGGED)
def test_ragged_extend_counts_equal_the_reference(B, H, Hkv, S, T, D, start, lens, kw):
    assert counting.ragged_extend_counts(B, H, Hkv, S, T, D, start, lens, **kw) == \
        ref.ragged_extend_counts(B, H, Hkv, S, T, D, start, lens, **kw)


SGMV = [  # (B, S, d_in, d_out, r, keywords)
    (8, 256, 512, 512, 32, dict(fused=True)),
    (8, 256, 512, 512, 32, dict(fused=False)),
    (8, 1, 1024, 2048, 32, dict(block_o=64)),
    (2, 300, 2048, 576, 16, dict(block_s=64, itemsize=2, fused=False)),
]


@pytest.mark.parametrize("B,S,d_in,d_out,r,kw", SGMV)
def test_sgmv_counts_equal_the_reference(B, S, d_in, d_out, r, kw):
    assert counting.sgmv_counts(B, S, d_in, d_out, r, **kw) == \
        ref.sgmv_counts(B, S, d_in, d_out, r, **kw)


@pytest.mark.parametrize("qb,kb,bq,bk", [(1, 1, 128, 128), (8, 8, 64, 64), (4, 16, 128, 32),
                                         (16, 2, 16, 128), (5, 7, 48, 40)])
def test_tri_schedule_equals_the_reference(qb, kb, bq, bk):
    for a, b in zip(counting._tri_schedule(qb, kb, bq, bk), ref_tri_schedule(qb, kb, bq, bk)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- (b) at the port's own tiles
@pytest.mark.parametrize("D,block_q", [(128, 128), (64, 32), (256, 64)])
def test_port_attention_tiles_trimmed_strictly_cheaper(D, block_q):
    """The reference's invariant at the port's 64-key K/V tiles: the
    triangle fetches fewer KV bytes than the rectangle for the same flops,
    ragged lengths fewer than full rows, the trimmed ragged_extend and
    paged_attention fewer than their dense baselines."""
    bk = counting.ATTN_BLOCK_K
    tri = counting.port_flash_prefill_counts(1, 4, 2, 512, D, block_q)
    rect = counting.flash_prefill_counts(1, 4, 2, 512, D, block_q=block_q, block_k=bk,
                                         variant="rect")
    assert tri["kv_bytes"] < rect["kv_bytes"]
    assert tri["flops"] == rect["flops"]
    rag = counting.port_flash_prefill_counts(4, 4, 2, 512, D, block_q,
                                             true_lens=[512, 300, 64, 0])
    full = counting.port_flash_prefill_counts(4, 4, 2, 512, D, block_q)
    assert rag["kv_bytes"] < full["kv_bytes"]

    ext = counting.port_ragged_extend_counts(2, 4, 2, 128, 512, D, [0, 384], [128, 65],
                                             block_q)
    dense = counting.ragged_extend_counts(2, 4, 2, 128, 512, D, [0, 384], [128, 65],
                                          block_q=block_q, block_k=bk, trimmed=False)
    assert ext["kv_bytes"] < dense["kv_bytes"]

    lengths = [256, 131, 7, 0]
    trim = counting.port_paged_attention_counts(4, 8, 2, D, 16, 16, lengths)
    chunk = chunk_tokens(D)  # the port's decode chunk: 64 tokens, 32 past D = 128
    full = counting.paged_attention_counts(4, 8, 2, D, chunk, 16 * 16 // chunk, lengths,
                                           trimmed=False)
    assert trim["kv_bytes"] < full["kv_bytes"]


def test_port_attention_counts_follow_each_path():
    """The bf16 loops' schedules: the split loop runs split_plan blocks a
    (row, kv head), not one a 64-token chunk of the table, and reads only
    the TMA boxes that hold a live token; the wgmma ragged_extend runs a
    block per KV part of a 128-vector q tile and reads each K/V tile of a
    tile's range once, issuing products only for warpgroups with a live
    row (a decode rider: one of two)."""
    lengths = [0, 1, 129, 2048, 2048, 129, 1, 2049]
    chunk = counting.port_paged_attention_counts(8, 16, 8, 128, 128, 16, lengths, itemsize=2)
    split = counting.port_paged_attention_counts(8, 16, 8, 128, 128, 16, lengths, itemsize=2,
                                                 path="split")
    assert split["grid_steps"] == 8 * 8 * 5 < chunk["grid_steps"] == 8 * 8 * 32
    assert split["kv_bytes"] <= chunk["kv_bytes"] and split["q_bytes"] == chunk["q_bytes"]
    s8 = counting.port_paged_attention_counts(1, 2, 1, 64, 8, 10, [17], itemsize=2,
                                              path="split")
    assert s8["kv_block_fetches"] == 2 * 3 and s8["kv_bytes"] == 2 * 24 * 64 * 2
    starts, lens = [0, 2047, 500, 0, 1792, 1011, 64, 300], [0, 1, 37, 256, 256, 37, 1, 256]
    mma = counting.port_ragged_extend_counts(8, 16, 8, 256, 2048, 128, starts, lens, 128,
                                             itemsize=2)
    wg = counting.port_ragged_extend_counts(8, 16, 8, 256, 2048, 128, starts, lens, 128,
                                            itemsize=2, path="wgmma", n_split=3)
    assert wg["kv_bytes"] < mma["kv_bytes"]
    # the split adds blocks, not bytes: each K/V tile still read once
    one = counting.port_ragged_extend_counts(8, 16, 8, 256, 2048, 128, starts, lens, 128,
                                             itemsize=2, path="wgmma", n_split=1)
    assert one["grid_steps"] < wg["grid_steps"] and one["kv_bytes"] == wg["kv_bytes"]
    rider = counting.port_ragged_extend_counts(2, 16, 8, 1, 2048, 128, [2047, 100], [1, 1],
                                               128, itemsize=2, path="wgmma", n_split=8)
    assert rider["grid_steps"] == 8 * (8 + 1)  # 32 and 2 K/V tiles: 8 parts and 1
    assert rider["flops"] == 8 * (32 + 2) * 4 * 64 * 64 * 128
    assert rider["kv_bytes"] == 8 * 2 * (2048 + 128) * 128 * 2


def test_port_attention_stages_half_tiles_past_d_128():
    assert [counting.attn_stage_keys(D) for D in (64, 128, 160, 256)] == [64, 64, 32, 32]
    assert counting.ATTN_BLOCK_K == 2 * counting.ATTN_WIDE_STAGE_K


@pytest.mark.parametrize("B,S", [(8, 256), (8, 2016), (8, 1), (2, 8)])
def test_port_sgmv_tiles_fused_single_pass(B, S):
    """The reference's invariant at the port's tiles (128 x 128 output
    tiles, or the skinny path's 64-column slabs at M <= 16): the fused
    projection reads each x tile in one pass, the unfused pair in two."""
    fused = counting.port_sgmv_counts(B, S, 1024, 2048, 32, fused=True)
    unfused = counting.port_sgmv_counts(B, S, 1024, 2048, 32, fused=False)
    assert fused["x_passes_per_block"] == 1.0
    assert unfused["x_passes_per_block"] == 2.0
    assert (fused["kernel_launches"], unfused["kernel_launches"]) == (1, 2)
    assert fused["shrink_blocks"] >= 1


@pytest.mark.parametrize("B,d_in,d_out,cs,ids,met", [
    # met: (block, live row) pairs of a slab, counted from the share of
    # block z, units [z·U/cs, (z + 1)·U/cs) of U = B·32
    (8, 1024, 2048, 16, [-1, 0, 1, 2, 3, 4, 5, 7], 14),  # two blocks a row; row 0 unread
    (8, 2048, 576, 16, [0] * 8, 16),
    (8, 4096, 4096, 8, [1, -1, -1, 1, 2, 2, -1, 0], 5),  # one block a row
    (2, 4096, 4096, 8, [0, 1], 8),          # llama-7b q: four blocks a row
    (2, 2048, 3072, 8, [-1, 3], 4),         # deepseek q: row 0's four blocks read nothing
    (3, 1024, 1024, 2, [0, 1, -1], 3),      # block 0 holds rows 0 and 1, block 1 rows 1 and 2
])
def test_port_sgmv_cluster_keeps_the_partials_on_chip(B, d_in, d_out, cs, ids, met):
    """The cluster loop (bf16 decode): one kernel, the fused projection's
    one pass over x, 128-column slabs and a shrink cluster a batch row in
    clusters of cs blocks; of its partials only h goes to device memory:
    cs parts of r 8-byte words (an f32 beside a 32-bit tag) for each live
    row, each read back in every slab by each block whose share of the
    slab's outputs meets the row, where the skinny loop writes and reads
    back every k split's M x (R + d_out) f32."""
    S, r = 1, 32
    cl = counting.port_sgmv_counts(B, S, d_in, d_out, r, itemsize=2, path="cluster",
                                   cluster_size=cs, adapter_ids=ids)
    sk = counting.port_sgmv_counts(B, S, d_in, d_out, r, itemsize=2)
    assert (cl["kernel_launches"], cl["x_passes_per_block"]) == (1, 1.0)
    cols = -(-d_out // 128)
    live = sum(i >= 0 for i in ids)
    assert cl["grid_steps"] == (cols + B) * cs and cl["shrink_blocks"] == B * cs
    assert cl["partial_write_bytes"] == 8 * cs * live * r
    assert cl["partial_read_bytes"] == 8 * cs * r * met * cols
    _, splits, _ = skinny_plan(B, d_in, d_out, True, 132)
    assert sk["partial_write_bytes"] == sk["partial_read_bytes"] == 4 * splits * B * (32 + d_out)
    assert sk["partial_write_bytes"] > 2 * cl["partial_write_bytes"]


# ------------------------------------------------- (c) least work and bound
QWEN_IDS = [-1, 0, 1, 2, 3, 4, 5, 7]  # chip_smoke.sgmv_case
GRAD_IDS = [-1, 0, 1, 2, 3, 0, 1, 2]  # chip_smoke.lora_grad_case
RAGGED_256 = dict(true_lens=[0, 1, 37, 256, 256, 37, 1, 256],  # chip_smoke.RAGGED_BUCKETS
                  starts=[0, 2047, 500, 0, 1792, 1011, 64, 300])
TABLE = [0, 1, 129, 2048, 2048, 129, 1, 2049]  # chip_smoke.PAGED_LENGTHS
ENGINE = [0, 64, 97, 300, 545, 790, 1056, 1312]
FLASH_LENS = [0, 1, 37, 1000, 2015, 2016, 2016, 2016]  # chip_smoke.main
F32, BF16 = torch.float32, torch.bfloat16


def sgmv(d_in, d_out, S, r=32, **kw):
    return dict(B=8, S=S, d_in=d_in, d_out=d_out, r=r, ids=QWEN_IDS, **kw)


def flash(**kw):
    return dict(B=8, S=2016, H=16, Hkv=8, D=128, **kw)


def paged(lengths, **kw):
    return dict(B=8, H=16, Hkv=8, D=128, T=2048, page_size=128, lengths=lengths, **kw)


BOUNDS = [  # (kernel, shape, dtype, PERF.md §6's bound_ms, bound_by)
    ("fused_sgmv", sgmv(1024, 2048, 256), F32, 0.0542, "operations"),
    ("fused_sgmv", sgmv(1024, 2048, 1), F32, 0.0034, "bytes"),
    ("fused_sgmv", sgmv(4096, 4096, 256), F32, 0.4222, "operations"),
    ("fused_sgmv", sgmv(1024, 2048, 256, r=128), F32, 0.0606, "operations"),
    ("fused_sgmv", sgmv(2048, 576, 256), F32, 0.0311, "operations"),
    ("fused_sgmv", sgmv(1024, 2048, 256, itemsize=2), BF16, 0.0090, "operations"),
    ("fused_sgmv", sgmv(1024, 2048, 1, itemsize=2), BF16, 0.0017, "bytes"),
    ("sgmv", sgmv(1024, 2048, 2016), F32, 0.0575, "bytes"),
    ("sgmv", sgmv(1024, 2048, 2016, itemsize=2), BF16, 0.0288, "bytes"),
    ("ragged_extend", dict(B=8, S=256, H=16, Hkv=8, D=128, **RAGGED_256), F32, 0.0344,
     "operations"),
    ("ragged_extend", dict(B=8, S=256, H=32, Hkv=32, D=128, **RAGGED_256), F32, 0.0783,
     "bytes"),
    ("ragged_extend", dict(B=8, S=256, H=16, Hkv=8, D=128, itemsize=2, **RAGGED_256), BF16,
     0.0116, "bytes"),
    ("paged_attention", paged(TABLE), F32, 0.0157, "bytes"),
    ("paged_attention", paged(TABLE, itemsize=2), BF16, 0.0078, "bytes"),
    ("paged_attention", paged(ENGINE, itemsize=2), BF16, 0.0051, "bytes"),
    ("flash_prefill", flash(), F32, 0.8075, "operations"),
    ("flash_prefill", flash(itemsize=2), BF16, 0.1347, "operations"),
    ("flash_prefill_ragged", flash(true_lens=FLASH_LENS), F32, 0.4286, "operations"),
    ("flash_prefill_ragged", flash(true_lens=FLASH_LENS, itemsize=2), BF16, 0.0715,
     "operations"),
    ("flash_prefill_bwd", dict(B=8, S=512, H=16, Hkv=8, D=128), F32, 0.1304, "operations"),
    ("flash_prefill_bwd", dict(B=1, S=4096, H=16, Hkv=8, D=128), F32, 1.0415, "operations"),
    ("lora_grad", dict(B=8, S=512, d_in=1024, d_out=2048, r=32, slots=5, ids=GRAD_IDS), F32,
     0.0230, "bytes"),
    ("lora_grad", dict(B=8, S=512, d_in=1024, d_out=2048, r=128, slots=5, ids=GRAD_IDS),
     F32, 0.0399, "operations"),
]


@pytest.mark.parametrize("kernel,shape,dtype,want,by", BOUNDS,
                         ids=[f"{k}-{i}" for i, (k, *_) in enumerate(BOUNDS)])
def test_bound_of_least_work_is_perf_md_s(kernel, shape, dtype, want, by):
    ms, got_by = counting.bound_ms(*counting.work(kernel, **shape), dtype)
    assert abs(ms - want) <= 1e-4 / 2 + 1e-12, (ms, want)
    assert got_by == by


def test_every_kernel_has_its_work():
    assert set(counting.KERNELS) == {k for k, *_ in BOUNDS}
    with pytest.raises(ValueError, match="unknown kernel"):
        counting.work("gemm", B=1)


def test_bound_picks_the_larger_time_at_the_dtypes_rate():
    ms, by = counting.bound_ms(counting.HBM_BYTES_PER_S / 1e3, 0.0)
    assert by == "bytes" and ms == pytest.approx(1.0, rel=1e-12)
    ms, by = counting.bound_ms(0.0, counting.F32_FLOPS / 1e3)
    assert by == "operations" and ms == pytest.approx(1.0, rel=1e-12)
    ms, _ = counting.bound_ms(0.0, counting.BF16_FLOPS / 1e3, torch.bfloat16)
    assert ms == pytest.approx(1.0, rel=1e-12)
