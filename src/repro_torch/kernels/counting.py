"""The kernels' counts, and the H100's roofline.

Three parts:

(a) The reference's analytic HBM-traffic and FLOP counters
    (``repro.kernels.counting``), with its names, signatures, defaults and
    returned dicts: each replays a grid order and its block index maps in
    plain Python and tallies a block fetch whenever the mapped block index
    differs from the previous step's. They run over this module's copy of
    the reference's triangular schedule (:func:`_tri_schedule`).
(b) The port's own tiles, each named once beside the CUDA line that fixes
    it, and the counters of (a) called with them: the traffic under the
    port's schedule (``port_*_counts``). Where the CUDA code picks a tile
    itself (the q tile's rows in ``csrc/attention_tc.cuh:tile_rows``), the
    counter takes it as an argument.
(c) The least work of each kernel (:func:`work`: each input read once, each
    output written once, the flops the data needs) and its bound on the
    card (:func:`bound_ms`), which ``chip_smoke.py`` prints beside each
    kernel's time.

Everything here is host-side integer arithmetic on static shapes.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .paged_attention import SPLIT_TOKENS, chunk_plan, chunk_tokens, split_plan
from .sgmv import CLUSTER_COLS, SKINNY_COLS, SKINNY_MAX_M, skinny_plan

# ---------------------------------------------------------- the H100 (SXM)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
L2_BYTES = 50e6  # H100 L2 cache
# H100 SXM: f32-accurate products on the tensor cores, 495 TFLOP/s TF32
# dense over the three TF32 products of a 3xTF32 split (the CUDA cores'
# 67 TFLOP/s f32 is not the least time once a kernel uses the split)
F32_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
H100_SMS = 132  # H100 SXM streaming multiprocessors


# ------------------------------------------------ (a) the reference's counters
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tri_schedule(
    q_blocks: int, kv_blocks: int, block_q: int, block_k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten the lower-triangular (q, kv) block pairs into one grid axis
    (the reference's ``flash_prefill._tri_schedule``).

    Returns int32 arrays ``rows[t]`` (q block), ``cols[t]`` (kv block) and
    ``lasts[t]`` (1 on the final — diagonal — kv block of each q row).
    """
    rows: list[int] = []
    cols: list[int] = []
    lasts: list[int] = []
    for i in range(q_blocks):
        need = min(kv_blocks, (i * block_q + block_q - 1) // block_k + 1)
        for j in range(need):
            rows.append(i)
            cols.append(j)
            lasts.append(1 if j == need - 1 else 0)
    return (
        np.asarray(rows, np.int32),
        np.asarray(cols, np.int32),
        np.asarray(lasts, np.int32),
    )


class _FetchCounter:
    """Counts block fetches: one per grid step whose index differs from the
    previous step's (consecutive equal indices ⇒ the copy is skipped)."""

    def __init__(self) -> None:
        self.fetches = 0
        self._prev: object = None

    def visit(self, index: object) -> None:
        if index != self._prev:
            self.fetches += 1
            self._prev = index

    def reset(self) -> None:
        """Forget the resident block (kernel boundary)."""
        self._prev = None


def flash_prefill_counts(
    B: int,
    H: int,
    Hkv: int,
    S: int,
    D: int,
    *,
    block_q: int = 128,
    block_k: int = 128,
    itemsize: int = 4,
    true_lens: Sequence[int] | None = None,
    variant: str = "block_skip",
) -> dict:
    """Counted traffic for ``flash_prefill`` / ``flash_prefill_ragged``.

    ``variant="rect"`` replays the rectangular grid (above-diagonal blocks
    fetched, compute skipped) as the baseline; ``"block_skip"`` replays the
    triangular flattened schedule. Passing ``true_lens`` replays the ragged
    index-map clamps on top.
    """
    G = H // Hkv
    bq = min(block_q, S)
    bk = min(block_k, S)
    qb, kb = _cdiv(S, bq), _cdiv(S, bk)
    if variant == "block_skip":
        rows, cols, _ = _tri_schedule(qb, kb, bq, bk)
        sched = list(zip(rows.tolist(), cols.tolist()))
    elif variant == "rect":
        sched = [(i, j) for i in range(qb) for j in range(kb)]
    else:
        raise ValueError(f"unknown variant {variant!r}")
    lens = list(true_lens) if true_lens is not None else [S] * B
    kv_ctr, q_ctr = _FetchCounter(), _FetchCounter()
    flops = 0
    for b in range(B):
        live_q = max(_cdiv(lens[b], bq), 1)
        live_k = max(_cdiv(lens[b], bk), 1)
        for h in range(H):
            for i, j in sched:
                i_eff = min(i, live_q - 1) if true_lens is not None else i
                j_eff = min(j, live_k - 1) if true_lens is not None else j
                q_ctr.visit((b, h, i_eff))
                kv_ctr.visit((b, h // G, j_eff))
                active = j * bk <= i * bq + bq - 1  # causal intersection
                if true_lens is not None:
                    active = active and i * bq < lens[b] and j * bk < lens[b]
                if active:
                    flops += 4 * bq * bk * D
    kv_bytes = kv_ctr.fetches * bk * D * itemsize * 2  # K and V
    q_bytes = q_ctr.fetches * bq * D * itemsize
    return {
        "grid_steps": B * H * len(sched),
        "kv_block_fetches": kv_ctr.fetches,
        "kv_bytes": kv_bytes,
        "q_bytes": q_bytes,
        "hbm_bytes": kv_bytes + 2 * q_bytes,  # q in, o out
        "flops": flops,
    }


def paged_attention_counts(
    B: int,
    H: int,
    Hkv: int,
    D: int,
    page_size: int,
    pages_per_seq: int,
    lengths: Sequence[int],
    *,
    itemsize: int = 4,
    trimmed: bool = True,
) -> dict:
    """Counted traffic for ``paged_attention``.

    ``trimmed=False`` replays the full-grid fetch (every page of every
    sequence streamed, tokens masked after the fact).
    """
    G = H // Hkv
    kv_ctr = _FetchCounter()
    flops = 0
    for b in range(B):
        live = max(_cdiv(lengths[b], page_size), 1)
        for h in range(Hkv):
            for p in range(pages_per_seq):
                p_eff = min(p, live - 1) if trimmed else p
                kv_ctr.visit((b, h, p_eff))
                if not trimmed or p * page_size < lengths[b]:
                    flops += 4 * G * page_size * D
    kv_bytes = kv_ctr.fetches * page_size * D * itemsize * 2
    q_bytes = B * H * D * itemsize
    return {
        "grid_steps": B * Hkv * pages_per_seq,
        "kv_block_fetches": kv_ctr.fetches,
        "kv_bytes": kv_bytes,
        "q_bytes": q_bytes,
        "hbm_bytes": kv_bytes + 2 * q_bytes,
        "flops": flops,
    }


def ragged_extend_counts(
    B: int,
    H: int,
    Hkv: int,
    S: int,
    T: int,
    D: int,
    start: Sequence[int],
    true_lens: Sequence[int],
    *,
    block_q: int = 128,
    block_k: int = 128,
    itemsize: int = 4,
    trimmed: bool = True,
) -> dict:
    """Counted traffic for ``ragged_extend``.

    ``trimmed=False`` replays the dense baseline (every q block attends
    every cache block of the padded rectangle, masking after the fetch).
    """
    G = H // Hkv
    bq = min(block_q, S)
    bk = min(block_k, T)
    qb, kb = _cdiv(S, bq), _cdiv(T, bk)
    kv_ctr, q_ctr = _FetchCounter(), _FetchCounter()
    flops = 0
    for b in range(B):
        live_q = max(_cdiv(true_lens[b], bq), 1)
        frontier = max(_cdiv(start[b] + true_lens[b], bk), 1)
        for h in range(H):
            for i in range(qb):
                i_eff = min(i, live_q - 1) if trimmed else i
                diag = (start[b] + i_eff * bq + bq - 1) // bk + 1
                live_k = max(min(frontier, diag), 1)
                for j in range(kb):
                    j_eff = min(j, live_k - 1) if trimmed else j
                    q_ctr.visit((b, h, i_eff))
                    kv_ctr.visit((b, h // G, j_eff))
                    active = (
                        i * bq < true_lens[b]
                        and j * bk < start[b] + true_lens[b]
                        and j * bk <= start[b] + i * bq + bq - 1
                    )
                    if not trimmed or active:
                        flops += 4 * bq * bk * D
    kv_bytes = kv_ctr.fetches * bk * D * itemsize * 2
    q_bytes = q_ctr.fetches * bq * D * itemsize
    return {
        "grid_steps": B * H * qb * kb,
        "kv_block_fetches": kv_ctr.fetches,
        "kv_bytes": kv_bytes,
        "q_bytes": q_bytes,
        "hbm_bytes": kv_bytes + 2 * q_bytes,
        "flops": flops,
    }


def sgmv_counts(
    B: int,
    S: int,
    d_in: int,
    d_out: int,
    r: int,
    *,
    block_s: int = 128,
    block_o: int = 128,
    itemsize: int = 4,
    fused: bool = True,
) -> dict:
    """Counted activation traffic for the LoRA projection.

    ``fused=True`` replays ``fused_sgmv`` (one kernel: the x tile is fetched
    once per token tile and read once per (token, out) block);
    ``fused=False`` replays the unfused pair — base matmul kernel plus the
    shrink/expand ``sgmv`` kernel — each streaming the x tile again.
    """
    bs = min(block_s, S)
    bo = min(block_o, d_out)
    sb, ob = _cdiv(S, bs), _cdiv(d_out, bo)
    kernels = 1 if fused else 2  # fused vs (base matmul, sgmv)
    x_ctr = _FetchCounter()
    for _ in range(kernels):
        x_ctr.reset()
        for b in range(B):
            for s in range(sb):
                for o in range(ob):
                    x_ctr.visit((b, s))
    x_bytes = x_ctr.fetches * bs * d_in * itemsize
    flops = 2 * B * S * d_in * d_out + 2 * B * S * r * (d_in + d_out)
    return {
        "grid_steps": kernels * B * sb * ob,
        "x_tile_fetches": x_ctr.fetches,
        "x_passes_per_block": x_ctr.fetches / (B * sb),
        "x_bytes": x_bytes,
        "kernel_launches": kernels,
        "flops": flops,
    }


# ----------------------------------------------------- (b) the port's tiles
ATTN_BLOCK_K = 64  # csrc/attention_tc.cuh:93 BKV: keys of a K/V tile
ATTN_WIDE_STAGE_K = 32  # csrc/attention_tc.cuh:110 stage_keys: past D = 128
ATTN_NARROW_D = 128  # csrc/attention_tc.cuh:97 NARROW_D
SGMV_TILE_M = 128  # csrc/fused_sgmv.cu:150 TM: rows of an output tile
SGMV_TILE_N = 128  # csrc/fused_sgmv.cu:151 TN: columns of an output tile
SGMV_SHRINK_ROWS = 64  # csrc/fused_sgmv.cu:175 SH_ROWS: rows of a shrink block
WGMMA_ROWS = 128  # csrc/attention_wgmma.cuh:104 ROWS: query vectors of a q tile
RAGGED_PART_TILES = 4  # csrc/ragged_split.cuh:25 PART_TILES: K/V tiles of a KV part


def attn_stage_keys(D: int) -> int:
    """Keys of one staged K/V tile at head dim ``D``: 64, 32 past D = 128."""
    return ATTN_WIDE_STAGE_K if D > ATTN_NARROW_D else ATTN_BLOCK_K


def port_flash_prefill_counts(B: int, H: int, Hkv: int, S: int, D: int, block_q: int,
                              *, itemsize: int = 4,
                              true_lens: Sequence[int] | None = None) -> dict:
    """:func:`flash_prefill_counts` on the port's schedule: 64-key K/V tiles
    over the lower triangle, q tiles of ``block_q`` tokens."""
    return flash_prefill_counts(B, H, Hkv, S, D, block_q=block_q, block_k=ATTN_BLOCK_K,
                                itemsize=itemsize, true_lens=true_lens)


def port_ragged_extend_counts(B: int, H: int, Hkv: int, S: int, T: int, D: int,
                              start: Sequence[int], true_lens: Sequence[int],
                              block_q: int, *, itemsize: int = 4, path: str = "mma",
                              n_split: int = 1) -> dict:
    """:func:`ragged_extend_counts` on the port's schedule of ``path``.
    ``"mma"`` (``csrc/attention_tc.cuh``): 64-key K/V tiles up to each
    row's frontier, q tiles of ``block_q`` tokens. ``"wgmma"``
    (``csrc/ragged_extend_wgmma.cu``): one block per (q tile of 128 query
    vectors of a kv head, row, kv head, KV part) over the 64-key tiles up to
    min(frontier, the tile's diagonal), a tile's range cut into
    min(``n_split``, one a RAGGED_PART_TILES tiles) parts, where ``n_split``
    is the launch's part count (``ragged_extend_wgmma_kv_parts`` of the
    library, from the card's SM count); each tile's K and V read once by
    the part that owns it, the rows past T not at all; ``flops`` counts the
    products issued (4·64·64·D a live warpgroup of 64 rows and a tile),
    ``grid_steps`` the blocks that work."""
    if path == "mma":
        return ragged_extend_counts(B, H, Hkv, S, T, D, start, true_lens, block_q=block_q,
                                    block_k=ATTN_BLOCK_K, itemsize=itemsize)
    G = H // Hkv
    n_tiles = _cdiv(S * G, WGMMA_ROWS)
    kv_bytes = q_bytes = flops = blocks = fetches = 0
    for b in range(B):
        n, st = min(max(true_lens[b], 0), S), start[b]
        for i in range(n_tiles):
            v_lo = i * WGMMA_ROWS
            q_hi = min(_cdiv(v_lo + WGMMA_ROWS, G), S, n)
            if v_lo // G >= q_hi:
                continue
            kv_end = min(st + q_hi, T)
            tiles = _cdiv(kv_end, ATTN_BLOCK_K)
            live_vectors = min(q_hi * G, v_lo + WGMMA_ROWS) - v_lo
            warpgroups = _cdiv(live_vectors, 64)
            rows = min(T, tiles * ATTN_BLOCK_K)  # keys the map reads (none past T)
            blocks += Hkv * min(_cdiv(tiles, RAGGED_PART_TILES), n_split)
            fetches += Hkv * tiles
            kv_bytes += Hkv * 2 * rows * D * itemsize
            q_bytes += Hkv * live_vectors * D * itemsize
            flops += Hkv * warpgroups * tiles * 4 * 64 * ATTN_BLOCK_K * D
    return {"grid_steps": blocks, "kv_block_fetches": fetches, "kv_bytes": kv_bytes,
            "q_bytes": q_bytes, "hbm_bytes": kv_bytes + 2 * q_bytes, "flops": flops}


def port_paged_attention_counts(B: int, H: int, Hkv: int, D: int, page_size: int,
                                pages_per_seq: int, lengths: Sequence[int], *,
                                itemsize: int = 4, path: str = "chunk",
                                sms: int = H100_SMS) -> dict:
    """:func:`paged_attention_counts` on the port's schedule of ``path``.
    ``"chunk"``: one block per chunk of ``chunk_tokens(D)`` tokens of the
    table (``paged_attention.chunk_plan``), dead chunks fetching nothing
    new. ``"split"`` (bf16): ``paged_attention.split_plan`` blocks per (row,
    kv head) on a card of ``sms`` SMs (``grid_steps``), each over its share
    of the live 64-token tiles, loaded in TMA boxes of gcd(page, 64) tokens
    of which only those holding a live token are read
    (``kv_block_fetches``: the boxes of K and of V)."""
    if path == "chunk":
        return paged_attention_counts(B, H, Hkv, D, chunk_tokens(D),
                                      chunk_plan(page_size, pages_per_seq, D), lengths,
                                      itemsize=itemsize)
    G, T = H // Hkv, page_size * pages_per_seq
    bt = math.gcd(page_size, SPLIT_TOKENS)
    boxes = sum(_cdiv(min(max(n, 0), T), bt) for n in lengths) * Hkv
    live = sum(min(max(n, 0), T) for n in lengths)
    kv_bytes = 2 * boxes * bt * D * itemsize
    q_bytes = B * H * D * itemsize
    return {"grid_steps": B * Hkv * split_plan(B, Hkv, sms), "kv_block_fetches": 2 * boxes,
            "kv_bytes": kv_bytes, "q_bytes": q_bytes, "hbm_bytes": kv_bytes + 2 * q_bytes,
            "flops": 4 * G * live * Hkv * D}


def port_sgmv_counts(B: int, S: int, d_in: int, d_out: int, r: int, *,
                     itemsize: int = 4, fused: bool = True, sms: int = H100_SMS,
                     path: str = "skinny", cluster_size: int | None = None,
                     adapter_ids=None) -> dict:
    """:func:`sgmv_counts` on the port's schedule: the B·S rows as one M,
    in 128 × 128 output tiles beside one shrink block a 64 rows (the tiled
    path), or, at M <= 16, in one row block against W slabs. ``path``
    "skinny" (``csrc/fused_sgmv.cu``): 64-column slabs with one shrink block
    per row in each k split of ``sgmv.skinny_plan`` on a card of ``sms``
    SMs, the splits' f32 partials of x·W and of h written to device memory
    and read back by a second kernel. "cluster" (bf16,
    ``csrc/fused_sgmv_cluster.cu``): 128-column slabs and one shrink
    cluster a batch row, each of ``cluster_size`` blocks (``sgmv.cluster_plan``'s
    cs: the card's cluster capacity picks it), one kernel; the partials of
    x·W meet in distributed shared memory, and only h goes to device
    memory, as 8-byte words (an f32 beside its launch's 32-bit tag): the
    shrink cluster of each live id (``adapter_ids``, one a batch row; None:
    every row live) writes cs parts of r words for each row of that id, and
    in every slab each block whose share of the slab's outputs (its units
    [z·U/cs, (z + 1)·U/cs) of U = M·32 units of 4 columns) meets a live row
    reads that row's cs·r words (a word read again while its block waits
    for it is not counted). Rows of id -1 are neither written nor read.
    ``shrink_blocks``, ``partial_write_bytes`` and ``partial_read_bytes``
    add to the reference's keys."""
    M = B * S
    if M <= SKINNY_MAX_M and path == "cluster":
        cs = cluster_size
        cols, nb = _cdiv(d_out, CLUSTER_COLS), M // S
        ids = [0] * B if adapter_ids is None else [int(i) for i in adapter_ids]
        live = [ids[m // S] >= 0 for m in range(M)]
        ur = CLUSTER_COLS // 4
        U = M * ur
        # (block, live row) pairs of a slab: the live rows of each block's share
        met = sum(live[m] for z in range(cs)
                  for m in range(z * U // cs // ur, ((z + 1) * U // cs - 1) // ur + 1))
        out = sgmv_counts(1, M, d_in, d_out, r, block_s=SKINNY_MAX_M,
                          block_o=CLUSTER_COLS, itemsize=itemsize, fused=fused)
        return {**out, "grid_steps": (cols + nb) * cs, "shrink_blocks": nb * cs,
                "partial_write_bytes": 8 * cs * sum(live) * r,
                "partial_read_bytes": 8 * cs * r * met * cols}
    if M <= SKINNY_MAX_M:
        out = sgmv_counts(1, M, d_in, d_out, r, block_s=SKINNY_MAX_M,
                          block_o=SKINNY_COLS, itemsize=itemsize, fused=fused)
        _, splits, _ = skinny_plan(M, d_in, d_out, True, sms)
        R = max(4, 1 << (r - 1).bit_length())  # the compiled rank r runs on
        part = 4 * splits * M * (R + d_out)
        return {**out, "shrink_blocks": M * splits, "partial_write_bytes": part,
                "partial_read_bytes": part}
    out = sgmv_counts(1, M, d_in, d_out, r, block_s=SGMV_TILE_M, block_o=SGMV_TILE_N,
                      itemsize=itemsize, fused=fused)
    return {**out, "shrink_blocks": _cdiv(M, SGMV_SHRINK_ROWS)}


# ------------------------------------------------ (c) least work and bound
def _sgmv_work(B, S, d_in, d_out, r, ids, itemsize, base):
    live = [i for i in ids if i >= 0]
    n_live_ids = len(set(live))
    M, M_live = B * S, len(live) * S
    lora_bytes = n_live_ids * r * (d_in + d_out)
    if base:
        nbytes = itemsize * (M * d_in + d_in * d_out + M * d_out + lora_bytes) + 4 * B
        flops = 2 * M * d_in * d_out + 2 * M_live * r * (d_in + d_out)
    else:  # rows of id -1 need no x
        nbytes = itemsize * (M_live * d_in + M * d_out + lora_bytes) + 4 * B
        flops = 2 * M_live * r * (d_in + d_out)
    return nbytes, flops


def _fused_sgmv_work(*, B, S, d_in, d_out, r, ids, itemsize=4):
    """x·W + the delta of each live row: x, W, each live id's A and B and
    y once, the ids."""
    return _sgmv_work(B, S, d_in, d_out, r, ids, itemsize, True)


def _delta_work(*, B, S, d_in, d_out, r, ids, itemsize=4):
    """The delta alone: the live rows' x, each live id's A and B, y."""
    return _sgmv_work(B, S, d_in, d_out, r, ids, itemsize, False)


def _ragged_extend_work(*, B, S, H, Hkv, D, starts, true_lens, itemsize=4, lse=False):
    """The live queries, each row's cached and new K/V up to its last
    query, the padded output (and its f32 log-sum-exp with ``lse``),
    starts and lengths; causal products."""
    live_q = sum(true_lens)
    kv_tokens = sum(s + n for s, n in zip(starts, true_lens) if n > 0)
    nbytes = itemsize * (live_q * H * D + 2 * kv_tokens * Hkv * D + B * S * H * D) + 8 * B
    nbytes += 4 * B * S * H if lse else 0
    flops = sum(4 * H * D * (s + j + 1) for s, n in zip(starts, true_lens)
                for j in range(n))
    return nbytes, flops


def _paged_attention_work(*, B, H, Hkv, D, T, page_size, lengths, itemsize=4, lse=False):
    """q and the output (and its f32 log-sum-exp with ``lse``), each row's
    live K/V (at most the table's T tokens), the block tables and
    lengths."""
    pages = T // page_size
    kv_tokens = sum(min(n, T) for n in lengths)
    nbytes = itemsize * (2 * B * H * D + 2 * kv_tokens * Hkv * D) + 4 * B * (pages + 1)
    nbytes += 4 * B * H if lse else 0
    flops = 4 * H * D * kv_tokens
    return nbytes, flops


def _flash_prefill_work(*, B, S, H, Hkv, D, true_lens=None, itemsize=4):
    """q, K and V up to each row's length, the full output (zeros past a
    length), the lengths; the causal triangle of each row."""
    live = [S] * B if true_lens is None else list(true_lens)
    nbytes = itemsize * (sum(live) * (H + 2 * Hkv) * D + B * H * S * D)
    nbytes += 4 * B if true_lens is not None else 0
    flops = sum(4 * H * D * n * (n + 1) // 2 for n in live)
    return nbytes, flops


def _flash_prefill_ragged_work(*, B, S, H, Hkv, D, true_lens, itemsize=4):
    return _flash_prefill_work(B=B, S=S, H=H, Hkv=Hkv, D=D, true_lens=true_lens,
                               itemsize=itemsize)


def _flash_prefill_bwd_work(*, B, S, H, Hkv, D):
    """f32: q, out, dO and dQ; K, V, dK and dV; the log-sum-exp; the causal
    triangle's five products (S, dP, dV, dQ, dK)."""
    nbytes = 4 * (4 * B * H * S * D + 4 * B * Hkv * S * D + B * H * S)
    flops = 10 * H * D * S * (S + 1) // 2 * B
    return nbytes, flops


def _lora_grad_work(*, B, S, d_in, d_out, r, slots, ids):
    """f32: the live rows' x and dy, dx read and written, each live id's A
    and B, dA and dB of every slot of the table, the ids; h = x·A and
    g = dy·Bᵀ, then dA, dB and g·Aᵀ."""
    live = [i for i in ids if i >= 0]
    M_live = len(live) * S
    n_ids = len(set(live))
    nbytes = 4 * (M_live * (d_in + d_out) + 2 * M_live * d_in
                  + n_ids * r * (d_in + d_out) + slots * r * (d_in + d_out)) + 4 * B
    flops = 2 * M_live * r * (3 * d_in + 2 * d_out)
    return nbytes, flops


_WORK = {
    "fused_sgmv": _fused_sgmv_work,
    "sgmv": _delta_work,
    "ragged_extend": _ragged_extend_work,
    "paged_attention": _paged_attention_work,
    "flash_prefill": _flash_prefill_work,
    "flash_prefill_ragged": _flash_prefill_ragged_work,
    "flash_prefill_bwd": _flash_prefill_bwd_work,
    "lora_grad": _lora_grad_work,
}
KERNELS = tuple(_WORK)


def work(kernel: str, **shape) -> tuple[int, int]:
    """(bytes, flops): the least work of ``kernel`` on inputs of ``shape``
    (each input read once, each output written once, the flops this data
    needs: live rows and ids only, causal pairs only). The shape's keys are
    the keyword arguments of the kernel's function above, ``ids``,
    ``starts``, ``true_lens`` and ``lengths`` as Python sequences."""
    if kernel not in _WORK:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    return _WORK[kernel](**shape)


def bound_ms(nbytes: float, flops: float, dtype=torch.float32) -> tuple[float, str]:
    """The least time for ``nbytes`` and ``flops`` on the H100: the larger of
    the bytes over the memory rate and the flops over the peak rate of
    their type (f32 flops at the 3xTF32 rate, bf16 flops at the dense bf16
    rate), with what bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
