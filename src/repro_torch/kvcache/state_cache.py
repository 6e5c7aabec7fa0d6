"""Prefix *state* caching for the recurrent layouts (PyTorch counterpart of
``repro.kvcache.state_cache``).

RWKV-6 and the RG-LRU hybrid carry a fixed-size recurrent state instead of
a per-token KV cache. FASTLIBRA's dependency tree holds STATE snapshot
nodes for them: the state at a prefix boundary. Matching a prefix returns
the deepest snapshot and decoding resumes from it. One snapshot occupies
``ceil(snapshot_bytes / block_bytes)`` blocks of the unified pool.

This is the data plane: a two-tier snapshot store addressed by the pool's
block ids, and the helpers that move one batch row of a model cache in and
out of it. The control plane is ``core.cache_manager`` (``lookup_state`` /
``commit_state``); ``serving.engine`` wires the two together.

The device tier is one device tensor (n_hbm_blocks, floats per block); the
host tier a CPU tensor of the same rows, pinned when the device is CUDA.
``store`` and ``load`` move a snapshot through index tensors on the device.
A swap copies each block on the current stream (``non_blocking``), as
``PagedKVPool`` does: copies queue behind the work that produced the
blocks and ahead of the work that reads them, and nothing on the host
reads pinned rows that a queued copy is still writing.

A snapshot is one row of every cache leaf but ``len``, in sorted key
order, flattened and cast to the store's dtype: the reference's layout, so
a flattened snapshot of the port equals the reference's element for
element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..device import resolve_device


@dataclasses.dataclass
class StateSpec:
    """Flattened recurrent-state snapshot layout."""

    state_elems: int  # elements of one sequence's full-model state snapshot
    block_bytes: int  # unified pool block size (bytes)
    dtype: torch.dtype = torch.float32  # snapshot storage dtype

    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def snapshot_bytes(self) -> int:
        return self.state_elems * self.dtype_bytes

    @property
    def blocks_per_snapshot(self) -> int:
        return -(-self.snapshot_bytes // self.block_bytes)


class StateCache:
    """Two-tier store of flattened state snapshots, block-addressed."""

    def __init__(self, spec: StateSpec, n_hbm_blocks: int, n_host_blocks: int,
                 device=None):
        """``device`` defaults to the card and raises without one."""
        self.spec = spec
        per_block = spec.block_bytes // spec.dtype_bytes
        if per_block < 1:
            raise ValueError("block_bytes smaller than one state element")
        self.per_block = per_block
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"  # pin_memory raises on CPU-only torch
        self.hbm = torch.zeros((n_hbm_blocks, per_block), dtype=spec.dtype,
                               device=self.device)
        self.host = torch.zeros((n_host_blocks, per_block), dtype=spec.dtype,
                                pin_memory=pin)
        self.swap_outs = self.swap_ins = 0  # snapshots moved each way
        self.swap_out_bytes = self.swap_in_bytes = 0

    def _idx(self, block_ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(block_ids), dtype=torch.int64).to(
            self.device, non_blocking=True)

    def store(self, block_ids: Sequence[int], flat_state: torch.Tensor) -> None:
        """Write ``flat_state`` (n,) into the device blocks ``block_ids``,
        zero-padded to whole blocks."""
        if not block_ids:
            raise ValueError("cannot store a snapshot into zero blocks")
        capacity = len(block_ids) * self.per_block
        n = flat_state.shape[0]
        if n > capacity:
            raise ValueError(
                f"snapshot of {n} elements exceeds the "
                f"{capacity}-element capacity of {len(block_ids)} blocks")
        rows = torch.nn.functional.pad(flat_state.to(self.spec.dtype), (0, capacity - n))
        self.hbm.index_copy_(0, self._idx(block_ids),
                             rows.view(len(block_ids), self.per_block))

    def load(self, block_ids: Sequence[int], n_elems: int) -> torch.Tensor:
        """The first ``n_elems`` elements held by the device blocks."""
        if n_elems > len(block_ids) * self.per_block:
            raise ValueError(
                f"requested {n_elems} elements from {len(block_ids)} blocks "
                f"holding at most {len(block_ids) * self.per_block}")
        return self.hbm.index_select(0, self._idx(block_ids)).view(-1)[:n_elems]

    def _pairs(self, src: Sequence[int], dst: Sequence[int]) -> list:
        if len(src) != len(dst):
            raise ValueError(f"swap of {len(src)} blocks into {len(dst)}")
        return list(zip(src, dst))

    def swap_out(self, hbm_blocks: Sequence[int], host_blocks: Sequence[int]) -> None:
        """Copy device blocks to host blocks (device->host transfer)."""
        if not hbm_blocks:  # hollow-node op: structure moved, no payload
            return
        for src, dst in self._pairs(hbm_blocks, host_blocks):
            self.host[dst].copy_(self.hbm[src], non_blocking=True)
        self.swap_outs += 1
        self.swap_out_bytes += len(hbm_blocks) * self.spec.block_bytes

    def swap_in(self, host_blocks: Sequence[int], hbm_blocks: Sequence[int]) -> None:
        """Copy host blocks to device blocks (host->device transfer)."""
        if not host_blocks:
            return
        for src, dst in self._pairs(host_blocks, hbm_blocks):
            self.hbm[dst].copy_(self.host[src], non_blocking=True)
        self.swap_ins += 1
        self.swap_in_bytes += len(host_blocks) * self.spec.block_bytes


def _state_items(cache: dict) -> list:
    """Snapshot leaves of a cache in sorted key order: every leaf but the
    per-row ``len`` counter, which the engine tracks."""
    return [(k, v) for k, v in sorted(cache.items()) if k != "len"]


def _row_shape(leaf: torch.Tensor) -> tuple[int, ...]:
    """Shape of one batch row of a cache leaf (the batch axis is 1 in the
    layer-stacked (L, B, ...) layout, 0 for a flat (B,) leaf)."""
    return (*leaf.shape[:1], *leaf.shape[2:]) if leaf.dim() > 1 else ()


def _row(leaf: torch.Tensor, row: int) -> torch.Tensor:
    return leaf[:, row] if leaf.dim() > 1 else leaf[row]


def flat_state_elems(cache: dict) -> int:
    """Elements of one batch row's flattened snapshot (shapes only)."""
    return sum(math.prod(_row_shape(leaf)) for _, leaf in _state_items(cache))


def flatten_state(cache: dict, row: int, dtype=torch.float32) -> torch.Tensor:
    """One batch row of a model cache (minus ``len``), flattened: a new
    tensor on the cache's device."""
    return torch.cat([_row(leaf, row).reshape(-1).to(dtype)
                      for _, leaf in _state_items(cache)])


def unflatten_state(cache: dict, row: int, flat: torch.Tensor) -> dict:
    """Inverse of :func:`flatten_state`: write ``flat`` into ``row`` of
    every snapshot leaf, in place (cast to each leaf's dtype), and return
    the cache. Where the reference returns a new cache pytree, this one
    writes the row. ``cache["len"]`` is left as it is: the engine sets it
    to the snapshot's prefix boundary."""
    expected = flat_state_elems(cache)
    if flat.shape[0] != expected:
        raise ValueError(
            f"snapshot of {flat.shape[0]} elements does not match the "
            f"{expected}-element cache row layout")
    off = 0
    for _, leaf in _state_items(cache):
        shape = _row_shape(leaf)
        n = math.prod(shape)
        _row(leaf, row).copy_(flat[off:off + n].view(shape))
        off += n
    return cache


def state_floats(cfg, batch: int = 1, window: int | None = None) -> int:
    """Element count of one sequence's full recurrent-state snapshot (the
    reference's name; multiply by the store dtype's width for bytes). For
    the RG-LRU hybrid the snapshot also carries the local-attention layers'
    window K/V (``window`` tokens, default ``cfg.window_size``)."""
    if cfg.rwkv is not None:
        hd = cfg.rwkv.head_dim
        H = cfg.d_model // hd
        per_layer = H * hd * hd + 2 * cfg.d_model
        return per_layer * cfg.num_layers
    if cfg.rglru is not None:
        pat = cfg.rglru.block_pattern
        n_rec = sum(1 for i in range(cfg.num_layers) if pat[i % len(pat)] == "rec")
        n_attn = cfg.num_layers - n_rec
        w = cfg.rglru.lru_width or cfg.d_model
        rec = n_rec * (w + (cfg.rglru.conv_width - 1) * w)
        win = window if window is not None else (cfg.window_size or 0)
        attn = 2 * n_attn * win * cfg.num_kv_heads * cfg.resolved_head_dim
        return rec + attn
    raise ValueError("state caching applies to SSM/hybrid archs only")
