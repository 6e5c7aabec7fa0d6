"""Physical paged KV store: two-tier (device + host) block arrays
(PyTorch counterpart of ``repro.kvcache.paged``).

The control plane (``repro_torch.core.BlockPool``) hands out integer block
ids; this module maps them to rows of physical tensors. Both tiers are
block-major, ``(n_blocks, L, block_size, Hkv, D)`` for k and for v, so one
block is one contiguous span in either tier and a swap is one copy per block.
The host tier lives in pinned memory when the device is CUDA, and swaps are
``non_blocking`` copies on the current stream: they queue behind the work
that produced the blocks and ahead of the work that reads them, without
stopping the host.

Running queries use the model's dense per-sequence cache; the pool is
touched at admission (``gather`` matched prefix blocks into the dense rows)
and at commit (``scatter`` the new suffix into blocks), as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..device import resolve_device

@dataclasses.dataclass
class KVPoolSpec:
    num_layers: int
    block_size: int  # tokens per block
    kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    @property
    def bytes_per_token(self) -> int:
        per = 2 * self.num_layers * self.kv_heads * self.head_dim
        return per * torch.empty((), dtype=self.dtype).element_size()

    @property
    def block_bytes(self) -> int:
        return self.bytes_per_token * self.block_size


class PagedKVPool:
    """Two-tier physical KV block store."""

    def __init__(self, spec: KVPoolSpec, n_hbm_blocks: int, n_host_blocks: int,
                 device=None):
        """``device`` defaults to the card and raises without one."""
        self.spec = s = spec
        self.device = resolve_device(device)
        blk = (s.num_layers, s.block_size, s.kv_heads, s.head_dim)
        pin = self.device.type == "cuda"  # pin_memory raises on CPU-only torch
        self.k_hbm = torch.zeros((n_hbm_blocks, *blk), dtype=s.dtype, device=self.device)
        self.v_hbm = torch.zeros((n_hbm_blocks, *blk), dtype=s.dtype, device=self.device)
        self.k_host = torch.zeros((n_host_blocks, *blk), dtype=s.dtype, pin_memory=pin)
        self.v_host = torch.zeros((n_host_blocks, *blk), dtype=s.dtype, pin_memory=pin)
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0

    def _idx(self, block_ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(block_ids), dtype=torch.int64).to(
            self.device, non_blocking=True)

    # ------------------------------------------------------------- gather
    def gather(self, block_ids: Sequence[int]) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Device blocks -> dense (L, T, Hkv, D)."""
        s = self.spec
        idx = self._idx(block_ids)

        def dense(pool):
            rows = pool.index_select(0, idx)  # (n, L, bs, H, D)
            return rows.transpose(0, 1).reshape(s.num_layers, -1, s.kv_heads, s.head_dim)

        return dense(self.k_hbm), dense(self.v_hbm)

    # ------------------------------------------------------------ scatter
    def scatter(self, block_ids: Sequence[int], k_dense: torch.Tensor,
                v_dense: Optional[torch.Tensor] = None) -> None:
        """Dense (L, T, Hkv, D), T = len(block_ids) * block_size -> blocks."""
        s = self.spec
        n = len(block_ids)
        idx = self._idx(block_ids)

        def blocks(dense):
            return dense.reshape(s.num_layers, n, s.block_size, s.kv_heads,
                                 s.head_dim).transpose(0, 1).to(s.dtype)

        self.k_hbm.index_copy_(0, idx, blocks(k_dense))
        if v_dense is not None:
            self.v_hbm.index_copy_(0, idx, blocks(v_dense))

    # --------------------------------------------------------------- swaps
    def swap_out(self, hbm_blocks: Sequence[int], host_blocks: Sequence[int]) -> None:
        """Copy device blocks to host blocks (device->host transfer)."""
        pairs = list(zip(hbm_blocks, host_blocks))
        for src, dst in pairs:
            self.k_host[dst].copy_(self.k_hbm[src], non_blocking=True)
            self.v_host[dst].copy_(self.v_hbm[src], non_blocking=True)
        self.swap_out_bytes += len(pairs) * self.spec.block_bytes

    def swap_in(self, host_blocks: Sequence[int], hbm_blocks: Sequence[int]) -> None:
        """Copy host blocks to device blocks (host->device transfer)."""
        pairs = list(zip(host_blocks, hbm_blocks))
        for src, dst in pairs:
            self.k_hbm[dst].copy_(self.k_host[src], non_blocking=True)
            self.v_hbm[dst].copy_(self.v_host[src], non_blocking=True)
        self.swap_in_bytes += len(pairs) * self.spec.block_bytes
