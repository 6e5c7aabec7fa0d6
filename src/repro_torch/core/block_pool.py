"""Unified block pool for LoRAs and KV caches (FASTLIBRA §4.3).

Both HBM and host memory are partitioned into fixed-size blocks at init. KV
caches occupy whole blocks (``block_size`` tokens per block); LoRA adapters are
partitioned block-wise **along the rank dimension** so that every other
dimension aligns with the KV layout — one rank-block of a LoRA owns exactly one
pool block. This is what makes a *unified* pool possible (no fragmentation
between the two object kinds), mirroring the paper's extension of vLLM's
BlockManager.

The pool is a pure control-plane object: it hands out integer block ids per
tier. The data plane (``repro/kvcache``, ``repro/lora``) maps block ids to
slices of device/host arrays; the simulator maps them to byte accounting only.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

from .invariants import PoolInvariantError


class Tier(enum.Enum):
    """Memory tier a block lives in."""

    HBM = "hbm"
    HOST = "host"


class PoolExhausted(Exception):
    """Raised when an allocation cannot be satisfied in the requested tier."""


@dataclasses.dataclass
class PoolStats:
    hbm_total: int
    hbm_free: int
    host_total: int
    host_free: int

    @property
    def hbm_used(self) -> int:
        return self.hbm_total - self.hbm_free

    @property
    def hbm_usage(self) -> float:
        return 0.0 if self.hbm_total == 0 else self.hbm_used / self.hbm_total

    @property
    def host_used(self) -> int:
        return self.host_total - self.host_free


class BlockPool:
    """Two-tier (HBM + host) unified block allocator.

    Blocks are identified by dense integer ids per tier (``0..n_tier-1``);
    free-lists are LIFO so recently-freed blocks are reused first (better
    locality for the data plane's physical arrays).
    """

    def __init__(self, num_hbm_blocks: int, num_host_blocks: int, block_bytes: int):
        if num_hbm_blocks <= 0:
            raise ValueError("num_hbm_blocks must be positive")
        if num_host_blocks < 0:
            raise ValueError("num_host_blocks must be >= 0")
        self.num_hbm_blocks = num_hbm_blocks
        self.num_host_blocks = num_host_blocks
        self.block_bytes = block_bytes
        self._free: dict[Tier, list[int]] = {
            Tier.HBM: list(range(num_hbm_blocks - 1, -1, -1)),
            Tier.HOST: list(range(num_host_blocks - 1, -1, -1)),
        }
        self._allocated: dict[Tier, set[int]] = {Tier.HBM: set(), Tier.HOST: set()}

    # ------------------------------------------------------------------ alloc
    def free_blocks(self, tier: Tier) -> int:
        return len(self._free[tier])

    def can_allocate(self, tier: Tier, n: int) -> bool:
        return len(self._free[tier]) >= n

    def allocate(self, tier: Tier, n: int) -> list[int]:
        """Allocate ``n`` blocks in ``tier``; all-or-nothing."""
        free = self._free[tier]
        if len(free) < n:
            raise PoolExhausted(
                f"need {n} blocks in {tier.value}, only {len(free)} free"
            )
        out = [free.pop() for _ in range(n)]
        self._allocated[tier].update(out)
        return out

    def release(self, tier: Tier, block_ids: Iterable[int]) -> None:
        allocd = self._allocated[tier]
        for b in block_ids:
            if b not in allocd:
                raise KeyError(f"block {b} not allocated in {tier.value}")
            allocd.remove(b)
            self._free[tier].append(b)

    # ------------------------------------------------------------------ stats
    def stats(self) -> PoolStats:
        return PoolStats(
            hbm_total=self.num_hbm_blocks,
            hbm_free=len(self._free[Tier.HBM]),
            host_total=self.num_host_blocks,
            host_free=len(self._free[Tier.HOST]),
        )

    def hbm_usage(self) -> float:
        return self.stats().hbm_usage

    def check_invariants(self) -> None:
        """Invariant: free + allocated partitions the id space. Raises (not
        asserts — this must survive ``python -O``) on corruption."""
        for tier, total in ((Tier.HBM, self.num_hbm_blocks), (Tier.HOST, self.num_host_blocks)):
            free = set(self._free[tier])
            alloc = self._allocated[tier]
            if not free.isdisjoint(alloc):
                raise PoolInvariantError(f"{tier}: double-booked blocks")
            if len(free) + len(alloc) != total:
                raise PoolInvariantError(f"{tier}: leaked blocks")
            if free | alloc != set(range(total)):
                raise PoolInvariantError(f"{tier}: id space corrupt")


def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
    """Number of KV blocks needed for ``num_tokens`` tokens."""
    return -(-num_tokens // block_size)


def blocks_for_lora(rank: int, rank_block: int) -> int:
    """Number of pool blocks a LoRA of ``rank`` occupies (rank-dim paging)."""
    return -(-rank // rank_block)
