"""FASTLIBRA core: dependency-aware cache manager + performance-driven swapper."""

from .block_pool import BlockPool, PoolExhausted, Tier, blocks_for_lora, blocks_for_tokens
from .cache_manager import (
    AdmitResult,
    CacheManager,
    LookupResult,
    ManagerConfig,
    ManagerStats,
    SwapKind,
    SwapOp,
)
from .cost_model import (
    CostModelScorer,
    HardwareModel,
    LRUScorer,
    expected_lora_demand,
    sigmoid,
)
from .dependency_tree import (
    DependencyTree,
    MatchResult,
    Node,
    NodeKind,
    Residency,
)
from .invariants import (
    PoolInvariantError,
    check_pool_invariants,
    dump_tree,
    jit_cache_size,
    sanitize_enabled,
)
from .swapper import CacheSwapper, SwapperConfig, make_fastlibra

__all__ = [
    "AdmitResult",
    "BlockPool",
    "CacheManager",
    "CacheSwapper",
    "CostModelScorer",
    "DependencyTree",
    "HardwareModel",
    "LRUScorer",
    "LookupResult",
    "ManagerConfig",
    "ManagerStats",
    "MatchResult",
    "Node",
    "NodeKind",
    "PoolExhausted",
    "PoolInvariantError",
    "Residency",
    "SwapKind",
    "SwapOp",
    "SwapperConfig",
    "Tier",
    "blocks_for_lora",
    "blocks_for_tokens",
    "check_pool_invariants",
    "dump_tree",
    "expected_lora_demand",
    "jit_cache_size",
    "make_fastlibra",
    "sanitize_enabled",
    "sigmoid",
]
