"""Paged KV cache and recurrent-state snapshot cache (PyTorch counterpart
of ``repro.kvcache``)."""

from .paged import KVPoolSpec, PagedKVPool
from .state_cache import (
    StateCache,
    StateSpec,
    flat_state_elems,
    flatten_state,
    state_floats,
    unflatten_state,
)

__all__ = [
    "KVPoolSpec",
    "PagedKVPool",
    "StateCache",
    "StateSpec",
    "flat_state_elems",
    "flatten_state",
    "state_floats",
    "unflatten_state",
]
