"""Paged KV cache (PyTorch counterpart of ``repro.kvcache``; the recurrent
state cache is ROADMAP Queue 1 item 7)."""

from .paged import KVPoolSpec, PagedKVPool

__all__ = ["KVPoolSpec", "PagedKVPool"]
