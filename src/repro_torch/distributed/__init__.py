"""Distributed substrate (PyTorch counterpart of ``repro.distributed``):
the training checkpoint manager and the serving request journal. One card,
no mesh: sharding, the elastic mesh and gradient compression are ROADMAP
Queue 1 item 7."""

from .checkpoint import CheckpointManager, RequestJournal

__all__ = ["CheckpointManager", "RequestJournal"]
