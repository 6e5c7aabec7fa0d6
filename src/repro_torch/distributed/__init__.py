"""Distributed substrate (PyTorch counterpart of ``repro.distributed``):
the serving request journal so far."""

from .checkpoint import RequestJournal

__all__ = ["RequestJournal"]
