"""Multi-LoRA substrate: adapter store (PyTorch counterpart of ``repro.lora``)."""

from .adapter import AdapterStore, AdapterWeights

__all__ = ["AdapterStore", "AdapterWeights"]
