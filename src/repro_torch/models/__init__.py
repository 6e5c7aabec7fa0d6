"""Dense GQA decoder (PyTorch counterpart of ``repro.models``)."""

from .model import build_model
from .transformer import LM

__all__ = ["LM", "build_model"]
