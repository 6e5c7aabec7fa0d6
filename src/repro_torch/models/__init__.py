"""Dense GQA decoder (PyTorch counterpart of ``repro.models``)."""

from .model import build_model, make_decode_step, make_prefill_step
from .transformer import LM

__all__ = ["LM", "build_model", "make_decode_step", "make_prefill_step"]
