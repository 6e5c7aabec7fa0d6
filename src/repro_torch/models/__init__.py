"""The port's models (PyTorch counterpart of ``repro.models``): the
decoder LM of every decoder-only layout and the encoder-decoder LM."""

from .encdec import EncDecLM
from .model import build_model, make_decode_step, make_prefill_step
from .transformer import LM

__all__ = ["EncDecLM", "LM", "build_model", "make_decode_step", "make_prefill_step"]
