"""The port's models (PyTorch counterpart of ``repro.models``): the
decoder LM of every decoder-only layout and the encoder-decoder LM, and
their train, prefill and decode steps."""

from .encdec import EncDecLM
from .model import (TrainState, build_model, cross_entropy, make_decode_step,
                    make_prefill_step, make_train_state, make_train_step)
from .transformer import LM

__all__ = ["EncDecLM", "LM", "TrainState", "build_model", "cross_entropy",
           "make_decode_step", "make_prefill_step", "make_train_state",
           "make_train_step"]
