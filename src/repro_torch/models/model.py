"""Model facade (PyTorch counterpart of ``repro.models.model``): the dense
decoder only; training steps are ROADMAP Queue 1 item 9."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .transformer import LM


def build_model(cfg: ModelConfig, dtype=torch.float32, device=None) -> LM:
    """The dense decoder LM for ``cfg`` on ``device`` (default: the card,
    raising without one); other families raise ``NotImplementedError``
    naming their ROADMAP item."""
    return LM(cfg, dtype=dtype, device=device)
