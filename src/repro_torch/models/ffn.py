"""Gated dense feed-forward (PyTorch counterpart of ``repro.models.ffn``;
the MoE FFN is ROADMAP Queue 1 item 2)."""

from __future__ import annotations

import torch

from .common import activation, dense_init


def init_dense_ffn(gen: torch.Generator, n_layers: int, d: int, d_ff: int,
                   dtype=torch.float32, device=None) -> dict:
    """Layer-stacked SwiGLU/GeGLU weights, (n_layers, ...) per leaf."""
    return {
        "w_gate": dense_init(gen, (n_layers, d, d_ff), dtype, device),
        "w_up": dense_init(gen, (n_layers, d, d_ff), dtype, device),
        "w_down": dense_init(gen, (n_layers, d_ff, d), dtype, device),
    }


def dense_ffn(p: dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
