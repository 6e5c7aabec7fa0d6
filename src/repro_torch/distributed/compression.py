"""Gradient compression for the data-parallel all-reduce (PyTorch
counterpart of ``repro.distributed.compression``).

int8 quantization with error feedback: each leaf is quantized per row (the
trailing dim) to int8 with an f32 scale (absmax / 127, rounded half to
even, clipped to ±127), and the quantization residual is carried to the
next step. A 0-d leaf passes through with zero error. :func:`wire_bytes`
counts what a replica's all-reduce would move with and without it.

As in the reference, nothing applies it to a step: the train launcher's
``--compress`` builds the state and reports it, and the step all-reduces
f32 gradients (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class CompressionState:
    error: Any  # residual tree (the gradients' structure), f32


def init_state(grads_like) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization (rows = leading dims)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads, state: CompressionState):
    """Error feedback + the int8 round trip of a gradient tree: (the
    dequantized gradients, the new state with each leaf's residual)."""
    out, err = [], []
    for g, e in zip(leaves(grads), leaves(state.error)):
        x = g.float() + e
        if g.dim() == 0:
            out.append(x)
            err.append(torch.zeros_like(x))
            continue
        deq = _dequantize(*_quantize(x))
        out.append(deq)
        err.append(x - deq)
    return unflatten(grads, out), CompressionState(error=unflatten(state.error, err))


def wire_bytes(grads, compressed: bool) -> int:
    """Bytes a data-parallel all-reduce would move per replica: int8 values
    and an f32 scale a row, or the leaves as they are."""
    total = 0
    for g in leaves(grads):
        if compressed and g.dim() > 0:
            total += g.numel() + math.prod(g.shape[:-1]) * 4
        else:
            total += g.numel() * g.element_size()
    return total
