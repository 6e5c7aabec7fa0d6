"""AdamW on trees of tensors (PyTorch counterpart of
``repro.optim.adamw``): f32 moments whatever the parameters' dtype,
decoupled weight decay, the reference's exact update

    m = b1·m + (1 − b1)·g,  v = b2·v + (1 − b2)·g²
    p = p − lr·((m / b1c) / (sqrt(v / b2c) + eps) + wd·p)

with the bias corrections b1c = 1 − b1^t, b2c = 1 − b2^t in f32. Trees are
nested dicts, tuples and lists of tensors (``None`` an empty subtree), as
:mod:`repro_torch.tree` walks them. The update is functional, as the
reference's: it returns new parameters and a new state and leaves its
inputs as they are. The moments live beside their parameters; the step
count is a host-side int32 scalar, so the bias corrections cost no device
round trip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class OptState:
    m: Any
    v: Any
    step: torch.Tensor  # () int32, on the host


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor on
    the leaves' device)."""
    ls = [t.float() for t in leaves(tree)]
    if not ls:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([torch.sum(t * t) for t in ls]).sum().sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), in f32; norm),
    the norm taken before the clip. Nothing waits on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _bias_corrections(b1: float, b2: float, step: int) -> tuple[float, float]:
    """1 − b^t in f32, as the reference computes them."""
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(b1) ** t),
            float(np.float32(1.0) - np.float32(b2) ** t))


def adamw_update(grads, state: OptState, params, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0,
                 mask=None):
    """Returns (new_params, new_state). ``mask`` (a tree of bools shaped
    like ``params``) freezes the leaves where it is False: they keep their
    parameters and moments. ``lr`` may be a float or a 0-d tensor."""
    step = int(state.step) + 1
    b1c, b2c = _bias_corrections(b1, b2, step)
    lr = float(lr)
    g = [t.float() for t in leaves(grads)]
    m_old, v_old, p_old = leaves(state.m), leaves(state.v), leaves(params)
    if not (len(g) == len(m_old) == len(v_old) == len(p_old)):
        raise ValueError("grads, moments and params must be trees of one shape")
    keep = [True] * len(p_old) if mask is None else [bool(k) for k in leaves(mask)]
    idx = [i for i, k in enumerate(keep) if k]
    new_m, new_v, new_p = list(m_old), list(v_old), list(p_old)
    if idx:
        gs = [g[i] for i in idx]
        ms = torch._foreach_mul([m_old[i] for i in idx], b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
        vs = torch._foreach_mul([v_old[i] for i in idx], b2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
        num = torch._foreach_div(ms, b1c)
        den = torch._foreach_sqrt(torch._foreach_div(vs, b2c))
        torch._foreach_add_(den, eps)
        delta = torch._foreach_div(num, den)
        ps = [p_old[i].float() for i in idx]
        if weight_decay:
            torch._foreach_add_(delta, torch._foreach_mul(ps, weight_decay))
        ps = torch._foreach_sub(ps, torch._foreach_mul(delta, lr))
        for j, i in enumerate(idx):
            new_m[i], new_v[i] = ms[j], vs[j]
            new_p[i] = ps[j].to(p_old[i].dtype)
    return (unflatten(params, new_p),
            OptState(m=unflatten(state.m, new_m), v=unflatten(state.v, new_v),
                     step=torch.tensor(step, dtype=torch.int32)))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step): linear warm-up to ``base_lr`` over ``warmup`` steps, then
    a half cosine to 0 at ``total`` (a Python float, in f32 arithmetic as
    the reference's)."""

    def lr(step) -> float:
        s = np.float32(step)
        if s < warmup:
            return float(np.float32(base_lr) * s / np.float32(max(1, warmup)))
        frac = np.clip((s - np.float32(warmup)) / np.float32(max(1, total - warmup)),
                       np.float32(0.0), np.float32(1.0))
        return float(np.float32(base_lr) * np.float32(0.5)
                     * (np.float32(1.0) + np.cos(np.float32(math.pi) * frac)))

    return lr


def lora_only_mask(params_with_lora, lora_key: str = "lora"):
    """Bool mask: True only under the ``lora_key`` subtree (``None``, an
    empty subtree, stays ``None``)."""

    def walk(tree, in_lora):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, in_lora or k == lora_key) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, in_lora) for v in tree)
        return in_lora

    return walk(params_with_lora, False)
