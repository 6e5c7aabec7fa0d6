"""Feed-forward variants (PyTorch counterpart of ``repro.models.ffn``):
the gated dense FFN and the capacity-based MoE."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig
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


# --------------------------------------------------------------------- MoE
def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype=torch.float32, device=None) -> dict:
    """Layer-stacked MoE weights: {"router" (L, d, E) f32, "w_gate"/"w_up"
    (L, E, d, ff), "w_down" (L, E, ff, d), ["shared": a dense FFN of
    ff·num_shared]}, the reference's tree.

    Unlike the reference, whose init repeats ONE expert E times (so every
    routing gives the same output), each expert is drawn on its own: with
    random weights, a routing fault then shows in the outputs. Tests that
    hold the port against the reference bridge the reference's weights."""
    m = cfg.moe
    if m is None:
        raise ValueError("init_moe requires cfg.moe to be configured")
    d, ff, E, L = cfg.d_model, m.d_ff_expert, m.num_experts, n_layers
    p = {
        "router": dense_init(gen, (L, d, E), torch.float32, device),
        "w_gate": dense_init(gen, (L, E, d, ff), dtype, device),
        "w_up": dense_init(gen, (L, E, d, ff), dtype, device),
        "w_down": dense_init(gen, (L, E, ff, d), dtype, device),
    }
    if m.num_shared:
        p["shared"] = init_dense_ffn(gen, L, d, ff * m.num_shared, dtype, device)
    return p


def route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """The router's choice for each of the T tokens ``xt`` (T, d): the
    softmax over experts in f32 (T, E), the top-k gates renormalised
    (T, k) and their experts (T, k)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_ids


def add_choices(gk: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): a token's k weighted expert outputs added in
    order, each add in gk's dtype, as the reference's scatter-add rounds
    every add to it (bf16). k - 1 elementwise launches; one sum over k
    would round once (scripts/moe_combine_ab.py times the two)."""
    out = gk[:, 0]
    for j in range(1, gk.shape[1]):
        out = out + gk[:, j]
    return out


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            data_group=None, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE with the reference's dropping dispatch
    (``repro.models.ffn.moe_ffn``). Returns ``(out, aux_loss)``.

    Every one of the T = B·S tokens is routed, pads and idle rows included,
    and each expert takes at most ``C = max(1, int(T·k·cf / E))`` of the
    (token, k) pairs, in the row-major order of the flattened (T·k) pairs;
    the rest are dropped. Kept pairs have distinct (expert, slot) places,
    so the dispatch is a plain indexed write, and the combine is a gather
    to (T, k, d) summed over k: no atomics, so a repeated step gives the
    same bits on the card, and nothing waits on the device. Shared experts
    add a dense FFN; ``aux_loss`` is the Switch load-balancing loss
    ``E·Σ_e f_e·p_e``.

    ``data_group``: the data-parallel ranks that hold the batch's rows, this
    rank's ``x`` the rows of its index among them (equal shares). The
    queues are then the whole batch's: C counts every rank's tokens, and
    the pairs of the ranks before this one fill them first (an all-gather
    of the E queue lengths). ``f_e`` is the whole batch's load (an
    all-reduce) and ``p_e`` this rank's mean, so the mean of the ranks'
    ``aux_loss`` is the whole batch's, gradients included.

    ``tp`` (a ``distributed.tensor_parallel.TensorParallel``): where its
    axis divides E, the expert stacks hold this rank's E/M experts. Every
    rank routes the (replicated) tokens as one process would, with the same
    C and queue places, runs only its experts and combines only their
    outputs; an all-reduce completes the sum. The tokens and the gates
    enter the rank's experts through ``copy_to``, so their gradients (and
    the router's through the gates) are summed over the axis, while the
    auxiliary loss, computed alike on every rank from the replicated
    routing, reaches the router once."""
    m = cfg.moe
    act = activation(cfg.activation)
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    xt = x.reshape(T, d)
    probs, gate_vals, expert_ids = route(p["router"], xt, k)
    n = 1 if data_group is None else dist.get_world_size(data_group)
    C = max(1, int(n * T * k * m.capacity_factor / E))
    flat_e = expert_ids.reshape(-1)  # (T·k,)
    onehot = F.one_hot(flat_e, E)  # (T·k, E) int64
    slot = (onehot.cumsum(0) * onehot).sum(-1) - 1  # place in its expert's queue
    room = C
    if n > 1:  # the places the ranks before this one leave in each queue
        lengths = [torch.empty(E, dtype=onehot.dtype, device=x.device) for _ in range(n)]
        dist.all_gather(lengths, onehot.sum(0), group=data_group)
        before = sum(lengths[:dist.get_rank(data_group)], torch.zeros_like(lengths[0]))
        room = (C - before)[flat_e]
    keep = slot < room
    w = gate_vals.reshape(-1, 1).to(x.dtype)
    part = None if tp is None or p["w_gate"].shape[0] == E else tp.units(E)
    src = xt
    if part is not None:  # this rank's experts: a pair of another's is not kept here
        keep = keep & (flat_e >= part[0]) & (flat_e < part[1])
        flat_e = (flat_e - part[0]).clamp(0, part[1] - part[0] - 1)
        src, w = tp.fan(xt), tp.fan(w)
    # dropped pairs all go to one spare place past the queue, which no kept
    # pair reads: no boolean indexing, so no wait on the device. A queue
    # holds at most C pairs, and at most this rank's T·k
    places = min(C, T * k)
    slot = torch.where(keep, slot, places)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    disp = x.new_zeros((p["w_gate"].shape[0], places + 1, d))
    disp[flat_e, slot] = src[tok]
    h = act(torch.bmm(disp, p["w_gate"])) * torch.bmm(disp, p["w_up"])
    eout = torch.bmm(h, p["w_down"])  # (experts, places + 1, d)
    gathered = torch.where(keep[:, None], eout[flat_e, slot], 0)  # (T·k, d)
    out = add_choices((gathered * w).reshape(T, k, d))
    if part is not None:
        out = tp.reduce(out)
    if "shared" in p:
        out = out + dense_ffn(p["shared"], xt, cfg.activation)
    density = F.one_hot(expert_ids, E).float().mean(dim=(0, 1))
    if n > 1:
        dist.all_reduce(density, group=data_group)
        density = density / n
    aux = E * torch.sum(density * probs.mean(0))
    return out.reshape(B, S, d), aux
