"""The sharded train step: the torch counterpart of what GSPMD makes of the
reference's ``make_train_step`` under the placements of
:mod:`repro_torch.distributed.sharding`, on a ("data", "model")
``DeviceMesh``.

Each rank holds its local shards of the train state as plain tensors
(:func:`train_state_specs`, ``make_shardings``, ``shard_tree``) and its
rows of the batch (``batch_specs``). A step:

* the forward on the local shards, with the tensor- and
  expert-parallel collectives of
  :mod:`repro_torch.distributed.tensor_parallel` where ``model`` > 1, for
  every family: dense GQA, MLA, MoE (each rank its experts), RWKV-6, the
  RG-LRU hybrid and the encoder-decoder;
* the cross-entropy of the rank's rows divided by the whole batch's count
  of labelled positions (an all-reduce over ``data``), so the gradients,
  summed over ``data``, are those of the global mean, as GSPMD computes
  it, whatever the rows' counts; an MoE fills its experts' queues and
  counts their load over the whole batch (``moe_ffn``'s ``data_group``),
  and the mean of the ranks' auxiliary losses is the whole batch's;
* the global gradient norm: squared norms of leaves sharded over
  ``model`` summed over their shards, replicated leaves counted once;
* AdamW under ZeRO-1: a leaf whose moments ``moment_specs`` shards over
  ``data`` is updated on this rank's slice of that dim, with its slices of
  the gradient and the parameter, and the new parameter slices are
  all-gathered over ``data``.

Losses, gradient norms and weights equal a single process's
``make_train_step`` with its default settings (within the sums' orders):
the full-parameter step, weight decay, clip norm and the MoE auxiliary
loss's weight are ``models.model``'s constants.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.model import (CLIP_NORM, MOE_AUX_WEIGHT, WEIGHT_DECAY, TrainState,
                            cross_entropy, forward_logits, value_and_grads)
from ..optim import adamw_update
from ..tree import flatten_with_names, unflatten
from .sharding import axis_sizes, moment_specs, param_specs, spec_axes
from .tensor_parallel import TensorParallel, gather_from


def train_state_specs(state: TrainState, mesh, cfg=None) -> dict[str, tuple]:
    """The spec of every leaf of a whole ``TrainState``, by its path name:
    params and LoRA by ``param_specs``, the AdamW moments by
    ``moment_specs`` (as the reference's launcher places them, without
    ``cfg``), the step counters replicated."""
    out = {}
    for prefix, specs in (("params", param_specs(state.params, mesh, cfg)),
                          ("lora", param_specs(state.lora, mesh, cfg)),
                          ("opt/m", moment_specs(state.opt.m, mesh, cfg)),
                          ("opt/v", moment_specs(state.opt.v, mesh, cfg))):
        out.update({f"{prefix}/{n}": s for n, s in specs.items()})
    out["opt/step"] = out["step"] = ()
    return out


def _all_reduce_flat(tensors: list, group) -> list:
    """Sums over ``group`` of f32 tensors, as one flat all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [c.view_as(t) for c, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_sharded_train_step(model, shardings: dict, *, lr: float = 3e-4):
    """train_step(local state, local batch) -> (new local state, {"loss",
    "grad_norm"}), both metrics whole (equal on every rank).
    ``shardings``: ``make_shardings(train_state_specs(state, mesh), mesh)``
    of the whole state, on a ("data", "model") ``DeviceMesh``."""
    mesh = next(iter(shardings.values())).mesh
    axes = axis_sizes(mesh)
    if tuple(axes) != ("data", "model"):
        raise ValueError(f"a ('data', 'model') mesh, not {tuple(axes)}")
    n_data, n_model = axes["data"], axes["model"]
    cfg = model.cfg
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    data_index = mesh.get_coordinate()[0]
    if n_model > 1:
        specs = {n[len("params/"):]: s.spec for n, s in shardings.items()
                 if n.startswith("params/")}
        model = dataclasses.replace(model, tp=TensorParallel(
            model_group, n_model, mesh.get_coordinate()[1], specs))
    if n_data > 1 and cfg.moe is not None:
        model = dataclasses.replace(model, data_group=data_group)

    def on_model(name: str) -> bool:
        return any("model" in spec_axes(e) for e in shardings[name].spec)

    def zero_dim(name: str):
        spec = shardings[f"opt/m/{name}"].spec
        dims = [d for d, e in enumerate(spec) if "data" in spec_axes(e)]
        return dims[0] if dims and n_data > 1 else None

    def loss_fn(tree, batch):
        logits, aux = forward_logits(model, tree["params"], tree["lora"], batch)
        labels = torch.as_tensor(batch["labels"]).to(logits.device)
        count = (labels != -1).sum()
        dist.all_reduce(count, group=data_group)
        ce = cross_entropy(logits, labels, count=count)
        return ce + MOE_AUX_WEIGHT * aux / n_data, ce

    def train_step(state: TrainState, batch: dict):
        trainable = {"params": state.params, "lora": state.lora}
        names = [n for n, _ in flatten_with_names(trainable)]
        (_, ce), grads = value_and_grads(trainable, lambda tr: loss_fn(tr, batch))
        grads = [g.float() for g in grads]
        if n_data > 1:
            grads = _all_reduce_flat(grads, data_group)
        sq = [(torch.sum(g * g), on_model(n)) for g, n in zip(grads, names)]
        zero = grads[0].new_zeros(())
        sharded = sum((s for s, on in sq if on), zero)
        replicated = sum((s for s, on in sq if not on), zero)
        dist.all_reduce(sharded, group=model_group)
        gnorm = (sharded + replicated).sqrt()
        scale = torch.clamp(CLIP_NORM / (gnorm + 1e-9), max=1.0)
        grads = list(torch._foreach_mul(grads, scale))
        # ZeRO-1: this data rank's slice of each leaf whose moments are sliced
        params = [t for _, t in flatten_with_names(trainable)]
        cut = []
        for i, n in enumerate(names):
            d = zero_dim(n)
            if d is not None:
                size = params[i].shape[d] // n_data
                grads[i] = grads[i].narrow(d, data_index * size, size)
                params[i] = params[i].narrow(d, data_index * size, size)
                cut.append((i, d))
        new, opt = adamw_update(unflatten(trainable, grads), state.opt,
                                unflatten(trainable, params), lr, weight_decay=WEIGHT_DECAY)
        new_leaves = [t for _, t in flatten_with_names(new)]
        for i, d in cut:
            new_leaves[i] = gather_from(new_leaves[i], d, data_group)
        new = unflatten(trainable, new_leaves)
        loss = ce.detach().clone()
        dist.all_reduce(loss, group=data_group)
        return (TrainState(params=new["params"], lora=new["lora"], opt=opt,
                           step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return train_step
