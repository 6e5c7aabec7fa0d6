"""Elastic scaling / failure recovery (PyTorch counterpart of
``repro.distributed.elastic``).

The restart path, as in the reference:

  1. the surviving ranks are the world a restarted job sees (``torchrun``
     gives the size);
  2. :func:`plan_mesh` picks the largest (data, model) grid that fits, with
     the model axis dividing the architecture where asked;
  3. the state is restored from the latest checkpoint with the NEW mesh's
     shardings (``CheckpointManager.restore(shardings=...)``), each rank
     reading its own slice of every whole leaf;
  4. the serving engine replays its ``RequestJournal``.

:func:`reshard` moves a live tree from one mesh's shardings to another's
(gather each leaf whole, then slice it), as the reference's
``device_get`` + ``device_put`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import flatten_with_names, unflatten


@dataclasses.dataclass
class ElasticPlan:
    data: int
    model: int
    dropped_devices: int

    @property
    def size(self) -> int:
        return self.data * self.model


def _divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def plan_mesh(n_healthy: int, *, preferred_model: int = 16,
              model_divisor_of: Optional[int] = None) -> ElasticPlan:
    """Largest usable (data, model) grid from ``n_healthy`` devices, the
    model axis at most ``preferred_model`` and, with ``model_divisor_of``,
    dividing it (e.g. the head count, so tensor parallelism stays valid)."""
    best: Optional[ElasticPlan] = None
    for used in range(n_healthy, 0, -1):
        for model in _divisors_desc(used):
            if model > preferred_model:
                continue
            if model_divisor_of is not None and model_divisor_of % model != 0:
                continue
            plan = ElasticPlan(data=used // model, model=model,
                               dropped_devices=n_healthy - used)
            if best is None or plan.size > best.size or (
                    plan.size == best.size and plan.model > best.model):
                best = plan
        if best is not None and best.size == used:
            break
    if best is None:
        raise RuntimeError("no feasible (data, model) plan for the surviving devices")
    return best


def build_mesh(plan: ElasticPlan, device_type: str):
    """A ("data", "model") ``DeviceMesh`` over the first ``plan.size`` ranks
    of the default process group (every rank calls this; a rank past the
    plan belongs to no mesh: ``get_coordinate()`` is None)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(plan.size).reshape(plan.data, plan.model),
                      mesh_dim_names=("data", "model"))


def reshard(tree, old_shardings: dict, new_shardings: dict):
    """``tree``'s local leaves (on ``old_shardings``) gathered whole and
    sliced for ``new_shardings``: a collective over both meshes."""
    return unflatten(tree, [new_shardings[n].local(old_shardings[n].gather(t))
                            for n, t in flatten_with_names(tree)])
