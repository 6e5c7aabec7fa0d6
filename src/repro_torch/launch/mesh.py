"""Production and debug meshes (PyTorch counterpart of
``repro.launch.mesh``).

:func:`production_axes` is the production mesh as the sharding rules read
it, {axis: size}: 16 × 16 ``data``/``model`` (one pod, 256 devices) or
2 × 16 × 16 ``pod``/``data``/``model`` (512). The dry run works from it
alone; :func:`make_production_mesh` builds the ``DeviceMesh`` only in a
process group that large. Functions, not module constants: importing
this module touches no process group.
"""

from __future__ import annotations

import math

import torch.distributed as dist


def production_axes(*, multi_pod: bool = False) -> dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh``: every rank of a default process group
    of 256 (512 with ``multi_pod``); any other world size raises."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = production_axes(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(axes.values()):
        raise RuntimeError(f"the production mesh {axes} needs {math.prod(axes.values())} "
                           f"ranks; this process group has {world}")
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def make_debug_mesh(n_devices: int | None = None, model: int = 1, device_type: str = "cpu"):
    """A ("data", "model") mesh over the first ``n_devices`` ranks of the
    current process group (all of them by default)."""
    from ..distributed.elastic import ElasticPlan, build_mesh

    n = n_devices or dist.get_world_size()
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    return build_mesh(ElasticPlan(data=n // model, model=model,
                                  dropped_devices=dist.get_world_size() - n), device_type)
