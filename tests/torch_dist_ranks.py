"""Rank functions for ``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_families.py``. The ranks are spawned
processes that import this module by name, so it imports no JAX: weights
and batches arrive as numpy arrays, results leave as numpy."""

import contextlib
import dataclasses
import io

import numpy as np
import torch

from repro_torch import bridge, configs
from repro_torch.distributed import (ElasticPlan, batch_specs, build_mesh, make_shardings,
                                     reshard)
from repro_torch.distributed.sharded_step import make_sharded_train_step, train_state_specs
from repro_torch.distributed.sharding import axis_sizes, gather_tree, shard_tree
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import TrainState, build_model
from repro_torch.optim import OptState, adamw_init
from repro_torch.tree import flatten_with_names


def model_of(arch: str, overrides: dict):
    """The reduced config of ``arch`` with ``overrides`` of its fields."""
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)), **overrides)
    return build_model(cfg, dtype=torch.float32, device="cpu")


def mesh_of(data: int, model: int):
    return build_mesh(ElasticPlan(data=data, model=model, dropped_devices=0), "cpu")


def initial_state(params, lora) -> TrainState:
    """Step 0 from numpy weights: zero moments over params and LoRA."""
    params, lora = bridge.tensor_tree(params, "cpu"), bridge.tensor_tree(lora, "cpu")
    return TrainState(params=params, lora=lora, opt=adamw_init({"params": params, "lora": lora}),
                      step=torch.zeros((), dtype=torch.int32))


def named_numpy(tree) -> dict:
    return {n: t.detach().numpy().copy() for n, t in flatten_with_names(tree)}


def sharded_run(rank: int, case: dict) -> dict:
    """A sharded step a batch of ``case["batches"]`` on a (data, model) mesh
    of the first ranks: each step's loss and grad_norm, the local shapes of this rank's
    state, and (rank 0) the whole state after the steps."""
    model = model_of(case["arch"], case["overrides"])
    mesh = mesh_of(*case["mesh"])
    whole = initial_state(case["params"], case["lora"])
    shardings = make_shardings(train_state_specs(whole, mesh), mesh)
    state = shard_tree(whole, shardings)
    step_fn = make_sharded_train_step(model, shardings)
    metrics = []
    for b in case["batches"]:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        local = shard_tree(batch, make_shardings(batch_specs(batch, mesh), mesh))
        state, met = step_fn(state, local)
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
    full = gather_tree(state, shardings)
    return {"metrics": metrics,
            "local_shapes": {n: tuple(t.shape) for n, t in flatten_with_names(state)},
            "state": named_numpy(full) if rank == 0 else None}


def resharded(case: dict) -> bool:
    """``reshard`` from a (1, world) mesh's shardings to a (world, 1) one's
    (both over every rank), then gathered: the whole state, bit for bit."""
    world = torch.distributed.get_world_size()
    whole = initial_state(case["params"], case["lora"])
    meshes = [mesh_of(1, world), mesh_of(world, 1)]
    old, new = (make_shardings(train_state_specs(whole, m), m) for m in meshes)
    back = gather_tree(reshard(shard_tree(whole, old), old, new), new)
    return all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten_with_names(back),
                                                          flatten_with_names(whole)))


def job(rank: int, world: int, cases: list, launcher_argv: list) -> dict:
    """Every case on this world, ``reshard`` and the debug mesh, then the
    train launcher (its stdout)."""
    out = {"runs": [sharded_run(rank, c) for c in cases],
           "resharded": resharded(cases[0]),
           "debug_mesh": axis_sizes(make_debug_mesh(model=world))}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.run(rank, world, launcher_argv)
    out["launcher_stdout"] = buf.getvalue()
    return out


def numpy_state(state: TrainState) -> dict:
    """A whole ``TrainState`` as nested numpy trees."""
    def np_tree(tree):
        if isinstance(tree, dict):
            return {k: np_tree(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(np_tree(v) for v in tree)
        return tree.detach().numpy().copy()
    return {"params": np_tree(state.params), "lora": np_tree(state.lora),
            "m": np_tree(state.opt.m), "v": np_tree(state.opt.v), "step": int(state.step)}


def state_of(tree: dict) -> TrainState:
    """:func:`numpy_state`'s inverse."""
    t = {k: bridge.tensor_tree(tree[k], "cpu") for k in ("params", "lora", "m", "v")}
    step = torch.tensor(tree["step"], dtype=torch.int32)
    return TrainState(params=t["params"], lora=t["lora"],
                      opt=OptState(m=t["m"], v=t["v"], step=step.clone()), step=step)


def stepwise_run(rank: int, case: dict) -> dict:
    """One sharded step from each whole state of ``case["starts"]`` (a
    :func:`numpy_state` each), on its batch of ``case["batches"]``, on a
    (data, model) mesh: each step's loss and grad_norm, this rank's local
    shapes of the state, and (rank 0) each step's whole new state."""
    model = model_of(case["arch"], case["overrides"])
    mesh = mesh_of(*case["mesh"])
    metrics, states, shardings, step_fn = [], [], None, None
    for start, b in zip(case["starts"], case["batches"]):
        whole = state_of(start)
        if shardings is None:
            shardings = make_shardings(train_state_specs(whole, mesh), mesh)
            step_fn = make_sharded_train_step(model, shardings)
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        local = shard_tree(batch, make_shardings(batch_specs(batch, mesh), mesh))
        state, met = step_fn(shard_tree(whole, shardings), local)
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
        full = gather_tree(state, shardings)
        states.append(named_numpy({"params": full.params, "lora": full.lora,
                                   "opt": {"m": full.opt.m, "v": full.opt.v}})
                      if rank == 0 else None)
    return {"metrics": metrics, "states": states,
            "local_shapes": {n: tuple(t.shape) for n, t in flatten_with_names(state)}}


def family_job(rank: int, world: int, cases: list) -> list:
    """:func:`stepwise_run` of every case on this world."""
    return [stepwise_run(rank, c) for c in cases]


def numpy_batch(cfg, seed: int, B: int = 4, S: int = 12) -> dict:
    """Labels with ignored positions in one row only, so the data shards'
    counts of labelled positions differ; ids of two adapters and a base row;
    an encoder-decoder's frames (B, S / 2, d)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "adapter_ids": np.array([1, -1, 1, 0][:B], np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)
    return batch
