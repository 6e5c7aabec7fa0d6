"""Rank functions for ``tests/test_torch_distributed.py``,
``tests/test_torch_distributed_families.py`` and
``tests/test_torch_sharded_serve.py``. The ranks are spawned processes that
import this module by name, so it imports no JAX: weights and batches
arrive as numpy arrays, results leave as numpy."""

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
from repro_torch.tree import flatten_with_names, tree_map
from repro_torch.tree import leaves as leaves_of


def model_of(arch: str, overrides: dict, kv_quant: bool = False):
    """The reduced config of ``arch`` with ``overrides`` of its fields."""
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)), **overrides)
    return build_model(cfg, dtype=torch.float32, device="cpu", kv_quant=kv_quant)


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


# cache leaves whose dim 2 is time (RWKV's wkv has its heads there)
_TIMED = ("k", "v", "k_scale", "v_scale", "ck", "cv", "latent", "krope")
_COLLECTIVES = ("all_gather", "all_reduce", "all_gather_into_tensor", "broadcast",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all")


@contextlib.contextmanager
def collective_spy(log: list):
    """Every ``torch.distributed`` collective called inside, as (name, the
    data pointers of its tensors' storages, elements this rank sends)."""
    saved = {n: getattr(torch.distributed, n) for n in _COLLECTIVES}

    def wrap(name, fn):
        def spy(*args, **kwargs):
            ts = [t for a in args for t in (a if isinstance(a, list) else [a])
                  if torch.is_tensor(t)]
            sent = ts[-1].numel() if name.startswith("all_gather") else ts[0].numel()
            log.append((name, {t.untyped_storage().data_ptr() for t in ts}, sent))
            return fn(*args, **kwargs)
        return spy

    for n, fn in saved.items():
        setattr(torch.distributed, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(torch.distributed, n, fn)


@contextlib.contextmanager
def attended_keys(log: list):
    """The key slots a row of each attention kernel call spans: the paged
    table's tokens (``paged_attention``) or the cache's (``ragged_extend``)."""
    from repro_torch.kernels import ops
    saved = ops.paged_attention, ops.ragged_extend

    def paged(q, k_pages, v_pages, tables, lengths, **kw):
        log.append(("paged_attention", tables.shape[1] * k_pages.shape[1]))
        return saved[0](q, k_pages, v_pages, tables, lengths, **kw)

    def ragged(q, k, v, start, true_lens, **kw):
        log.append(("ragged_extend", k.shape[1]))
        return saved[1](q, k, v, start, true_lens, **kw)

    ops.paged_attention, ops.ragged_extend = paged, ragged
    try:
        yield log
    finally:
        ops.paged_attention, ops.ragged_extend = saved


def lora_written_in_place(model, shardings, smodel, params, lora, cache, batch) -> dict:
    """One decode step of ``smodel`` (whose weights are prepared once) on
    copies of ``cache`` before and after every LoRA leaf is written in
    place, and the second beside a newly sharded model's: whether the write
    moved the logits, and whether the first model then gives the new
    model's bits (no stale preparation)."""
    from repro_torch.distributed import sharded_model

    def step(m):
        return m.decode(params, tree_map(torch.clone, cache), batch["tokens"], lora=lora,
                        adapter_ids=batch["adapter_ids"])[0]

    before = step(smodel)
    for t in leaves_of(lora):
        t.mul_(1.5)
    after = step(smodel)
    return {"moved": not torch.equal(before, after),
            "fresh": torch.equal(after, step(sharded_model(model, shardings)))}


def serve_run(rank: int, case: dict) -> dict:
    """The sharded prefill of ``case["tokens"]`` into a cache of
    ``case["T"]`` positions, then ``case["steps"]`` greedy decode steps, on
    a (data, model) mesh, from whole numpy weights placed by the rules:
    this rank's coordinate, its rows' prefill logits, tokens and logits of
    each step, its local cache shapes and bytes beside the dry run's
    ``device_bytes`` of the same tree and mesh, its leaves the rules
    replicate over ``model``, the collectives of the decode steps, the key
    slots each attention kernel call spans, and (rank 0) the whole cache
    gathered after the steps."""
    from repro_torch.distributed import (make_sharded_decode_step, make_sharded_prefill_step,
                                         serve_state_specs, sharded_model, whole_cache)
    from repro_torch.distributed.sharding import cache_specs, spec_axes
    from repro_torch.launch.dryrun import device_bytes

    model = model_of(case["arch"], case["overrides"], case.get("kv_quant", False))
    mesh = mesh_of(*case["mesh"])
    axes = {"data": case["mesh"][0], "model": case["mesh"][1]}
    params = bridge.tensor_tree(case["params"], "cpu")
    lora = bridge.tensor_tree(case["lora"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    B = batch["tokens"].shape[0]
    src = batch["frames"].shape[1] if "frames" in batch else None
    cache = whole_cache(model, B, case["T"], src)
    shardings = make_shardings(serve_state_specs(params, lora, cache, mesh), mesh)

    def sub(prefix):
        return {n[len(prefix):]: s for n, s in shardings.items() if n.startswith(prefix)}

    lp, ll = shard_tree(params, sub("params/")), shard_tree(lora, sub("lora/"))
    local = shard_tree(batch, make_shardings(batch_specs(batch, mesh), mesh))
    ids = local["adapter_ids"]
    smodel = sharded_model(model, shardings)
    prefill = make_sharded_prefill_step(smodel, shardings, cache)
    decode = make_sharded_decode_step(smodel, shardings)
    keys: list = []
    with torch.no_grad(), attended_keys(keys):
        logits0, c = prefill(lp, ll, local)
        tok = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)
        toks, logits, sent, aliased, agrees = [], [], [], False, []
        for _ in range(case["steps"]):
            log: list = []
            leaves = {t.untyped_storage().data_ptr() for _, t in flatten_with_names(c)}
            fed = {"tokens": tok[:, None], "adapter_ids": ids}
            step_c = tree_map(torch.clone, c)
            with collective_spy(log):
                lg, c = smodel.decode(lp, c, fed["tokens"], lora=ll, adapter_ids=ids)
            aliased |= any(ptrs & leaves for _, ptrs, _ in log)
            sent.append(sum(n for _, _, n in log))
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
            step_tok, step_c = decode(lp, ll, step_c, fed)
            agrees.append(bool(torch.equal(step_tok, tok)) and all(
                torch.equal(a, b) for a, b in zip(leaves_of(step_c), leaves_of(c))))
            toks.append(tok.numpy().copy())
            logits.append(lg.numpy().copy())
        inplace = lora_written_in_place(model, shardings, smodel, lp, ll, c, fed)
    specs = cache_specs(cache, axes)
    replicated = {n: t.numpy().copy() for n, t in flatten_with_names(c)
                  if not any("model" in spec_axes(e) for e in specs[n])}
    whole = gather_tree(c, sub("cache/"))
    return {"coordinate": mesh.get_coordinate(), "prefill_logits": logits0.numpy().copy(),
            "tokens": toks, "logits": logits,
            "local_shapes": {n: tuple(t.shape) for n, t in flatten_with_names(c)},
            "rules": {n: make_shardings(specs, axes)[n].local_shape(tuple(t.shape))
                      for n, t in flatten_with_names(cache)},
            "cache_bytes": sum(t.numel() * t.element_size() for _, t in flatten_with_names(c)),
            "dryrun_bytes": device_bytes(cache, specs, axes),
            "replicated": replicated, "collectives_alias_cache": aliased,
            "decode_step_agrees": agrees, "lora_written_in_place": inplace,
            "sent_per_step": sent, "attended": keys,
            "time_sharded": sorted(n for n, s in specs.items() if n in _TIMED
                                   and len(s) > 2 and "model" in spec_axes(s[2])),
            "whole_cache": named_numpy(whole) if rank == 0 else None}


def serve_job(rank: int, world: int, cases: list) -> list:
    """:func:`serve_run` of every case on this world."""
    return [serve_run(rank, c) for c in cases]
