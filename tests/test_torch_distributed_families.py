"""Tensor and expert parallelism for every family the port builds, on the
CPU: the sharded train step (``make_sharded_train_step``) on gloo meshes
(data, model) = (1, 2), (2, 2) and (1, 4) against the port's one-process
``make_train_step`` and, at (1, 2), against the reference's jitted
``make_train_step`` on bridged weights. Ranks are spawned processes
(``repro_torch.distributed.runner``) running ``tests/torch_dist_ranks.py``,
two spawns in all (4 ranks, then 2).

* Reduced deepseek-v2-lite-16b (MLA and MoE with a shared FFN),
  phi3.5-moe (GQA and MoE), rwkv6-1.6b, recurrentgemma-2b (both block
  kinds; one kv head) and seamless-m4t-large-v2 (the encoder-decoder), all
  at 4 heads (MoE: 4 experts), f32, LoRA on 3 slots with a non-zero B,
  ``STEPS`` steps. Against one process, on the port's own weights (each
  expert drawn apart) and the MoE configs at a capacity factor of 1, so
  that drops and routing faults show; against the reference, on its
  weights.
* recurrentgemma with 10 heads of 8 (``hybrid10``) on (1, 4): the model
  axis does not divide the heads, so q's and k's column shards split
  heads, attention runs on every head and o's input is cut to its row
  shard, as at full size (10 heads over 4).
* Each step is held on its own: the sharded step starts from the state the
  one-process run (or the reference) had before that step, re-sharded by
  the rules, and its loss and grad_norm must be within ``METRIC_TOL`` and
  its whole new state within ``LEAF_TOL`` of the leaf's largest magnitude
  (the moments everywhere, a parameter element where its AdamW moment is
  at least 0.1·100·eps: AdamW's first step moves an element by
  lr·g/(|g| + eps), which turns the last bits of a gradient below 100·eps,
  summed in another order, into a different update; chained steps would
  carry that one element into every later gradient).
* Every rank's local shapes are the rules' shards (``train_state_specs``
  without ``cfg``, as the launcher places them), and every rank reports
  the same metrics.
* ``TensorParallel.gathered`` pins, per family, the only leaves the forward
  all-gathers whole: the layer-stacked dense FFNs and MoE's shared FFN,
  whose layer axis the reference's rule shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import build_model as jbuild_model
from repro.models import make_train_state as jmake_train_state
from repro.models import make_train_step as jmake_train_step
from repro_torch.distributed.runner import run_ranks
from repro_torch.distributed.sharded_step import train_state_specs
from repro_torch.distributed.sharding import make_shardings, param_specs
from repro_torch.distributed.tensor_parallel import TensorParallel
from repro_torch.models import make_train_step
from repro_torch.tree import flatten_with_names, tree_map

LEAF_TOL = 1e-4  # times the leaf's largest magnitude (tests/test_torch_distributed.py)
METRIC_TOL = 1e-5  # relative
STEPS = 3
FAMILIES = {"deepseek": "deepseek-v2-lite-16b", "phi": "phi3.5-moe-42b-a6.6b",
            "rwkv6": "rwkv6-1.6b", "hybrid": "recurrentgemma-2b",
            "seamless": "seamless-m4t-large-v2"}
HYBRID10 = {"num_heads": 10, "head_dim": 8}
MESHES_4 = ((2, 2), (1, 4))
MESH_2 = (1, 2)
EPS = 1e-8  # AdamW's


def _lora(model) -> dict:
    """LoRA on 3 slots with a non-zero B, as numpy."""
    rng = np.random.default_rng(3)
    L, r = model.cfg.num_layers, model.cfg.lora.rank
    return {t: (rng.standard_normal((L, 3, i, r)).astype(np.float32) * 0.3,
                rng.standard_normal((L, 3, r, o)).astype(np.float32) * 0.05)
            for t, (i, o) in model.lora_dims().items()}


def _overrides(key: str) -> dict:
    """Config overrides: the MoE configs at a capacity factor of 1, the
    hybrid with heads the model axis does not divide."""
    if key == "hybrid10":
        return dict(HYBRID10)
    moe = ranks.model_of(FAMILIES[key], {}).cfg.moe
    return {} if moe is None else {"moe": dataclasses.replace(moe, capacity_factor=1.0)}


def _one_process(key: str) -> dict:
    """STEPS chained steps of the port's one-process step on its own
    weights: the state before each step, the batches, the metrics and the
    whole state after each step."""
    arch = FAMILIES.get(key, FAMILIES["hybrid"])
    overrides = _overrides(key)
    model = ranks.model_of(arch, overrides)
    params = tree_map(lambda t: t.numpy(), model.init_params(torch.Generator().manual_seed(0)))
    batches = [ranks.numpy_batch(model.cfg, 20 + s) for s in range(STEPS)]
    state = ranks.initial_state(params, _lora(model))
    step = make_train_step(model)
    starts, metrics, afters = [], [], []
    for b in batches:
        starts.append(ranks.numpy_state(state))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        afters.append(ranks.named_numpy({"params": state.params, "lora": state.lora,
                                         "opt": {"m": state.opt.m, "v": state.opt.v}}))
    return {"arch": arch, "overrides": overrides, "starts": starts, "batches": batches,
            "metrics": metrics, "afters": afters}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _reference(key: str) -> dict:
    """STEPS chained steps of the reference's jitted step (jnp backend) on
    its own weights, in the form of :func:`_one_process`."""
    arch = FAMILIES[key]
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    jm = jbuild_model(jcfg, dtype=jnp.float32)
    jstate = jmake_train_state(jm, jax.random.PRNGKey(0), n_lora_slots=3)
    lora = _lora(ranks.model_of(arch, {}))
    jstate = dataclasses.replace(jstate, lora=jax.tree.map(jnp.asarray, lora),
                                 opt=joptim.adamw_init({"params": jstate.params,
                                                        "lora": lora}))
    batches = [ranks.numpy_batch(jcfg, 10 + s) for s in range(STEPS)]
    jstep = jax.jit(jmake_train_step(jm))
    starts, metrics, afters = [], [], []
    for b in batches:
        starts.append({"params": _np(jstate.params), "lora": _np(jstate.lora),
                       "m": _np(jstate.opt.m), "v": _np(jstate.opt.v),
                       "step": int(jstate.step)})
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        afters.append({n: np.asarray(a) for n, a in flatten_with_names(_np(
            {"params": jstate.params, "lora": jstate.lora,
             "opt": {"m": jstate.opt.m, "v": jstate.opt.v}}))})
    return {"arch": arch, "overrides": {}, "starts": starts, "batches": batches,
            "metrics": metrics, "afters": afters}


def _case(run: dict, mesh) -> dict:
    return {k: run[k] for k in ("arch", "overrides", "starts", "batches")} | {"mesh": mesh}


ONE_KEYS = list(FAMILIES) + ["hybrid10"]


@pytest.fixture(scope="module")
def wants():
    return {"port": {k: _one_process(k) for k in ONE_KEYS},
            "ref": {k: _reference(k) for k in FAMILIES}}


@pytest.fixture(scope="module")
def runs(wants, tmp_path_factory):
    """Both spawns: {(source, mesh, key): [every rank's run]}."""
    tmp = tmp_path_factory.mktemp("families")
    four = [("port", m, k) for m in MESHES_4 for k in FAMILIES] + [("port", (1, 4), "hybrid10")]
    two = [("port", MESH_2, k) for k in FAMILIES] + [("ref", MESH_2, k) for k in FAMILIES]
    out = {}
    for world, cases in ((4, four), (2, two)):
        results = run_ranks(ranks.family_job, world, tmp / "stores", timeout=240,
                            args=([_case(wants[s][k], m) for s, m, k in cases],))
        for i, c in enumerate(cases):
            out[c] = [r[i] for r in results]
    return out


def _held(run: dict, want: dict) -> None:
    """Each step's metrics within METRIC_TOL, its new state within
    LEAF_TOL (parameters where the AdamW moment is at least 0.1·100·eps)."""
    for (gl, gn), (wl, wn) in zip(run["metrics"], want["metrics"]):
        assert abs(gl - wl) <= METRIC_TOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= METRIC_TOL * wn, (gn, wn)
    for step, (got, exp) in enumerate(zip(run["states"], want["afters"])):
        assert got.keys() == exp.keys()
        for n, w in exp.items():
            err = np.abs(got[n] - w)
            if not n.startswith("opt/"):
                err = np.where(np.abs(exp[f"opt/m/{n}"]) >= 0.1 * 100 * EPS, err, 0.0)
            assert err.max() <= LEAF_TOL * max(np.abs(w).max(), 1e-30), (step, n)


def _local_shapes_are_the_rules(per_rank: list, want: dict, mesh) -> None:
    whole = ranks.state_of(want["starts"][0])
    specs = train_state_specs(whole, {"data": mesh[0], "model": mesh[1]})
    shardings = make_shardings(specs, {"data": mesh[0], "model": mesh[1]})
    expect = {n: shardings[n].local_shape(tuple(t.shape))
              for n, t in flatten_with_names(whole)}
    assert any(e != tuple(t.shape) for e, (_, t) in zip(expect.values(),
                                                         flatten_with_names(whole)))
    for r in per_rank:
        assert r["local_shapes"] == expect


ONE_CASES = [(m, k) for m in (MESH_2,) + MESHES_4 for k in FAMILIES] + [((1, 4), "hybrid10")]


@pytest.mark.parametrize("mesh,key", ONE_CASES,
                         ids=[f"{m[0]}x{m[1]}-{k}" for m, k in ONE_CASES])
def test_sharded_steps_match_one_process(runs, wants, mesh, key):
    per_rank = runs[("port", mesh, key)]
    want = wants["port"][key]
    assert all(r["metrics"] == per_rank[0]["metrics"] for r in per_rank)
    _held(per_rank[0], want)
    _local_shapes_are_the_rules(per_rank, want, mesh)


@pytest.mark.parametrize("key", list(FAMILIES))
def test_sharded_steps_match_the_reference(runs, wants, key):
    per_rank = runs[("ref", MESH_2, key)]
    assert all(r["metrics"] == per_rank[0]["metrics"] for r in per_rank)
    _held(per_rank[0], wants["ref"][key])


# at model 2, the leaves prepare gathers whole: the dense FFNs' and MoE's
# shared FFN's layer-stacked leaves whose layer axis the rules shard (2
# layers over 2; recurrentgemma's 3 layers are not sharded)
FFN = ("w_gate", "w_up", "w_down")
GATHERED_AT_2 = {"deepseek": {f"layers/ffn/shared/{w}" for w in FFN},
                 "phi": set(), "rwkv6": set(), "hybrid": set(),
                 "seamless": {f"{s}/ffn/{w}" for s in ("encoder", "decoder") for w in FFN}}


@pytest.mark.parametrize("key", list(FAMILIES))
def test_prepare_gathers_only_the_layer_sharded_ffn(key):
    """Every other leaf the rules shard over ``model`` is used as its
    shard: the expert stacks, every projection; at model 4 as at 2."""
    params = ranks.model_of(FAMILIES[key], {}).init_params(torch.Generator().manual_seed(0))
    for M in (2, 4):
        specs = param_specs(params, {"data": 1, "model": M})
        tp = TensorParallel(None, M, 0, specs)
        ffn = {n for n, t in flatten_with_names(params)
               if n.rsplit("/", 1)[-1] in FFN and t.dim() == 3 and specs[n]}
        assert set(tp.gathered(params)) == ffn
        sharded = {n for n, s in specs.items() if s}
        assert sharded - ffn  # the rest of the sharded leaves stay shards
        if M == 2:
            assert ffn == GATHERED_AT_2[key]
