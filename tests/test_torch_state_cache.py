"""The port's recurrent-state prefix cache against the reference's
(mirrors ``tests/test_state_cache.py``).

The data plane (``repro_torch.kvcache.state_cache``): the snapshot store's
footprint, store/load/swap round trip and bounds errors, and the flattened
snapshot of a bridged cache equal to the reference's element for element
(within 1e-4 after the same ``extend``: two layers of f32 sums in another
order). The engine (RWKV-6 and the RG-LRU hybrid, reduced, window 16): a
snapshot's round trip through the host tier and a preemption that folds a
snapshot, each giving the JAX engine's tokens; the tokens of a repeated
prompt and a continued conversation are held in
``tests/test_torch_state_engine.py``. Both engines read the same fake clock
(a step counter), and the port runs on ``device="cpu"`` with the
reference's weights and adapters bridged over.

    PYTHONPATH=src python -m pytest -q tests/test_torch_state_cache.py
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import NodeKind as JaxNodeKind
from repro.kvcache import flatten_state as jax_flatten_state
from repro.kvcache import state_floats as jax_state_floats
from repro.models import build_model as jax_build_model
from repro.serving import EngineConfig as JaxConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.request import PRIORITY_INTERACTIVE
from repro_torch import bridge, configs
from repro_torch.core import NodeKind, Residency
from repro_torch.kvcache import (StateCache, StateSpec, flat_state_elems,
                                 flatten_state, state_floats, unflatten_state)
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving.request import Phase

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]
XTOL = dict(rtol=1e-4, atol=1e-4)
SIZES = dict(hbm_bytes=8 << 20, host_bytes=32 << 20, block_size=4,
             max_batch_slots=4, max_seq_len=96, prefill_chunk=8,
             prefill_min_bucket=4, step_token_budget=24)


# ------------------------------------------------------------- data plane
def test_state_spec_dtype_parameterizes_footprint():
    f32 = StateSpec(state_elems=1000, block_bytes=1024, dtype=torch.float32)
    bf16 = StateSpec(state_elems=1000, block_bytes=1024, dtype=torch.bfloat16)
    assert f32.snapshot_bytes == 4000 and bf16.snapshot_bytes == 2000
    assert f32.blocks_per_snapshot == 4 and bf16.blocks_per_snapshot == 2


def test_store_load_swap_roundtrip_and_bounds_checks():
    spec = StateSpec(state_elems=100, block_bytes=64, dtype=torch.float32)
    cache = StateCache(spec, n_hbm_blocks=24, n_host_blocks=16, device="cpu")
    blocks = list(range(3, 3 + spec.blocks_per_snapshot))
    flat = torch.arange(100, dtype=torch.float32)
    cache.store(blocks, flat)
    assert torch.equal(cache.load(blocks, 100), flat)
    with pytest.raises(ValueError):
        cache.load(blocks[:1], 100)
    with pytest.raises(ValueError):
        cache.store(blocks[:1], flat)  # snapshot larger than the blocks
    with pytest.raises(ValueError):
        cache.store([], flat)
    host = list(range(len(blocks)))
    cache.swap_out(blocks, host)
    back = list(range(10, 10 + len(blocks)))
    cache.swap_in(host, back)
    assert torch.equal(cache.load(back, 100), flat)
    assert (cache.swap_outs, cache.swap_ins) == (1, 1)
    assert cache.swap_out_bytes == cache.swap_in_bytes == len(blocks) * 64
    # a failed swap raises: blocks past a tier, or unequal block lists
    with pytest.raises(IndexError):
        cache.swap_out([0], [16])
    with pytest.raises(IndexError):
        cache.swap_in([0], [24])
    with pytest.raises(ValueError):
        cache.swap_in([0, 1], [2])
    cache.swap_out([], [])  # a hollow node moves no payload


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_unflatten_roundtrip(arch):
    model = build_model(configs.reduced(configs.get(arch)), dtype=torch.float32, device="cpu")
    cache = model.init_cache(3, 32)
    n = flat_state_elems(cache)
    flat = torch.from_numpy(np.random.default_rng(0).standard_normal(n, np.float32))
    before = flatten_state(cache, 0)
    assert unflatten_state(cache, 1, flat) is cache  # written in place
    assert torch.equal(flatten_state(cache, 1), flat)
    assert torch.equal(flatten_state(cache, 0), before)  # other rows untouched
    with pytest.raises(ValueError):
        unflatten_state(cache, 0, flat[:-1])


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b"])
def test_state_floats_matches_jax(arch):
    tcfg = configs.reduced(configs.get(arch))
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    if arch == "qwen3-0.6b":
        with pytest.raises(ValueError):
            state_floats(tcfg)
        return
    assert state_floats(tcfg) == jax_state_floats(jcfg)
    assert state_floats(tcfg, window=0) == jax_state_floats(jcfg, window=0)
    if arch == "recurrentgemma-2b":  # the window K/V is part of the snapshot
        assert state_floats(tcfg) > state_floats(tcfg, window=0) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_state_matches_jax(arch):
    """A bridged cache flattens to the reference's snapshot exactly, and
    after the same row-masked ``extend`` within 1e-4."""
    jm = jax_build_model(jconfigs.reduced(jconfigs.get(arch)), dtype=jnp.float32,
                         kernel_backend="jnp")
    params = jm.init_params(jax.random.PRNGKey(1))
    tm = build_model(configs.reduced(configs.get(arch)), dtype=torch.float32, device="cpu")
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, params), "cpu")
    B, T = 3, 32
    rng = np.random.default_rng(2)
    jcache = jm.init_cache(B, T)
    jcache = {k: (v if k == "len" else
                  jnp.asarray(rng.standard_normal(v.shape, np.float32)))
              for k, v in jcache.items()}
    tcache = bridge.tensor_tree(jax.tree.map(np.asarray, jcache), "cpu")
    tcache["len"] = tcache["len"].to(torch.int32)
    assert flat_state_elems(tcache) == flatten_state(tcache, 0).shape[0]
    for row in range(B):
        np.testing.assert_array_equal(flatten_state(tcache, row).numpy(),
                                      np.asarray(jax_flatten_state(jcache, row)))
    tokens = rng.integers(0, 256, (B, 8)).astype(np.int32)
    start = np.array([3, 0, 7], np.int32)
    true_lens = np.array([8, 0, 1], np.int32)
    _, jnew = jm.extend(params, jcache, jnp.asarray(tokens), jnp.asarray(start),
                        true_lens=jnp.asarray(true_lens))
    _, tnew = tm.extend(tparams, tcache, torch.from_numpy(tokens),
                        torch.from_numpy(start), true_lens=torch.from_numpy(true_lens))
    for row in range(B):
        np.testing.assert_allclose(flatten_state(tnew, row).numpy(),
                                   np.asarray(jax_flatten_state(jnew, row)), **XTOL)


# ----------------------------------------------------------------- engine
def fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def engines(arch, slots=4, **engine_kw):
    """(reference engine, port engine): the same weights and adapters."""
    sizes = dict(SIZES, max_batch_slots=slots)
    jeng = JaxEngine(jconfigs.reduced(jconfigs.get(arch)),
                     JaxConfig(kernel_backend="jnp", clock=fake_clock(),
                               **sizes, **engine_kw),
                     key=jax.random.PRNGKey(7))
    teng = ServingEngine(configs.reduced(configs.get(arch)),
                         EngineConfig(clock=fake_clock(), **sizes, **engine_kw),
                         params=jax.tree.map(np.asarray, jeng.params), device="cpu")
    for i in range(2):
        aid = f"lora-{i}"
        jeng.register_adapter(aid)
        teng.register_adapter(aid, weights=bridge.tensor_tree(
            jeng.adapters._host[aid].weights, "cpu"))
    assert teng.kv_pool is None and teng.state_cache is not None
    return jeng, teng


@pytest.mark.parametrize("arch", ARCHS)
def test_snapshot_host_roundtrip(arch):
    """A committed snapshot swapped out to the host tier swaps back in on
    the next hit, charging the copy to the request, and the resumed
    request decodes the cold run's tokens in both engines."""
    jeng, teng = engines(arch)
    out = {}
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        # the swapper's own sweeps would move the snapshot on the fake
        # clock's schedule: the test moves it, and the hit demands it back
        eng.swapper.config.enabled = False
        cold = make("cold", "lora-0", tuple(range(60, 88)), max_new_tokens=4)
        eng.submit(cold)
        eng.run()
        mgr = eng.manager
        kind = NodeKind if eng is teng else JaxNodeKind
        snap = [n for n in mgr.tree.iter_nodes({kind.STATE}) if n.has_payload]
        assert len(snap) == 1
        mgr._swap_out_node(snap[0], now=eng._now())
        eng._execute_swaps(mgr.drain_ops())
        assert snap[0].tier.name == Residency.HOST.name
        warm = make("warm", "lora-0", cold.prompt, max_new_tokens=4)
        eng.submit(warm)
        eng.run()
        assert warm.matched_tokens == len(cold.prompt) - 1
        assert warm.generated == cold.generated
        assert warm.kv_coldstart > 0
        out[eng is teng] = tuple(warm.generated)
    assert out[True] == out[False]
    sc = teng.state_cache
    assert sc.swap_outs == sc.swap_ins == 1
    assert sc.swap_out_bytes == sc.swap_in_bytes > 0
    teng.manager.check_invariants()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_preemption_folds_a_snapshot(arch, phase):
    """An interactive arrival on a one-slot engine preempts the batch-tier
    victim: mid-decode the victim's state folds into the pool as a snapshot
    at its recurrence position and it resumes from there; mid-prefill past
    its capture boundary nothing is crossed yet and it re-prefills. Both
    engines give the same tokens, and the victim's equal those of an
    undisturbed run."""
    jeng, teng = engines(arch, slots=1)
    outs = {}
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        victim = make("victim", "lora-0", tuple(range(100, 132)), max_new_tokens=6)
        eng.submit(victim)
        target = Phase.DECODE if phase == "decode" else Phase.PREFILLING
        for _ in range(64):
            if victim.phase.name == target.name:
                break
            eng.step()
        eng.step()
        intr = make("intr", "lora-1", tuple(range(40, 48)), max_new_tokens=2,
                    priority=PRIORITY_INTERACTIVE, deadline=eng.now() + 0.01)
        eng.submit(intr)
        eng.run()
        assert victim.preempt_count >= 1 and intr.finish_time <= victim.finish_time
        # the resume starts from the folded snapshot (decode) or from scratch
        assert (victim.matched_tokens > 0) == (phase == "decode")
        kind = NodeKind if eng is teng else JaxNodeKind
        snaps = [n for n in eng.manager.tree.iter_nodes({kind.STATE}) if n.has_payload]
        outs[eng is teng] = (victim.output_tokens, tuple(intr.generated),
                             victim.matched_tokens, sorted(n.num_blocks for n in snaps))
    assert outs[True] == outs[False]
    _, ref = engines(arch, slots=1)
    alone = Request("alone", "lora-0", tuple(range(100, 132)), max_new_tokens=6)
    ref.submit(alone)
    ref.run()
    assert outs[True][0] == tuple(alone.generated)
    teng.manager.check_invariants()
