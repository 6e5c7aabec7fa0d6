"""The port's serving engine against the reference's, token for token.

The workload is ``tests/test_kernel_backend.py:run_workload``: multi-adapter
prefill in buckets, shared-prefix spans (adapter id -1 through fused_sgmv)
and decode steps. The reference runs with ``kernel_backend="jnp"``, which
``test_kernel_backend`` pins token-identical to ``"pallas"``; the port runs
on ``device="cpu"`` (the kernels' plain versions) with the reference's
weights and registered adapters bridged over, and both engines read the
same fake clock (a step counter), so the swapper sees the same times.
"""

import itertools

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.serving import EngineConfig as JaxConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.serving import EngineConfig, Request, ServingEngine

SYS = tuple(range(40, 52))  # 12-token "system prompt" (3 blocks of 4)
SIZES = dict(hbm_bytes=8 << 20, host_bytes=32 << 20, block_size=4,
             max_batch_slots=4, max_seq_len=96)


def fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def engines(**engine_kw):
    """(reference engine, port engine) with the same weights and adapters."""
    jeng = JaxEngine(jconfigs.reduced(jconfigs.get("qwen3-0.6b")),
                     JaxConfig(kernel_backend="jnp", clock=fake_clock(),
                               **SIZES, **engine_kw),
                     key=jax.random.PRNGKey(11))
    teng = ServingEngine(configs.reduced(configs.get("qwen3-0.6b")),
                         EngineConfig(clock=fake_clock(), **SIZES, **engine_kw),
                         params=jax.tree.map(np.asarray, jeng.params),
                         device="cpu")
    for i in range(3):
        aid = f"lora-{i}"
        jeng.register_adapter(aid)
        teng.register_adapter(aid, weights=bridge.tensor_tree(
            jeng.adapters._host[aid].weights, "cpu"))
    return jeng, teng


def workload(make):
    ids = itertools.count()

    def req(adapter, prompt, n, shared=0):
        return make(f"kb{next(ids)}", adapter, tuple(prompt),
                    max_new_tokens=n, shared_prefix_len=shared)

    return [
        req("lora-0", SYS + tuple(range(60, 65)), 4, shared=len(SYS)),
        req("lora-1", SYS + tuple(range(70, 73)), 4, shared=len(SYS)),
        req("lora-2", range(80, 87), 3),  # fully adapter-specific
        req("lora-0", range(90, 104), 3),  # longer ragged row
    ]


def serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(len(r.generated) > 0 for r in reqs)
    return [tuple(r.generated) for r in reqs]


@pytest.mark.parametrize(
    "engine_kw",
    [
        dict(schedule_mode="mixed"),
        dict(schedule_mode="alternate"),
        dict(schedule_mode="alternate", prefill_mode="eager"),
    ],
    ids=["mixed", "alternate", "eager"],
)
def test_port_tokens_identical_to_reference(engine_kw):
    jeng, teng = engines(**engine_kw)
    want = serve(jeng, workload(JaxRequest))
    got = serve(teng, workload(Request))
    assert got == want, f"port diverged under {engine_kw}"
    # the shared-prefix rows hit the cross-adapter trunk the same way
    assert teng.manager.stats.kv_hit_rate() == jeng.manager.stats.kv_hit_rate()
    counts = teng.compile_counts()
    assert counts["prefill"] <= len(teng.prefill.buckets)


def test_port_prefix_reuse_identical():
    """The warm path: the second request decodes against reused pool KV,
    gathered into the dense cache."""
    jeng, teng = engines()
    tokens = {}
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        r1 = make("r1", "lora-0", tuple(range(10, 26)), max_new_tokens=6)
        eng.submit(r1)
        eng.run()
        r2 = make("r2", "lora-0", r1.full_tokens, max_new_tokens=4)
        eng.submit(r2)
        eng.run()
        assert r2.matched_tokens > 0
        tokens[eng is teng] = (tuple(r1.generated), tuple(r2.generated))
    assert tokens[True] == tokens[False]


def _pair_sized(**engine_kw):
    """Like :func:`engines`, with other engine sizes and two adapters."""
    jeng = JaxEngine(jconfigs.reduced(jconfigs.get("qwen3-0.6b")),
                     JaxConfig(kernel_backend="jnp", clock=fake_clock(),
                               **engine_kw), key=jax.random.PRNGKey(7))
    teng = ServingEngine(configs.reduced(configs.get("qwen3-0.6b")),
                         EngineConfig(clock=fake_clock(), **engine_kw),
                         params=jax.tree.map(np.asarray, jeng.params),
                         device="cpu")
    for i in range(3):
        aid = f"lora-{i}"
        jeng.register_adapter(aid)
        teng.register_adapter(aid, weights=bridge.tensor_tree(
            jeng.adapters._host[aid].weights, "cpu"))
    return jeng, teng


def test_port_swaps_identical():
    """A 128 KiB device pool: the swapper moves KV blocks out to the host
    tier and back in, and the tokens still match."""
    jeng, teng = _pair_sized(hbm_bytes=128 << 10, host_bytes=32 << 20,
                             block_size=4, max_batch_slots=2, max_seq_len=96)
    out = []
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        reqs = [make(f"p{i}", f"lora-{i % 3}", tuple(range(20 + 7 * i, 60 + 7 * i)),
                     max_new_tokens=5) for i in range(8)]
        reqs += [make(f"q{i}", f"lora-{i % 3}",
                      tuple(range(20 + 7 * i, 60 + 7 * i)) + (3, 4, 5),
                      max_new_tokens=3) for i in range(8)]
        out.append((serve(eng, reqs), eng.kv_pool.swap_out_bytes,
                    eng.kv_pool.swap_in_bytes))
    assert out[1] == out[0]
    assert out[1][1] > 0 and out[1][2] > 0, "the pool never swapped"


@pytest.mark.parametrize("schedule", ["mixed", "alternate"])
def test_port_preempt_resume_identical(schedule):
    """Decode-phase preemption on a one-slot engine: an interactive arrival
    evicts the batch victim mid-decode, the victim resumes from its swapped
    KV, and both engines emit the same streams."""
    jeng, teng = _pair_sized(
        hbm_bytes=8 << 20, host_bytes=32 << 20, block_size=4,
        max_batch_slots=1, max_seq_len=96, prefill_chunk=8,
        prefill_min_bucket=4, schedule_mode=schedule, step_token_budget=24)
    out = []
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        victim = make("v", "lora-0", tuple(range(10, 26)), max_new_tokens=8)
        eng.submit(victim)
        for _ in range(64):
            if victim.generated:
                break
            eng.step()
        eng.step()
        intr = make("i", "lora-1", tuple(range(40, 48)), max_new_tokens=2,
                    priority=2, deadline=eng.now() + 0.01)
        eng.submit(intr)
        report = eng.run()
        out.append((tuple(victim.output_tokens), tuple(intr.generated),
                    report.n_preempted))
    assert out[1] == out[0]
    assert out[1][2] >= 1
