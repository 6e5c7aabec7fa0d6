"""The port's simulator and traces against the reference's.

``repro_torch.sim`` and ``repro_torch.data`` are verbatim copies (checked
by ``tests/test_torch_isolation.py``), so the same traces through the same
control plane must give the same results exactly: tolerance 0. Then the
port's own H100 spec (``repro_torch.sim.h100``) serves the paper's models.
"""

import dataclasses
import itertools

import pytest

from repro import configs as ref_configs
from repro import data as ref_data
from repro import sim as ref_sim
from repro.core import dependency_tree as ref_dependency_tree
from repro_torch import configs, data, sim
from repro_torch.core import dependency_tree
from repro_torch.sim import h100

TRACES = {  # short traces of the paper's three scenarios
    "agent": dict(scenario="agent", n_loras=40, duration=60.0, mean_qps=1.0, seed=5),
    "chatbot": dict(scenario="chatbot", n_loras=60, duration=60.0, mean_qps=2.0, seed=3,
                    shared_system_prompt_len=64, interactive_fraction=0.3),
    "translation": dict(scenario="translation", n_loras=120, duration=40.0, mean_qps=4.0,
                        seed=7, distribution="skewed", skew_sigma=30.0),
}


def traces(name):
    return (ref_data.generate_trace(ref_data.TraceConfig(**TRACES[name])),
            data.generate_trace(data.TraceConfig(**TRACES[name])))


def run_both(arch, cards, scenario, **kw):
    """The reference's and the port's simulator on ``scenario``'s trace,
    each on its own copy: (reference result, port result)."""
    ref_trace, port_trace = traces(scenario)
    ref = ref_sim.ServingSimulator(ref_sim.DeployedModel(ref_configs.get(arch), cards),
                                   ref_trace, ref_sim.SimConfig(**kw)).run()
    port = sim.ServingSimulator(sim.DeployedModel(configs.get(arch), cards),
                                port_trace, sim.SimConfig(**kw)).run()
    return ref, port


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_equal_query_by_query(name):
    ref, port = traces(name)
    assert len(ref) == len(port) > 0
    for a, b in zip(ref, port):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ref_data.trace_stats(ref) == data.trace_stats(port)


CASES = [  # (arch, cards, scenario, SimConfig keywords)
    ("llama-7b", 1, "agent", dict(variant="fastlibra")),
    ("llama-7b", 1, "agent", dict(variant="vllm")),
    ("llama-7b", 1, "agent", dict(variant="slora")),
    ("llama-7b", 1, "chatbot", dict(variant="fastlibra", schedule_mode="alternate")),
    ("llama-7b", 1, "chatbot", dict(variant="fastlibra", schedule_mode="mixed")),
    ("llama-7b", 1, "translation", dict(variant="vllm", schedule_mode="mixed")),
    ("llama-34b", 4, "chatbot", dict(variant="fastlibra", schedule_mode="mixed")),
    ("llama-34b", 4, "agent", dict(variant="slora")),
    ("rwkv6-1.6b", 1, "agent", dict(variant="fastlibra")),
    ("llama-7b", 1, "chatbot", dict(variant="fastlibra", straggler_p=0.3,
                                    straggler_timeout=0.05)),
]


@pytest.mark.parametrize("arch,cards,scenario,kw", CASES,
                         ids=[f"{a}-x{c}-{t}-" + "-".join(map(str, k.values()))
                              for a, c, t, k in CASES])
def test_simulator_equals_reference(arch, cards, scenario, kw):
    ref, port = run_both(arch, cards, scenario, trace=False, **kw)
    assert port.summary() == ref.summary()
    assert port.timeline == ref.timeline
    assert port.duration == ref.duration
    assert port.straggler_mitigations == ref.straggler_mitigations
    assert ([(r.rid, r.first_token_time, r.finish_time) for r in port.finished]
            == [(r.rid, r.first_token_time, r.finish_time) for r in ref.finished])
    assert len(port.finished) > 0


def test_state_snapshots_reach_state_floats():
    """rwkv6's STATE nodes take their size from the port's own
    ``kvcache.state_cache.state_floats``: the same bytes and hits."""
    ref, port = run_both("rwkv6-1.6b", 1, "agent", trace=False)
    dep = sim.DeployedModel(configs.get("rwkv6-1.6b"))
    assert dep.state_snapshot_bytes == ref_sim.DeployedModel(
        ref_configs.get("rwkv6-1.6b")).state_snapshot_bytes > 0
    assert port.summary()["state_hit_rate"] == ref.summary()["state_hit_rate"] > 0


def test_traced_run_records_the_same_events(monkeypatch):
    # the events carry node ids, drawn from a counter of each package's
    # process: other tests in this process may have drawn from one and not
    # the other, so both count from 0 here
    for tree in (ref_dependency_tree, dependency_tree):
        monkeypatch.setattr(tree, "_node_ids", itertools.count())
    ref_trace, port_trace = traces("chatbot")
    kw = dict(variant="fastlibra", schedule_mode="mixed", trace=True)
    a = ref_sim.ServingSimulator(ref_sim.DeployedModel(ref_configs.get("llama-7b")),
                                 ref_trace, ref_sim.SimConfig(**kw))
    b = sim.ServingSimulator(sim.DeployedModel(configs.get("llama-7b")), port_trace,
                             sim.SimConfig(**kw))
    a.run()
    b.run()
    names = [ev.name for ev in a.tracer.events]
    assert names and [ev.name for ev in b.tracer.events] == names
    for x, y in zip(a.tracer.events, b.tracer.events):
        assert (x.phase, x.track, x.ts, x.dur, x.args) == (y.phase, y.track, y.ts, y.dur,
                                                           y.args)
    assert b.tracer.counts == a.tracer.counts
    assert b.tracer.gauges == a.tracer.gauges


@pytest.mark.parametrize("arch", ["llama-7b", "llama-13b", "llama-34b"])
def test_h100_spec_holds_the_papers_models_on_one_card(arch):
    dep = sim.DeployedModel(configs.get(arch), 1, h100.h100_spec())
    assert dep.hbm_pool_bytes() > 0


def test_h100_spec_serves_a_short_trace():
    trace = data.generate_trace(data.TraceConfig(**TRACES["agent"]))
    res = sim.ServingSimulator(sim.DeployedModel(configs.get("llama-7b"), 1, h100.h100_spec()),
                               trace, sim.SimConfig(trace=False)).run()
    assert len(res.finished) == len(trace)
    assert all(r.finish_time is not None for r in res.finished)
    res.manager.check_invariants()


def test_h100_spec_reads_the_kernels_constants():
    from repro_torch.kernels import counting

    spec = h100.h100_spec()
    assert spec.flops_fp16 == counting.BF16_FLOPS
    assert spec.hbm_bw == counting.HBM_BYTES_PER_S
    assert spec.decode_overhead > 0 and 0 < spec.prefill_mfu < 1
    assert spec.pcie_bw > 0 and spec.pcie_latency > 0
