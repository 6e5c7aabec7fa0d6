"""Adapter prefetch past the device slot table, pinned in both engines.

The cache manager does not bound resident adapters by ``max_adapters``:
with more adapters registered than slots, the swapper's idle prefetch
issues a LoRA swap-in that reaches ``AdapterStore.load`` through
``ServingEngine._execute_swaps`` and raises ``RuntimeError``. The
reference's engine does the same (``repro/serving/engine.py``,
``_execute_swaps``); the port keeps the reference's behaviour and adds no
guard, so both must raise the same error at the same engine step.

    PYTHONPATH=src python -m pytest -q tests/test_torch_adapter_slots.py
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

SIZES = dict(hbm_bytes=8 << 20, host_bytes=32 << 20, block_size=4,
             max_batch_slots=4, max_seq_len=96)


def _fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _raise_point(eng):
    """Step ``eng`` until it raises; returns (step() calls completed,
    engine steps counted, the error, the frames' function names)."""
    calls = 0
    with pytest.raises(RuntimeError, match="no free adapter slots") as info:
        for _ in range(500):
            eng.step()
            calls += 1
    frames = [entry.name for entry in info.traceback]
    return calls, eng._step_count, str(info.value), frames


def test_prefetch_past_the_slot_table_raises_as_the_reference():
    jcfg = jconfigs.reduced(jconfigs.get("qwen3-0.6b"))
    tcfg = configs.reduced(configs.get("qwen3-0.6b"))
    assert jcfg.lora.max_adapters == tcfg.lora.max_adapters == 4
    jeng = JaxEngine(jcfg, JaxConfig(kernel_backend="jnp", clock=_fake_clock(), **SIZES),
                     key=jax.random.PRNGKey(11))
    teng = ServingEngine(tcfg, EngineConfig(clock=_fake_clock(), **SIZES),
                         params=jax.tree.map(np.asarray, jeng.params), device="cpu")
    out = []
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        for i in range(6):  # two more adapters than slots
            aid = f"lora-{i}"
            if eng is jeng:
                eng.register_adapter(aid)
            else:
                eng.register_adapter(aid, weights=bridge.tensor_tree(
                    jeng.adapters._host[aid].weights, "cpu"))
        eng.submit(make("r0", "lora-0", tuple(range(10, 30)), max_new_tokens=4))
        calls, steps, err, frames = _raise_point(eng)
        # the swapper's prefetch, not a request's own reload
        assert "_execute_swaps" in frames and "_reload_adapter" not in frames
        assert sorted(eng.adapters.resident) == [f"lora-{i}" for i in range(4)]
        out.append((calls, steps, err))
    assert out[1] == out[0]
