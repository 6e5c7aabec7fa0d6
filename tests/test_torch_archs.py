"""The port's dense configs against the reference's, beyond qwen3-0.6b.

The paper's Llama models (llama-7b, -13b, -34b), qwen3-4b, stablelm-12b,
gemma-2b and qwen2-vl-7b, each reduced (``configs.reduced``: 2 layers,
d_model 64, 4 heads of 16), plus three variants the reduced configs never
reach: G = 1 (``num_kv_heads = num_heads``), G = 7 (14 query heads over 2)
and a head dim of 20 (no multiple of 8). Between them they cover the untied
``lm_head``, attention without qk-norm, GeGLU, MQA, MHA and Qwen2-VL's
M-RoPE.

``LM.extend`` (a mixed chunk: a prefill row, a decode rider, an idle row and
a part-filled row), ``LM.forward``, ``LM.prefill`` and ``LM.decode`` are held
against the reference built with ``kernel_backend="pallas"`` (its Pallas
kernels in interpret mode on the CPU) and with ``"jnp"``; weights come from
the reference's ``init_params`` through ``repro_torch.bridge`` and LoRA slots
get non-zero A and B from numpy, one row at adapter id -1. Engine tokens are
held against the JAX engine for reduced llama-7b and gemma-2b. Tolerance:
1e-4 for logits and caches (two layers of f32 sums in another order), as
``tests/test_torch_model.py``; engine tokens must be identical.

    PYTHONPATH=src python -m pytest -q tests/test_torch_archs.py
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import common as jcommon
from repro.serving import EngineConfig as JaxConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.models import build_model, make_prefill_step
from repro_torch.models import common
from repro_torch.serving import EngineConfig, Request, ServingEngine

XTOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ["pallas", "jnp"]

# (arch, overrides of the reduced config)
CASES = {
    "llama-7b": ("llama-7b", {}),
    "llama-13b": ("llama-13b", {}),
    "llama-34b": ("llama-34b", {}),
    "qwen3-4b": ("qwen3-4b", {}),
    "stablelm-12b": ("stablelm-12b", {}),
    "gemma-2b": ("gemma-2b", {}),
    "qwen2-vl-7b": ("qwen2-vl-7b", {}),
    "g1": ("llama-7b", dict(num_kv_heads=4)),
    "g7": ("llama-7b", dict(num_heads=14, num_kv_heads=2)),
    "d20": ("llama-7b", dict(head_dim=20)),
}
PARAMS = [(c, b) for c in CASES for b in BACKENDS]


def _cfgs(case):
    arch, over = CASES[case]
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)), **over)
    tcfg = dataclasses.replace(configs.reduced(configs.get(arch)), **over)
    return jcfg, tcfg


def _pair(case, backend, n_slots=3):
    """The reference LM on ``backend`` and the port's, sharing weights and
    non-zero LoRA slots."""
    jcfg, tcfg = _cfgs(case)
    jm = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend=backend)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), n_slots).items()}
    tm = build_model(tcfg, dtype=torch.float32, device="cpu")
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu")
    tlora = bridge.tensor_tree(lora, "cpu")
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return (jm, jparams, jl), (tm, tparams, tlora)


def _close(got, want, tol=XTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _history_caches(jm, tm, B, T, start, seed=6):
    """The same cache with random K/V below each row's start, for both."""
    rng = np.random.default_rng(seed)
    jc = jm.init_cache(B, T)
    live = (np.arange(T)[None, :] < start[:, None])[None, :, :, None, None]
    k = rng.standard_normal(jc["k"].shape, np.float32) * live
    v = rng.standard_normal(jc["v"].shape, np.float32) * live
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(start)}
    tc = tm.init_cache(B, T)
    tc["k"].copy_(torch.from_numpy(k))
    tc["v"].copy_(torch.from_numpy(v))
    tc["len"] = torch.from_numpy(start.copy())
    return jc, tc


def _check_cache(tc, jc):
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("case,backend", PARAMS)
def test_extend_mixed_chunk_matches_jax(case, backend):
    """A full prefill row, a decode rider (true_lens 1), an idle row
    (true_lens 0) and a part-filled row in one row-masked chunk."""
    (jm, jp, jl), (tm, tp, tl) = _pair(case, backend)
    start = np.array([0, 19, 12, 3], np.int32)
    jc, tc = _history_caches(jm, tm, 4, 32, start)
    tokens = np.random.default_rng(7).integers(0, 256, size=(4, 8)).astype(np.int32)
    true_lens = np.array([8, 1, 0, 5], np.int32)
    ids = np.array([2, -1, 0, 1], np.int32)
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(tokens), jnp.asarray(start), lora=jl,
                           adapter_ids=jnp.asarray(ids), all_logits=True,
                           true_lens=jnp.asarray(true_lens))
    tlog, tnew = tm.extend(tp, tc, torch.from_numpy(tokens), torch.from_numpy(start),
                           lora=tl, adapter_ids=torch.from_numpy(ids), all_logits=True,
                           true_lens=torch.from_numpy(true_lens))
    for b, n in enumerate(true_lens):  # real positions; pads are nobody's next token
        _close(tlog[b, :n], np.asarray(jlog)[b, :n])
    _check_cache(tnew, jnew)


@pytest.mark.parametrize("case,backend", PARAMS)
def test_forward_prefill_decode_match_jax(case, backend):
    """``forward``'s logits; ``prefill``'s last-token logits and seeded
    cache; one ``decode`` step on it through the paged path (a page size
    divides max_len)."""
    (jm, jp, jl), (tm, tp, tl) = _pair(case, backend)
    ids = np.array([2, -1, 0], np.int32)
    tokens = np.random.default_rng(8).integers(0, 256, size=(3, 13)).astype(np.int32)
    jlog, _ = jm.forward(jp, jnp.asarray(tokens), lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, _ = tm.forward(tp, torch.from_numpy(tokens), lora=tl,
                         adapter_ids=torch.from_numpy(ids))
    assert tlog.shape == (3, 13, 256)
    _close(tlog, jlog)
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), 16, lora=jl,
                          adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.prefill(tp, torch.from_numpy(tokens), 16, lora=tl,
                          adapter_ids=torch.from_numpy(ids))
    _close(tlog, jlog)
    _check_cache(tc, jc)
    nxt = np.array([[5], [250], [17]], np.int32)
    jlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.decode(tp, tc, torch.from_numpy(nxt), lora=tl,
                         adapter_ids=torch.from_numpy(ids))
    _close(tlog, jlog)
    _check_cache(tc, jc)


# ------------------------------------------------------------------ M-RoPE
def _mrope_positions(B, S, start=0, seed=9):
    """(3, B, S) temporal / height / width ids that differ from each other
    and from the token positions (an image's grid)."""
    rng = np.random.default_rng(seed)
    t = start + np.arange(S)[None, :] + np.zeros((B, 1), np.int64)
    return np.stack([t, t // 2 + rng.integers(0, 3, (B, S)), t % 5 + 1]).astype(np.int32)


def test_apply_mrope_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 4, 16), np.float32)
    pos = _mrope_positions(2, 7, start=30)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3, 3))
    _close(got, want, TOL)
    # three equal streams: plain RoPE (the text-only case)
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    _close(common.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6, (2, 3, 3)),
           common.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e6), TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mrope_forward_prefill_extend_match_jax(backend):
    """Reduced qwen2-vl-7b (G = 2) with M-RoPE position streams and extra
    embeddings through ``forward``, ``make_prefill_step`` and a chunked
    ``extend``."""
    (jm, jp, jl), (tm, tp, tl) = _pair("qwen2-vl-7b", backend)
    B, S = 3, 11
    rng = np.random.default_rng(11)
    ids = np.array([1, -1, 0], np.int32)
    tokens = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    extra = rng.standard_normal((B, S, 64), np.float32) * 0.1
    mpos = _mrope_positions(B, S)
    jlog, _ = jm.forward(jp, jnp.asarray(tokens), lora=jl, adapter_ids=jnp.asarray(ids),
                         extra_embeds=jnp.asarray(extra), mrope_positions=jnp.asarray(mpos))
    tlog, _ = tm.forward(tp, torch.from_numpy(tokens), lora=tl,
                         adapter_ids=torch.from_numpy(ids),
                         extra_embeds=torch.from_numpy(extra),
                         mrope_positions=torch.from_numpy(mpos))
    _close(tlog, jlog)
    # the step function reads both from the batch
    plain, _ = tm.forward(tp, torch.from_numpy(tokens), lora=tl,
                          adapter_ids=torch.from_numpy(ids))
    assert float((plain - tlog).abs().max()) > 1e-3  # they do move the logits
    batch = {"tokens": torch.from_numpy(tokens), "adapter_ids": torch.from_numpy(ids),
             "extra_embeds": torch.from_numpy(extra),
             "mrope_positions": torch.from_numpy(mpos)}
    last, _ = make_prefill_step(tm)(tp, tl, batch)
    _close(last[:, 0], np.asarray(jlog)[:, -1])
    # a chunk of 6 tokens at offsets into a cache with history
    start = np.array([4, 0, 9], np.int32)
    jc, tc = _history_caches(jm, tm, B, 24, start)
    chunk = tokens[:, :6]
    cpos = np.stack([_mrope_positions(1, 6, start=int(s), seed=12 + b)[:, 0]
                     for b, s in enumerate(start)], axis=1)  # (3, B, 6)
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(chunk), jnp.asarray(start), lora=jl,
                           adapter_ids=jnp.asarray(ids), all_logits=True,
                           extra_embeds=jnp.asarray(extra[:, :6]),
                           mrope_positions=jnp.asarray(cpos))
    tlog, tnew = tm.extend(tp, tc, torch.from_numpy(chunk), torch.from_numpy(start),
                           lora=tl, adapter_ids=torch.from_numpy(ids), all_logits=True,
                           extra_embeds=torch.from_numpy(extra[:, :6]),
                           mrope_positions=torch.from_numpy(cpos))
    _close(tlog, jlog)
    _check_cache(tnew, jnew)


# ------------------------------------------------------------------ engine
SYS = tuple(range(40, 52))  # 12-token shared prompt (3 blocks of 4)


def _fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


@pytest.mark.parametrize("arch", ["llama-7b", "gemma-2b"])
def test_engine_tokens_identical_to_reference(arch):
    """The port's engine on the CPU and the JAX engine (``"jnp"``), with the
    same weights, adapters and fake clock: shared-prefix spans, a fully
    adapter-specific prompt and a long ragged row, in mixed steps, then a
    request that reuses a finished one's KV."""
    sizes = dict(hbm_bytes=8 << 20, host_bytes=32 << 20, block_size=4,
                 max_batch_slots=4, max_seq_len=96)
    jeng = JaxEngine(jconfigs.reduced(jconfigs.get(arch)),
                     JaxConfig(kernel_backend="jnp", clock=_fake_clock(), **sizes),
                     key=jax.random.PRNGKey(13))
    teng = ServingEngine(configs.reduced(configs.get(arch)),
                         EngineConfig(clock=_fake_clock(), **sizes),
                         params=jax.tree.map(np.asarray, jeng.params), device="cpu")
    for i in range(3):
        aid = f"lora-{i}"
        jeng.register_adapter(aid)
        teng.register_adapter(aid, weights=bridge.tensor_tree(
            jeng.adapters._host[aid].weights, "cpu"))
    out = []
    for eng, make in ((jeng, JaxRequest), (teng, Request)):
        reqs = [make("a0", "lora-0", SYS + tuple(range(60, 65)), max_new_tokens=4,
                     shared_prefix_len=len(SYS)),
                make("a1", "lora-1", SYS + tuple(range(70, 73)), max_new_tokens=4,
                     shared_prefix_len=len(SYS)),
                make("a2", "lora-2", tuple(range(80, 87)), max_new_tokens=3),
                make("a3", "lora-0", tuple(range(90, 104)), max_new_tokens=3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        # a second wave: a finished request's prompt and tokens come back
        again = make("b0", "lora-2", reqs[2].full_tokens, max_new_tokens=3)
        eng.submit(again)
        eng.run()
        assert all(r.generated for r in reqs) and again.matched_tokens > 0
        out.append([tuple(r.generated) for r in reqs + [again]])
    assert out[1] == out[0]
    assert teng.manager.stats.kv_hit_rate() == jeng.manager.stats.kv_hit_rate() > 0
