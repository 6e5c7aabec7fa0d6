"""The port's MoE FFN and DeepSeek latent attention (MLA) against the
reference's, on reduced deepseek-v2-lite-16b (MLA, 1 shared + 4 routed
experts, top-2) and phi3.5-moe-42b-a6.6b (GQA 4/2, 4 experts, top-2).

Weights come from the reference's ``init_params`` through
``repro_torch.bridge``; LoRA slots get non-zero A and B from numpy. The
reference runs with ``kernel_backend="pallas"`` (its Pallas kernels in
interpret mode) and ``"jnp"``. Tolerances: 1e-5 for ``moe_ffn`` and its aux
loss and for the MLA functions (one layer of f32 sums in another order),
1e-4 for the LM's logits and caches (two layers), as
``tests/test_torch_archs.py``; engine tokens must be identical.

The reduced configs set ``capacity_factor = E`` (no token is dropped);
``moe_ffn`` is also held at the published 1.25 on a batch that drops, and
the engine on reduced deepseek with drops, where a step's rows share the
experts' capacity.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_mla.py
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import ffn as jffn
from repro.serving import EngineConfig as JaxConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention, build_model, ffn
from repro_torch.serving import EngineConfig, Request, ServingEngine

TOL = dict(rtol=1e-5, atol=1e-5)
XTOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["pallas", "jnp"]
ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"]


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)), **over)
    tcfg = dataclasses.replace(configs.reduced(configs.get(arch)), **over)
    return jcfg, tcfg


def _close(got, want, tol=XTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# --------------------------------------------------------------------- MoE
def _moe_case(arch, cf):
    """(reference cfg, port cfg, layer-0 ffn params for both, x (B, S, d))
    with the reduced config's experts at capacity factor ``cf``."""
    jcfg, tcfg = _cfgs(arch)
    moe = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg, moe=moe)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    p = jffn.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(2)
    # distinct experts: the reference's init repeats one
    p = {k: (rng.standard_normal(np.shape(v), np.float32) * 0.2 if k != "shared" else v)
         for k, v in p.items()}
    # a direction shared by every token skews the routing, so some expert
    # overflows at a capacity factor of 1.25
    x = (rng.standard_normal((3, 16, jcfg.d_model))
         + rng.standard_normal(jcfg.d_model)).astype(np.float32)
    tp = bridge.tensor_tree(jax.tree.map(np.asarray, p), "cpu")
    return jcfg, tcfg, p, tp, x


def _dropped_pairs(p, x, cfg) -> int:
    """(token, k) pairs over their expert's capacity, counted in numpy."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ np.asarray(p["router"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :m.top_k].reshape(-1)
    C = max(1, int(xt.shape[0] * m.top_k * m.capacity_factor / m.num_experts))
    return int(sum(max(0, c - C) for c in np.bincount(top, minlength=m.num_experts)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", ["E", 1.25])
def test_moe_ffn_matches_jax(arch, cf):
    """``moe_ffn`` and its Switch aux loss: at ``capacity_factor = E`` (no
    drops) and at the published 1.25 on 48 tokens that overflow an
    expert."""
    E = jconfigs.reduced(jconfigs.get(arch)).moe.num_experts
    jcfg, tcfg, p, tp, x = _moe_case(arch, float(E) if cf == "E" else cf)
    dropped = _dropped_pairs(p, x, jcfg)
    assert (dropped > 0) == (cf != "E"), dropped
    want, want_aux = jffn.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got, got_aux = ffn.moe_ffn(tp, _t(x), tcfg)
    _close(got, want, TOL)
    _close(got_aux, want_aux, TOL)


def test_moe_init_draws_each_expert():
    cfg = configs.reduced(configs.get("deepseek-v2-lite-16b"))
    p = ffn.init_moe(torch.Generator().manual_seed(0), cfg, 2)
    assert p["w_gate"].shape == (2, 4, cfg.d_model, 32)
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][0, 1])
    assert set(p) == {"router", "w_gate", "w_up", "w_down", "shared"}


# --------------------------------------------------------------------- MLA
def _mla_layer():
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    p = jattn.init_mla(jax.random.PRNGKey(4), jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    p = {k: np.asarray(v) + (rng.standard_normal(np.shape(v), np.float32) * 0.1
                             if k == "kv_norm" else 0) for k, v in p.items()}
    lora = {}
    for t, (din, dout) in build_model(tcfg, dtype=torch.float32, device="cpu").lora_dims().items():
        lora[t] = (rng.standard_normal((3, din, 4), np.float32) * 0.2,
                   rng.standard_normal((3, 4, dout), np.float32) * 0.2)
    return jcfg, tcfg, p, lora


def test_mla_full_matches_jax():
    jcfg, tcfg, p, lora = _mla_layer()
    B, S = 3, 9
    x = np.random.default_rng(6).standard_normal((B, S, jcfg.d_model), np.float32)
    ids = np.array([2, -1, 0], np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, (wl, wk) = jattn.mla_full(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), jcfg,
        lora=jax.tree.map(jnp.asarray, lora), adapter_ids=jnp.asarray(ids),
        lora_scale=0.5)
    rope = attention.step_rope(tcfg, torch.arange(S))
    got, (gl, gk) = attention.mla_full(
        bridge.tensor_tree(p, "cpu"), _t(x), rope, tcfg,
        lora=bridge.tensor_tree(lora, "cpu"), adapter_ids=_t(ids), lora_scale=0.5)
    for g, w in ((got, want), (gl, wl), (gk, wk)):
        _close(g, w, TOL)


@pytest.mark.parametrize("chunk", ["mixed", "decode"])
def test_mla_cached_matches_jax(chunk):
    """The absorbed form over a cache with history: a row-masked chunk (a
    full row, a decode rider, an idle row, a part-filled one) or one decode
    token per row (S = 1, no mask)."""
    jcfg, tcfg, p, lora = _mla_layer()
    m = jcfg.mla
    B, T = 4, 24
    rng = np.random.default_rng(7)
    start = np.array([0, 17, 9, 3], np.int32)
    live = (np.arange(T)[None, :] < start[:, None])[..., None]
    lat = rng.standard_normal((B, T, m.kv_lora_rank), np.float32) * live
    kr = rng.standard_normal((B, T, m.qk_rope_head_dim), np.float32) * live
    if chunk == "mixed":
        S, tl = 6, np.array([6, 1, 0, 4], np.int32)
    else:
        S, tl = 1, None
    x = rng.standard_normal((B, S, jcfg.d_model), np.float32)
    ids = np.array([1, -1, 0, 2], np.int32)
    mask = None if tl is None else jnp.asarray(np.arange(S)[None, :] < tl[:, None])
    want, (wl, wk) = jattn.mla_cached(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(start),
        jnp.asarray(lat), jnp.asarray(kr), jcfg, lora=jax.tree.map(jnp.asarray, lora),
        adapter_ids=jnp.asarray(ids), lora_scale=0.5, token_mask=mask)
    gl, gk = _t(lat), _t(kr)
    step = attention.cached_step(start, S, T, "cpu", tcfg,
                                 true_lens=None if tl is None else _t(tl))
    got = attention.mla_cached(bridge.tensor_tree(p, "cpu"), _t(x), step, gl, gk,
                               tcfg, lora=bridge.tensor_tree(lora, "cpu"),
                               adapter_ids=_t(ids), lora_scale=0.5)
    n = np.full(B, S) if tl is None else tl
    for b in range(B):  # real positions; pads are nobody's output
        _close(got[b, :n[b]], np.asarray(want)[b, :n[b]], TOL)
    _close(gl, wl, TOL)
    _close(gk, wk, TOL)


# ---------------------------------------------------------------------- LM
def _pair(arch, backend, n_slots=3):
    jcfg, tcfg = _cfgs(arch)
    jm = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend=backend)
    jparams = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    # distinct experts: the reference's init repeats one
    for key in ("w_gate", "w_up", "w_down"):
        leaf = jparams["layers"]["ffn"][key]
        jparams["layers"]["ffn"][key] = leaf + rng.standard_normal(
            leaf.shape, np.float32) * 0.05
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), n_slots).items()}
    tm = build_model(tcfg, dtype=torch.float32, device="cpu")
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return ((jm, jax.tree.map(jnp.asarray, jparams), jl),
            (tm, bridge.tensor_tree(jparams, "cpu"), bridge.tensor_tree(lora, "cpu")))


def _history_caches(jm, tm, B, T, start, seed=6):
    """The same cache with random rows below each row's start, for both."""
    rng = np.random.default_rng(seed)
    jc = jm.init_cache(B, T)
    tc = tm.init_cache(B, T)
    for key in jc:
        if key == "len":
            continue
        shape = jc[key].shape
        live = np.arange(T)[None, None, :] < start[None, :, None]
        val = rng.standard_normal(shape, np.float32) * live.reshape(
            live.shape + (1,) * (len(shape) - 3))
        jc[key] = jnp.asarray(val)
        tc[key].copy_(torch.from_numpy(val))
    jc["len"] = jnp.asarray(start)
    tc["len"] = torch.from_numpy(start.copy())
    return jc, tc


def _check_cache(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        if key != "len":
            _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_matches_jax(arch, backend):
    """``forward`` (logits and the summed aux loss), ``prefill``'s
    last-token logits and cache, one ``decode`` step on it, and a
    row-masked ``extend`` (a full row, a decode rider, an idle row, a
    part-filled row) against a cache with history."""
    (jm, jp, jl), (tm, tp, tl) = _pair(arch, backend)
    ids = np.array([2, -1, 0], np.int32)
    tokens = np.random.default_rng(8).integers(0, 256, size=(3, 13)).astype(np.int32)
    jlog, jaux = jm.forward(jp, jnp.asarray(tokens), lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, taux = tm.forward(tp, _t(tokens), lora=tl, adapter_ids=_t(ids))
    _close(tlog, jlog)
    _close(taux, jaux)
    assert float(taux) > 0
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), 16, lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.prefill(tp, _t(tokens), 16, lora=tl, adapter_ids=_t(ids))
    _close(tlog, jlog)
    _check_cache(tc, jc)
    nxt = np.array([[5], [250], [17]], np.int32)
    jlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.decode(tp, tc, _t(nxt), lora=tl, adapter_ids=_t(ids))
    _close(tlog, jlog)
    _check_cache(tc, jc)

    start = np.array([0, 19, 12, 3], np.int32)
    jc, tc = _history_caches(jm, tm, 4, 32, start)
    chunk = np.random.default_rng(9).integers(0, 256, size=(4, 8)).astype(np.int32)
    true_lens = np.array([8, 1, 0, 5], np.int32)
    ids = np.array([2, -1, 0, 1], np.int32)
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(chunk), jnp.asarray(start), lora=jl,
                           adapter_ids=jnp.asarray(ids), all_logits=True,
                           true_lens=jnp.asarray(true_lens))
    tlog, tnew = tm.extend(tp, tc, _t(chunk), _t(start), lora=tl, adapter_ids=_t(ids),
                           all_logits=True, true_lens=_t(true_lens))
    for b, n in enumerate(true_lens):
        _close(tlog[b, :n], np.asarray(jlog)[b, :n])
    _check_cache(tnew, jnew)


def _spy(monkeypatch):
    """Count the kernel wrappers the model calls (on the CPU they run their
    plain versions, which the launch counts do not see)."""
    calls = dict.fromkeys(("fused_sgmv", "ragged_extend", "paged_attention",
                           "flash_prefill"), 0)
    for name in calls:
        fn = getattr(kernel_ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernel_ops, name, spy)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_routing(arch, monkeypatch):
    """phi3.5-moe's attention runs through ``flash_prefill``,
    ``ragged_extend`` and ``paged_attention`` as the reference routes GQA;
    MLA through none of them (the reference computes it with einsums). Both
    run every LoRA projection through ``fused_sgmv``: 4 targets a layer on
    phi, 3 (q, kv_a, o) on deepseek."""
    tcfg = configs.reduced(configs.get(arch))
    tm = build_model(tcfg, dtype=torch.float32, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0))
    lora = tm.init_lora(torch.Generator().manual_seed(1), 2)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    calls = _spy(monkeypatch)
    L, n_t = tcfg.num_layers, len(tm.lora_dims())
    assert n_t == (3 if tcfg.mla is not None else 4)
    tokens = torch.randint(0, 256, (2, 10), generator=torch.Generator().manual_seed(2))
    _, cache = tm.prefill(params, tokens, 16, lora=lora, adapter_ids=ids)
    tm.decode(params, cache, tokens[:, :1], lora=lora, adapter_ids=ids)
    tm.extend(params, cache, tokens[:, :4], cache["len"], lora=lora, adapter_ids=ids,
              true_lens=torch.tensor([4, 1], dtype=torch.int32))
    gqa = tcfg.mla is None
    assert calls == {"fused_sgmv": 3 * n_t * L, "flash_prefill": L * gqa,
                     "paged_attention": L * gqa, "ragged_extend": L * gqa}


# ------------------------------------------------------------------ engine
SYS = tuple(range(40, 52))  # 12-token shared prompt (3 blocks of 4)
SIZES = dict(hbm_bytes=8 << 20, host_bytes=32 << 20, block_size=4,
             max_batch_slots=4, max_seq_len=96)


def _fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _engines(arch, backend, cf=None, **engine_kw):
    jcfg, tcfg = _cfgs(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    jeng = JaxEngine(jcfg, JaxConfig(kernel_backend=backend, clock=_fake_clock(),
                                     **SIZES, **engine_kw), key=jax.random.PRNGKey(13))
    rng = np.random.default_rng(14)
    for key in ("w_gate", "w_up", "w_down"):  # distinct experts
        leaf = jeng.params["layers"]["ffn"][key]
        jeng.params["layers"]["ffn"][key] = leaf + jnp.asarray(
            rng.standard_normal(leaf.shape, np.float32) * 0.05)
    teng = ServingEngine(tcfg, EngineConfig(clock=_fake_clock(), **SIZES, **engine_kw),
                         params=jax.tree.map(np.asarray, jeng.params), device="cpu")
    for i in range(3):
        aid = f"lora-{i}"
        jeng.register_adapter(aid)
        teng.register_adapter(aid, weights=bridge.tensor_tree(
            jeng.adapters._host[aid].weights, "cpu"))
    return jeng, teng


def _serve_both(jeng, teng):
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


@pytest.mark.parametrize("arch,mode,cf", [
    ("deepseek-v2-lite-16b", "mixed", None),
    ("deepseek-v2-lite-16b", "alternate", None),
    ("deepseek-v2-lite-16b", "mixed", 1.25),
    ("phi3.5-moe-42b-a6.6b", "mixed", None),
])
def test_engine_tokens_identical_to_reference(arch, mode, cf):
    """The port's engine on the CPU and the JAX engine with the same
    weights, adapters and fake clock: shared-prefix spans, an
    adapter-specific prompt and a long ragged row, then a request that
    reuses a finished one's KV (for MLA through the latent pool). deepseek
    against the reference's ``"jnp"`` backend (MLA calls no kernel), also
    at ``capacity_factor`` 1.25 where a step's rows compete for the
    experts; phi3.5-moe against ``"pallas"``, whose attention kernels the
    port's routing mirrors for pad rows as well."""
    backend = "jnp" if arch.startswith("deepseek") else "pallas"
    jeng, teng = _engines(arch, backend, cf, schedule_mode=mode)
    if arch.startswith("deepseek"):
        assert teng.kv_spec.use_v is False and teng.kv_pool.v_hbm is None
        assert teng.kv_spec.bytes_per_token == jeng.kv_spec.bytes_per_token
    _serve_both(jeng, teng)


@pytest.mark.parametrize("arch", ARCHS)
def test_unkept_rows_reach_the_experts_as_in_the_reference(arch):
    """At a capacity factor that drops, the rows of a step compete for the
    experts, so rows the port does not keep (``keep_rows``: a catch-up
    decode, idle slots) must still reach the experts with the hidden
    states the reference gives them. The reference writes every row and
    the engine keeps some; the port writes the unkept rows too and puts
    their slots back: kept rows' logits and the whole cache match."""
    (jm, jp, jl), (tm, tp, tl) = _pair(arch, "jnp")
    cf = 0.5  # C = max(1, int(8·2·0.5/4)) = 2 places an expert for 16 pairs
    jm.cfg = dataclasses.replace(jm.cfg, moe=dataclasses.replace(jm.cfg.moe, capacity_factor=cf))
    tm.cfg = dataclasses.replace(tm.cfg, moe=dataclasses.replace(tm.cfg.moe, capacity_factor=cf))
    B, T = 8, 16
    start = np.array([3, 9, 5, 12, 7, 2, 11, 6], np.int32)
    jc, tc = _history_caches(jm, tm, B, T, start, seed=10)
    before = {k: v.clone() for k, v in tc.items()}
    keep = np.array([0, 0, 1, 0, 0, 0, 1, 1], bool)
    tokens = np.random.default_rng(11).integers(0, 256, size=(B, 1)).astype(np.int32)
    ids = np.array([0, 1, 2, -1, 0, 1, 2, -1], np.int32)
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(tokens), jnp.asarray(start), lora=jl,
                           adapter_ids=jnp.asarray(ids))
    tlog, tnew = tm.extend(tp, tc, _t(tokens), _t(start), lora=tl, adapter_ids=_t(ids),
                           keep_rows=_t(keep))
    _close(tlog[keep], np.asarray(jlog)[keep])
    for key in tnew:
        if key == "len":
            continue
        _close(tnew[key][:, keep], np.asarray(jnew[key])[:, keep])
        assert torch.equal(tnew[key][:, ~keep], before[key][:, ~keep])
    np.testing.assert_array_equal(tnew["len"].numpy(), np.where(keep, start + 1, start))
