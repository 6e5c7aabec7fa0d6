"""The port's GQA variants against the reference's: the int8 KV cache, the
logit softcap and the sliding window (with its ring of slots).

The reference routes all three to its einsum attention, never to a kernel
(``repro/models/attention.py``: ``gqa_full``'s and ``gqa_cached``'s kernel
tests), and so does the port: its plain ``sdpa``. int8 KV mirrors
``tests/test_kv_quant.py`` and is held against the reference's
``kv_quant`` LM; the softcap runs on reduced qwen3-0.6b with
``logit_softcap`` set (no config sets one); the window is held on the
attention functions themselves (the reference's ``LM`` passes a window
only to the recurrent hybrid's layers, ROADMAP Queue 1 item 3). The LM
cases run the reference on both ``kernel_backend``s. Tolerances: int8
values equal (in a cache, one step apart at a rounding tie, for under
0.1 % of them) and scales within 1e-6; 1e-5 for one attention layer, 1e-4
for the LM's logits and caches (two layers of f32 sums in another order).

    PYTHONPATH=src python -m pytest -q tests/test_torch_attn_variants.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro_torch import bridge, configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention, build_model

TOL = dict(rtol=1e-5, atol=1e-5)
XTOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["pallas", "jnp"]
SOFTCAP = 0.5  # small enough that tanh bends the reduced model's logits


def _close(got, want, tol=XTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _pair(backend, kv_quant=False, **over):
    """The reference LM on ``backend`` and the port's on reduced
    qwen3-0.6b, sharing weights and non-zero LoRA slots."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("qwen3-0.6b")), **over)
    tcfg = dataclasses.replace(configs.reduced(configs.get("qwen3-0.6b")), **over)
    jm = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend=backend,
                         kv_quant=kv_quant)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), 3).items()}
    tm = build_model(tcfg, dtype=torch.float32, device="cpu", kv_quant=kv_quant)
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu")
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return (jm, jparams, jl), (tm, tparams, bridge.tensor_tree(lora, "cpu"))


def _check_cache(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        if key == "len":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        elif jc[key].dtype == jnp.int8:
            assert tc[key].dtype == torch.int8
            # a value at a rounding tie may land one step apart
            diff = np.abs(tc[key].numpy().astype(np.int32) - np.asarray(jc[key], np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            _close(tc[key], jc[key])


def _spy(monkeypatch):
    calls = dict.fromkeys(("ragged_extend", "paged_attention", "flash_prefill"), 0)
    for name in calls:
        fn = getattr(kernel_ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernel_ops, name, spy)
    return calls


def _run_static(pair, ids, tokens, nxt):
    """prefill (with cache) then one decode step, on both; returns the
    (port, reference) logits and caches of each."""
    (jm, jp, jl), (tm, tp, tl) = pair
    out = []
    for m, p, lora, conv in ((tm, tp, tl, _t), (jm, jp, jl, jnp.asarray)):
        log1, c = m.prefill(p, conv(tokens), 16, lora=lora, adapter_ids=conv(ids))
        snap = {k: (np.asarray(v).copy()) for k, v in c.items()}
        log2, c = m.decode(p, c, conv(nxt), lora=lora, adapter_ids=conv(ids))
        out.append((log1, snap, log2, c))
    return out


# ------------------------------------------------------------------- int8 KV
def test_quantize_kv_rows_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 16, 4, 32), np.float32)
    wq, ws = jattn.quantize_kv_rows(jnp.asarray(x))
    gq, gs = attention.quantize_kv_rows(_t(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    _close(gs, ws, dict(rtol=1e-6, atol=0))
    deq = gq.float() * gs[..., None]
    assert float((deq - _t(x)).abs().max() / np.abs(x).max()) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_int8_cache_matches_jax(backend, monkeypatch):
    """``kv_quant``: prefill quantises each layer's rows into the int8
    cache, decode and a row-masked extend write quantised rows and attend
    the dequantised cache through the plain ``sdpa`` (prefill still
    through ``flash_prefill``), as the reference does. A value at a
    rounding tie may quantise one step apart (f32 sums in another order),
    so each step starts from the reference's cache."""
    (jm, jp, jl), (tm, tp, tl) = _pair(backend, kv_quant=True)
    calls = _spy(monkeypatch)
    ids = np.array([2, -1, 0], np.int32)
    tokens = np.random.default_rng(8).integers(0, 256, size=(3, 13)).astype(np.int32)
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), 16, lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.prefill(tp, _t(tokens), 16, lora=tl, adapter_ids=_t(ids))
    assert tc["k"].dtype == torch.int8
    _close(tlog, jlog)
    _check_cache(tc, jc)

    def port_cache(c):
        return {k: (_t(v) if k != "len" else _t(np.asarray(v))) for k, v in c.items()}

    nxt = np.array([[5], [250], [17]], np.int32)
    tlog, tc = tm.decode(tp, port_cache(jc), _t(nxt), lora=tl, adapter_ids=_t(ids))
    jlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl, adapter_ids=jnp.asarray(ids))
    _close(tlog, jlog)
    _check_cache(tc, jc)
    L = tm.cfg.num_layers
    assert calls == {"flash_prefill": L, "paged_attention": 0, "ragged_extend": 0}
    chunk = tokens[:, :5]
    tl_ = np.array([5, 1, 3], np.int32)
    tlog, tnew = tm.extend(tp, port_cache(jc), _t(chunk), _t(np.asarray(jc["len"])),
                           lora=tl, adapter_ids=_t(ids), all_logits=True,
                           true_lens=_t(tl_))
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(chunk), jc["len"], lora=jl,
                           adapter_ids=jnp.asarray(ids), all_logits=True,
                           true_lens=jnp.asarray(tl_))
    for b, n in enumerate(tl_):
        _close(tlog[b, :n], np.asarray(jlog)[b, :n])
    _check_cache(tnew, jnew)


def test_int8_cache_decode_keeps_greedy_tokens():
    """As ``tests/test_kv_quant.py``: the int8 cache gives the f32 cache's
    greedy tokens over several steps, at a bit more than a quarter of its
    bytes per K/V value."""
    cfg = configs.reduced(configs.get("qwen3-0.6b"))
    fp = build_model(cfg, dtype=torch.float32, device="cpu")
    q8 = build_model(cfg, dtype=torch.float32, device="cpu", kv_quant=True)
    params = fp.init_params(torch.Generator().manual_seed(0))
    lora = fp.init_lora(torch.Generator().manual_seed(1), 2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(2))
    ids = torch.tensor([0, 1], dtype=torch.int32)
    lf, cf = fp.prefill(params, tokens, 24, lora=lora, adapter_ids=ids)
    lq, cq = q8.prefill(params, tokens, 24, lora=lora, adapter_ids=ids)
    assert cq["k"].dtype == torch.int8
    np.testing.assert_allclose(lq.numpy(), lf.numpy(), rtol=0.05, atol=0.05)
    tf, tq = lf[:, -1].argmax(-1), lq[:, -1].argmax(-1)
    assert torch.equal(tf, tq)
    for _ in range(6):
        lf, cf = fp.decode(params, cf, tf[:, None], lora=lora, adapter_ids=ids)
        lq, cq = q8.decode(params, cq, tq[:, None], lora=lora, adapter_ids=ids)
        tf, tq = lf[:, -1].argmax(-1), lq[:, -1].argmax(-1)
        assert torch.equal(tf, tq), "int8 KV changed the greedy tokens"
    nbytes = [sum(v.numel() * v.element_size() for k, v in c.items() if k != "len")
              for c in (cf, cq)]
    assert nbytes[1] < 0.7 * nbytes[0] / 2  # vs a bf16 cache, as the reference's test


# ------------------------------------------------------------------- softcap
@pytest.mark.parametrize("backend", BACKENDS)
def test_softcap_matches_jax(backend, monkeypatch):
    """``logit_softcap`` set: forward, prefill and decode through the plain
    ``sdpa`` with tanh-capped logits, as the reference routes them."""
    pair = _pair(backend, logit_softcap=SOFTCAP)
    (jm, jp, jl), (tm, tp, tl) = pair
    calls = _spy(monkeypatch)
    ids = np.array([2, -1, 0], np.int32)
    tokens = np.random.default_rng(8).integers(0, 256, size=(3, 13)).astype(np.int32)
    jlog, _ = jm.forward(jp, jnp.asarray(tokens), lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, _ = tm.forward(tp, _t(tokens), lora=tl, adapter_ids=_t(ids))
    _close(tlog, jlog)
    nxt = np.array([[5], [250], [17]], np.int32)
    (t1, tsnap, t2, tc), (j1, jsnap, j2, jc) = _run_static(pair, ids, tokens, nxt)
    _close(t1, j1)
    _close(t2, j2)
    _check_cache(tc, jc)
    assert calls == dict.fromkeys(calls, 0)
    # the cap moves the logits: the same weights without it
    (_, (tm0, _, _)) = _pair(backend)
    plain, _ = tm0.forward(tp, _t(tokens), lora=tl, adapter_ids=_t(ids))
    assert float((plain - tlog).abs().max()) > 1e-3


# -------------------------------------------------------------------- window
def _gqa_layer(cfg_over=None):
    jcfg = jconfigs.reduced(jconfigs.get("qwen3-0.6b"))
    tcfg = configs.reduced(configs.get("qwen3-0.6b"))
    if cfg_over:
        jcfg = dataclasses.replace(jcfg, **cfg_over)
        tcfg = dataclasses.replace(tcfg, **cfg_over)
    p = jax.tree.map(np.asarray, jattn.init_gqa(jax.random.PRNGKey(4), jcfg, jnp.float32))
    return jcfg, tcfg, p


@pytest.mark.parametrize("softcap", [0.0, SOFTCAP])
def test_gqa_full_window_matches_jax(softcap):
    jcfg, tcfg, p = _gqa_layer(dict(logit_softcap=softcap))
    B, S, W = 2, 12, 5
    x = np.random.default_rng(6).standard_normal((B, S, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, (wk, wv) = jattn.gqa_full(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                    jnp.asarray(pos), jcfg, window=W)
    got, (gk, gv) = attention.gqa_full(bridge.tensor_tree(p, "cpu"), _t(x),
                                       attention.step_rope(tcfg, torch.arange(S)),
                                       tcfg, window=W)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, TOL)


def _cached_pair(p, jcfg, tcfg, x, start, ck, cv, W, true_lens=None):
    """The reference's and the port's ``gqa_cached`` with ``window`` W on
    the same cache: (port out, cache k, cache v), (reference ...)."""
    S = x.shape[1]
    mask = None if true_lens is None else np.arange(S)[None, :] < true_lens[:, None]
    want, (wk, wv) = jattn.gqa_cached(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(start),
        jnp.asarray(ck), jnp.asarray(cv), jcfg, window=W,
        token_mask=None if mask is None else jnp.asarray(mask))
    gk, gv = _t(ck), _t(cv)
    step = attention.cached_step(start, S, ck.shape[1], "cpu", tcfg,
                                 true_lens=None if true_lens is None else _t(true_lens),
                                 window=W)
    got = attention.gqa_cached(bridge.tensor_tree(p, "cpu"), _t(x), step, gk, gv, tcfg)
    return (got, gk, gv), (want, wk, wv)


@pytest.mark.parametrize("T", [32, 8], ids=["cache_past_window", "ring"])
def test_gqa_cached_window_matches_jax(T):
    """A window of 8 over a 32-slot cache, and over a ring of 8 slots (T ==
    window, slots are positions modulo 8): decode steps past the ring's
    wrap, then a row-masked chunk whose pads must not shadow live keys."""
    W = 8
    jcfg, tcfg, p = _gqa_layer()
    rng = np.random.default_rng(7)
    B, Hkv, D = 3, tcfg.num_kv_heads, tcfg.resolved_head_dim
    ck = np.zeros((B, T, Hkv, D), np.float32)
    cv = np.zeros((B, T, Hkv, D), np.float32)
    start = np.zeros(B, np.int32)
    # a prefill of 6 tokens (within the ring), then 7 decode steps: every
    # row wraps the ring
    x = rng.standard_normal((B, 6, jcfg.d_model), np.float32)
    (got, ck_t, cv_t), (want, ck_j, cv_j) = _cached_pair(p, jcfg, tcfg, x, start, ck, cv, W)
    _close(got, want, TOL)
    ck, cv, start = np.asarray(ck_j), np.asarray(cv_j), start + 6
    for _ in range(7):
        x = rng.standard_normal((B, 1, jcfg.d_model), np.float32)
        (got, ck_t, cv_t), (want, ck_j, cv_j) = _cached_pair(
            p, jcfg, tcfg, x, start, ck, cv, W)
        _close(got, want, TOL)
        _close(ck_t, ck_j, TOL)
        _close(cv_t, cv_j, TOL)
        ck, cv, start = np.asarray(ck_j), np.asarray(cv_j), start + 1
    # a row-masked chunk: a full row, a decode rider, a part-filled row
    tl = np.array([6, 1, 3], np.int32)
    x = rng.standard_normal((B, 6, jcfg.d_model), np.float32)
    (got, ck_t, cv_t), (want, ck_j, cv_j) = _cached_pair(
        p, jcfg, tcfg, x, start, ck, cv, W, true_lens=tl)
    for b, n in enumerate(tl):
        _close(got[b, :n], np.asarray(want)[b, :n], TOL)
    _close(ck_t, ck_j, TOL)
    _close(cv_t, cv_j, TOL)


def test_ring_refuses_a_masked_chunk_wider_than_the_window():
    """Both packages refuse a row-masked chunk wider than the ring: its pad
    slots would land on the chunk's own writes."""
    jcfg, tcfg, p = _gqa_layer()
    B, S, W = 2, 10, 8
    x = np.zeros((B, S, jcfg.d_model), np.float32)
    ck = np.zeros((B, W, tcfg.num_kv_heads, tcfg.resolved_head_dim), np.float32)
    tl = np.array([10, 4], np.int32)
    with pytest.raises(ValueError, match="exceeds ring window"):
        _cached_pair(p, jcfg, tcfg, x, np.zeros(B, np.int32), ck, ck.copy(), W, tl)
    with pytest.raises(ValueError, match="exceeds ring window"):
        attention.cached_step(np.zeros(B, np.int32), S, W, "cpu", tcfg,
                              true_lens=_t(tl), window=W)
