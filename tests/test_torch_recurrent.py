"""The port's recurrent layouts against the reference's: RWKV-6's time and
channel mix, the RG-LRU block and its causal depthwise conv, and the
``LM`` paths of reduced rwkv6-1.6b and recurrentgemma-2b (window 16).

The mixers take numpy weights from a seed (RWKV's bonus ``u`` and
``ln_x`` non-zero, which the reference's init zeroes) and random carried
states, with and without a row mask whose rows hold 0, 1 and all real
tokens. The LM cases bridge the reference's weights through
``repro_torch.bridge`` with non-zero LoRA slots, and run the reference on
both ``kernel_backend``s; their sequences pass the window of 16, so the
hybrid's ring of slots wraps. Tolerance 1e-4 (f32 sums in another order:
the port's WKV loop takes the bonus term out of the recurrence, its
RG-LRU scan doubles where the reference's ``associative_scan`` recurses);
1e-5 for the conv, which sums in the reference's order.

    PYTHONPATH=src python -m pytest -q tests/test_torch_recurrent.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import recurrent as jrec
from repro_torch import bridge, configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import build_model
from repro_torch.models import recurrent

TOL = dict(rtol=1e-5, atol=1e-5)
XTOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["pallas", "jnp"]
ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]
B, S = 3, 9
LENS = [0, 1, S]  # real tokens of each row under a mask


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, tol=XTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _mask():
    return np.arange(S)[None, :] < np.array(LENS)[:, None]


def _cfg(arch):
    return configs.reduced(configs.get(arch)), jconfigs.reduced(jconfigs.get(arch))


# ------------------------------------------------------------------ mixers
def _rwkv_weights(cfg, rng):
    d, ff, dr = cfg.d_model, cfg.d_ff, cfg.rwkv.decay_rank
    H, N = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    p = {k: rng.uniform(0, 0.5, d).astype(np.float32)
         for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr")}
    p.update(w0=rng.uniform(-3.0, 0.0, d).astype(np.float32), wa=n(d, dr, s=0.2),
             wb=n(dr, d, s=0.2), u=n(H, N, s=0.3), ln_x=n(d, s=0.1),
             w_ck=n(d, ff, s=d ** -0.5), w_cv=n(ff, d, s=ff ** -0.5))
    for k in ("wr", "wk", "wv", "wg", "wo", "w_cr"):
        p[k] = n(d, d, s=d ** -0.5)
    state = {"tm_x": n(B, d), "wkv": n(B, H, N, N, s=0.3), "cm_x": n(B, d)}
    lora = {t: (n(3, d, 4, s=0.3), n(3, 4, d, s=0.3)) for t in ("r", "k", "v", "o")}
    return p, state, lora


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_rwkv_time_and_channel_mix_match_jax(masked):
    tcfg, jcfg = _cfg("rwkv6-1.6b")
    rng = np.random.default_rng(0)
    p, state, lora = _rwkv_weights(tcfg, rng)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ids = np.array([1, -1, 0], np.int32)
    mask = _mask() if masked else None
    jp, jst, jl = (jax.tree.map(jnp.asarray, t) for t in (p, state, lora))
    want, wst = jrec.rwkv_time_mix(jp, jnp.asarray(x), jst, jcfg, jl, jnp.asarray(ids),
                                   0.5, None if mask is None else jnp.asarray(mask))
    tp, tst, tl = (bridge.tensor_tree(t, "cpu") for t in (p, state, lora))
    tmask = None if mask is None else _t(mask)
    got, gst = recurrent.rwkv_time_mix(tp, _t(x), tst, tcfg, tl, _t(ids), 0.5, tmask)
    _close(got, want)
    for k in wst:
        _close(gst[k], wst[k])
    if masked:  # a row with no real token keeps its state exactly
        assert torch.equal(gst["wkv"][0], tst["wkv"][0])
        assert torch.equal(gst["tm_x"][0], tst["tm_x"][0])
    want, wst = jrec.rwkv_channel_mix(jp, jnp.asarray(x), jst, jcfg,
                                      None if mask is None else jnp.asarray(mask))
    got, gst = recurrent.rwkv_channel_mix(tp, _t(x), tst, tcfg, tmask)
    _close(got, want, TOL)
    for k in wst:
        _close(gst[k], wst[k], TOL)


def test_rwkv_lora_goes_through_fused_sgmv(monkeypatch):
    """The four LoRA targets run through ``fused_sgmv`` (the reference adds
    its gather einsum); the other products are plain."""
    tcfg, _ = _cfg("rwkv6-1.6b")
    p, state, lora = _rwkv_weights(tcfg, np.random.default_rng(1))
    calls = []
    fn = kernel_ops.fused_sgmv

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(kernel_ops, "fused_sgmv", spy)
    x = torch.randn((B, S, tcfg.d_model))
    recurrent.rwkv_time_mix(bridge.tensor_tree(p, "cpu"), x, bridge.tensor_tree(state, "cpu"),
                            tcfg, bridge.tensor_tree(lora, "cpu"),
                            torch.tensor([0, 1, -1], dtype=torch.int32), 1.0)
    assert len(calls) == 4


def _rglru_weights(cfg, rng):
    d, w, cw = cfg.d_model, cfg.rglru.lru_width, cfg.rglru.conv_width

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    p = dict(w_in=n(d, w, s=d ** -0.5), w_gel=n(d, w, s=d ** -0.5), conv_w=n(cw, w, s=0.3),
             conv_b=n(w, s=0.1), w_a=n(w, w, s=w ** -0.5), b_a=n(w, s=0.1),
             w_i=n(w, w, s=w ** -0.5), b_i=n(w, s=0.1),
             lam=np.linspace(0.5, 5.0, w).astype(np.float32), w_out=n(w, d, s=w ** -0.5))
    state = {"h": n(B, w), "conv": n(B, cw - 1, w)}
    return p, state


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_rglru_block_and_conv_match_jax(masked):
    tcfg, jcfg = _cfg("recurrentgemma-2b")
    rng = np.random.default_rng(2)
    p, state = _rglru_weights(tcfg, rng)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    mask = _mask() if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)
    u = rng.standard_normal((B, S, tcfg.rglru.lru_width)).astype(np.float32)
    want, wcarry = jrec._causal_depthwise_conv(
        jnp.asarray(u), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
        jnp.asarray(state["conv"]), jmask)
    got, gcarry = recurrent._causal_depthwise_conv(
        _t(u), _t(p["conv_w"]), _t(p["conv_b"]), _t(state["conv"]), tmask)
    _close(got, want, TOL)
    _close(gcarry, wcarry, TOL)
    jp, jst = (jax.tree.map(jnp.asarray, t) for t in (p, state))
    want, wst = jrec.rglru_block(jp, jnp.asarray(x), jst, jcfg, jmask)
    tst = bridge.tensor_tree(state, "cpu")
    got, gst = recurrent.rglru_block(bridge.tensor_tree(p, "cpu"), _t(x), tst, tcfg, tmask)
    _close(got, want)
    for k in wst:
        _close(gst[k], wst[k])
    if masked:  # a row with no real token keeps its state exactly
        assert torch.equal(gst["h"][0], tst["h"][0])
        assert torch.equal(gst["conv"][0], tst["conv"][0])


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(recurrent.linear_scan(a, b), torch.stack(want, 1), TOL)


# ---------------------------------------------------------------------- LM
def _pair(arch, backend, **fields):
    """The reference LM on ``backend`` and the port's, sharing weights and
    non-zero LoRA slots; ``fields`` replaced in both configs."""
    tcfg, jcfg = (dataclasses.replace(c, **fields) for c in _cfg(arch))
    jm = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend=backend)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), 3).items()}
    tm = build_model(tcfg, dtype=torch.float32, device="cpu")
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu")
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return (jm, jparams, jl), (tm, tparams, bridge.tensor_tree(lora, "cpu"))


def _check_cache(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        if key == "len":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            _close(tc[key], jc[key])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_paths_match_jax(arch, backend):
    """forward; prefill of 20 tokens into a 32-token cache (the hybrid's
    window of 16 is a ring); a row-masked extend of 8 (rows of 8, 0 and 3
    real tokens); two decode steps; every cache leaf and the real
    positions' logits within 1e-4."""
    (jm, jp, jl), (tm, tp, tl) = _pair(arch, backend)
    rng = np.random.default_rng(6)
    ids = np.array([0, -1, 2], np.int32)
    tokens = rng.integers(0, 256, (3, 20)).astype(np.int32)
    jids, tids = jnp.asarray(ids), _t(ids)
    want, _ = jm.forward(jp, jnp.asarray(tokens), lora=jl, adapter_ids=jids)
    got, _ = tm.forward(tp, _t(tokens), lora=tl, adapter_ids=tids)
    _close(got, want)
    wlast, jc = jm.prefill(jp, jnp.asarray(tokens), 32, lora=jl, adapter_ids=jids)
    glast, tc = tm.prefill(tp, _t(tokens), 32, lora=tl, adapter_ids=tids)
    _close(glast, wlast)
    _close(glast[:, 0], want[:, -1])
    _check_cache(tc, jc)
    chunk = rng.integers(0, 256, (3, 8)).astype(np.int32)
    lens = np.array([8, 0, 3], np.int32)
    wlog, jc = jm.extend(jp, jc, jnp.asarray(chunk), jc["len"], lora=jl, adapter_ids=jids,
                         all_logits=True, true_lens=jnp.asarray(lens))
    glog, tc = tm.extend(tp, tc, _t(chunk), tc["len"], lora=tl, adapter_ids=tids,
                         all_logits=True, true_lens=_t(lens))
    for b, n in enumerate(lens):
        _close(glog[b, :n], np.asarray(wlog)[b, :n])
    _check_cache(tc, jc)
    for step in range(2):
        nxt = rng.integers(0, 256, (3, 1)).astype(np.int32)
        wlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl, adapter_ids=jids)
        glog, tc = tm.decode(tp, tc, _t(nxt), lora=tl, adapter_ids=tids)
        _close(glog, wlog)
        _check_cache(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_keeps_unkept_rows(arch):
    """``keep_rows``: a kept row's state and logits are the reference's
    (which advances every row); an unkept row's state, window and ``len``
    do not change."""
    (jm, jp, jl), (tm, tp, tl) = _pair(arch, "jnp")
    rng = np.random.default_rng(7)
    ids = np.array([1, 0, -1], np.int32)
    tokens = rng.integers(0, 256, (3, 18)).astype(np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(tokens), 32, lora=jl, adapter_ids=jnp.asarray(ids))
    _, tc = tm.prefill(tp, _t(tokens), 32, lora=tl, adapter_ids=_t(ids))
    before = {k: v.clone() for k, v in tc.items()}
    nxt = rng.integers(0, 256, (3, 1)).astype(np.int32)
    keep = np.array([True, False, True])
    wlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl, adapter_ids=jnp.asarray(ids))
    glog, tc = tm.extend(tp, tc, _t(nxt), tc["len"], lora=tl, adapter_ids=_t(ids),
                         keep_rows=_t(keep))
    kept = np.flatnonzero(keep)
    _close(glog[kept], np.asarray(wlog)[kept])
    for key in jc:
        if key == "len":
            assert tc[key].tolist() == [19, 18, 19]
            continue
        _close(tc[key][:, kept], np.asarray(jc[key])[:, kept])
        assert torch.equal(tc[key][:, 1], before[key][:, 1])


def test_hybrid_window_passes_only_to_attention():
    """The hybrid's attention layers take the window (the plain attention,
    no kernel); forward over 24 tokens with a window of 16 differs from
    forward without it, and the port agrees with the reference both ways."""
    for window in (16, 0):
        tcfg, jcfg = (dataclasses.replace(c, window_size=window)
                      for c in _cfg("recurrentgemma-2b"))
        jm = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend="jnp")
        jp = jm.init_params(jax.random.PRNGKey(8))
        tm = build_model(tcfg, dtype=torch.float32, device="cpu")
        tp = bridge.tensor_tree(jax.tree.map(np.asarray, jp), "cpu")
        tokens = np.random.default_rng(9).integers(0, 256, (2, 24)).astype(np.int32)
        want, _ = jm.forward(jp, jnp.asarray(tokens))
        got, _ = tm.forward(tp, _t(tokens))
        _close(got, want)
        if window:
            windowed = got
    assert not torch.allclose(windowed[:, 17:], got[:, 17:], atol=1e-3)


@pytest.mark.parametrize("prompt", [17, 40])
def test_hybrid_prefill_past_its_window_is_the_references(prompt):
    """A fresh prefill longer than the window (16) into a 48-position
    cache, at 6 layers (two local-attention layers): the port's last-token
    logits and state are the reference's on the same weights. Both write
    only the last 16 tokens into the ring and attend over it, so every
    query but the last few loses in-window keys, and through the second
    attention layer the last token's logits differ from a windowed
    ``forward``, in both packages alike (ROADMAP Queue 3 item 2)."""
    (jm, jp, jl), (tm, tp, tl) = _pair("recurrentgemma-2b", "jnp", num_layers=6)
    assert tm.cfg.window_size == 16
    tokens = np.random.default_rng(10).integers(0, 256, (3, prompt)).astype(np.int32)
    ids = np.array([0, -1, 2], np.int32)
    jids, tids = jnp.asarray(ids), _t(ids)
    wlast, jc = jm.prefill(jp, jnp.asarray(tokens), 48, lora=jl, adapter_ids=jids)
    glast, tc = tm.prefill(tp, _t(tokens), 48, lora=tl, adapter_ids=tids)
    _close(glast, wlast)
    _check_cache(tc, jc)
    want, _ = jm.forward(jp, jnp.asarray(tokens), lora=jl, adapter_ids=jids)
    got, _ = tm.forward(tp, _t(tokens), lora=tl, adapter_ids=tids)
    for full, last in ((got.numpy(), glast.numpy()), (np.asarray(want), np.asarray(wlast))):
        assert np.abs(full[:, -1] - last[:, 0]).max() > 1e-2
