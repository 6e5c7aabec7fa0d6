"""The port's encoder-decoder LM against the reference's ``EncDecLM`` on
reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, 4/4 heads
of 16): ``encode``, ``forward``, ``prefill`` then ``decode``, and the step
functions, with the reference's weights bridged through
``repro_torch.bridge``, non-zero LoRA slots, frames from a seeded numpy
generator, and the reference on both ``kernel_backend``s. Tolerance 1e-4
(f32 sums in another order), 1e-5 for the encoder alone. The decoder's
routing is checked by spies: ``flash_prefill`` in ``forward``,
``ragged_extend`` in ``prefill``, ``paged_attention`` in ``decode``
(the cache's 24 positions are pages of 8).

    PYTHONPATH=src python -m pytest -q tests/test_torch_encdec.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import make_decode_step as jax_decode_step
from repro.models import make_prefill_step as jax_prefill_step
from repro_torch import bridge, configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import (EncDecLM, build_model, make_decode_step,
                                make_prefill_step)

TOL = dict(rtol=1e-5, atol=1e-5)
XTOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["pallas", "jnp"]
ARCH = "seamless-m4t-large-v2"


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, tol=XTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _pair(backend):
    jm = jax_build_model(jconfigs.reduced(jconfigs.get(ARCH)), dtype=jnp.float32,
                         kernel_backend=backend)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), 3).items()}
    tm = build_model(configs.reduced(configs.get(ARCH)), dtype=torch.float32, device="cpu")
    assert isinstance(tm, EncDecLM)
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu")
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return (jm, jparams, jl), (tm, tparams, bridge.tensor_tree(lora, "cpu"))


def _inputs(seed=6, B=3, S_src=12, S=16):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_src, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    ids = np.array([0, -1, 2], np.int32)[:B]
    return frames, tokens, ids


def _spy(monkeypatch):
    calls = dict.fromkeys(("ragged_extend", "paged_attention", "flash_prefill",
                           "fused_sgmv"), 0)
    for name in calls:
        fn = getattr(kernel_ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernel_ops, name, spy)
    return calls


def test_encode_matches_jax():
    (jm, jp, _), (tm, tp, _) = _pair("jnp")
    frames, _, _ = _inputs()
    _close(tm.encode(tp, _t(frames)), jm.encode(jp, jnp.asarray(frames)), TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_prefill_decode_match_jax(backend, monkeypatch):
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    frames, tokens, ids = _inputs()
    jf, jt, ji = map(jnp.asarray, (frames, tokens, ids))
    calls = _spy(monkeypatch)
    want, waux = jm.forward(jp, jf, jt, lora=jl, adapter_ids=ji)
    got, gaux = tm.forward(tp, _t(frames), _t(tokens), lora=tl, adapter_ids=_t(ids))
    _close(got, want)
    assert float(gaux) == float(waux) == 0.0
    L = tm.cfg.num_layers
    assert calls == dict(ragged_extend=0, paged_attention=0, flash_prefill=L,
                         fused_sgmv=4 * L)
    wlast, jc = jm.prefill(jp, jf, jt[:, :15], 24, lora=jl, adapter_ids=ji)
    glast, tc = tm.prefill(tp, _t(frames), _t(tokens[:, :15]), 24, lora=tl,
                           adapter_ids=_t(ids))
    _close(glast, wlast)
    _close(glast[:, 0], want[:, 14])
    assert calls["ragged_extend"] == L
    for key in jc:
        if key == "len":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            _close(tc[key], jc[key])
    for s in (15, 16):
        nxt = tokens[:, s:s + 1] if s < 16 else np.full((3, 1), 7, np.int32)
        wlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl, adapter_ids=ji)
        glog, tc = tm.decode(tp, tc, _t(nxt), lora=tl, adapter_ids=_t(ids))
        _close(glog, wlog)
        _close(tc["k"], jc["k"])
        assert tc["len"].tolist() == [s + 1] * 3
        if s == 15:  # the last target token: forward's logits there
            _close(glog[:, 0], want[:, 15])
    assert calls["paged_attention"] == 2 * L
    assert calls["ragged_extend"] == L  # the decode steps took the pages


@pytest.mark.parametrize("backend", BACKENDS)
def test_step_functions_match_jax(backend):
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    frames, tokens, ids = _inputs(seed=8, B=2, S_src=10, S=12)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
              "adapter_ids": jnp.asarray(ids)}
    tbatch = {"frames": _t(frames), "tokens": _t(tokens), "adapter_ids": _t(ids)}
    wlog, jc = jax_prefill_step(jm)(jp, jl, jbatch)
    glog, tc = make_prefill_step(tm)(tp, tl, tbatch)
    _close(glog, wlog)
    assert tc["k"].shape[2] == 12 and tc["ck"].shape[2] == 10
    # decode into a cache with room: the prefill step's cache is full
    _, jc = jm.prefill(jp, jbatch["frames"], jbatch["tokens"], 16, lora=jl,
                       adapter_ids=jbatch["adapter_ids"])
    _, tc = tm.prefill(tp, tbatch["frames"], tbatch["tokens"], 16, lora=tl,
                       adapter_ids=tbatch["adapter_ids"])
    jtok = jnp.argmax(wlog[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = glog[:, -1].argmax(-1).to(torch.int32)[:, None]
    assert ttok[:, 0].tolist() == np.asarray(jtok)[:, 0].tolist()
    jstep, tstep = jax_decode_step(jm), make_decode_step(tm)
    for _ in range(3):
        jtok, jc = jstep(jp, jl, jc, {"tokens": jtok, "adapter_ids": jbatch["adapter_ids"]})
        ttok, tc = tstep(tp, tl, tc, {"tokens": ttok, "adapter_ids": tbatch["adapter_ids"]})
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jtok, ttok = jtok[:, None], ttok[:, None]
    _close(tc["k"], jc["k"])


def test_engine_refuses_encdec():
    """The engine serves decoder-only layouts, as the reference's does."""
    from repro_torch.serving import EngineConfig, ServingEngine

    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine(configs.reduced(configs.get(ARCH)), EngineConfig(), device="cpu")
