"""The port's fresh-prefill / greedy-decode path against the reference's.

``gqa_full``, ``LM.forward``, ``LM.prefill``, ``LM.decode`` and the step
functions of ``models/model.py`` on the reduced qwen3-0.6b, against the
reference model built with ``kernel_backend="pallas"`` (its Pallas kernels
in interpret mode on the CPU) and with ``"jnp"``. Weights come from the
reference's ``init_params`` through ``repro_torch.bridge``; LoRA slots get
non-zero A and B from numpy (the reference's ``init_lora`` zeroes B, and a
zero B would hide a broken delta); one row runs at adapter id -1.
Tolerance: 1e-4 for logits and caches (two layers of f32 sums in another
order), as ``tests/test_torch_model.py``; greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import make_decode_step as jax_make_decode_step
from repro.models import make_prefill_step as jax_make_prefill_step
from repro.models.attention import gqa_full as jax_gqa_full
from repro_torch import bridge, configs
from repro_torch.models import build_model, make_decode_step, make_prefill_step
from repro_torch.models.attention import gqa_full
from repro_torch.models.common import rope_tables
from repro_torch.models.transformer import layer_views

XTOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["pallas", "jnp"]
IDS = np.array([2, -1, 0], np.int32)  # one base-model row


def _pair(backend, n_slots=3):
    """The reference LM on ``backend`` and the port's, sharing weights and
    non-zero LoRA slots."""
    jcfg = jconfigs.reduced(jconfigs.get("qwen3-0.6b"))
    jm = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend=backend)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), n_slots).items()}
    tm = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu")
    tlora = bridge.tensor_tree(lora, "cpu")
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return (jm, jparams, jl), (tm, tparams, tlora)


def _tokens(B, S, seed=6):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **XTOL)


def _check_cache(tc, jc):
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_gqa_full_matches_jax(backend):
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    B, S = 3, 21
    x = np.random.default_rng(7).standard_normal((B, S, 64), np.float32)
    lp_j = jax.tree.map(lambda a: a[1], jp["layers"]["mixer"])
    lora_j = jax.tree.map(lambda a: a[1], jl)
    pos = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))
    jout, (jk, jv) = jax_gqa_full(lp_j, jnp.asarray(x), pos, jm.cfg, lora=lora_j,
                                  adapter_ids=jnp.asarray(IDS),
                                  lora_scale=jm.lora_scale)
    rope = rope_tables(torch.arange(S), tm.cfg.resolved_head_dim, tm.cfg.rope_theta)
    L = tm.cfg.num_layers
    tout, (tk, tv) = gqa_full(layer_views(tp["layers"]["mixer"], L)[1],
                              torch.from_numpy(x), rope, tm.cfg,
                              lora=layer_views(tl, L)[1],
                              adapter_ids=torch.from_numpy(IDS),
                              lora_scale=tm.lora_scale)
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_matches_jax(backend):
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    tokens = _tokens(3, 19)
    jlog, jaux = jm.forward(jp, jnp.asarray(tokens), lora=jl,
                            adapter_ids=jnp.asarray(IDS))
    tlog, taux = tm.forward(tp, torch.from_numpy(tokens), lora=tl,
                            adapter_ids=torch.from_numpy(IDS))
    assert tlog.shape == (3, 19, 256)
    _close(tlog, jlog)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_match_jax(backend):
    """Last-token logits and the seeded cache, then one decode step through
    the paged path (a page size divides max_len) on the seeded cache."""
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    tokens = _tokens(3, 13)
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), 16, lora=jl,
                          adapter_ids=jnp.asarray(IDS))
    tlog, tc = tm.prefill(tp, torch.from_numpy(tokens), 16, lora=tl,
                          adapter_ids=torch.from_numpy(IDS))
    assert tlog.shape == (3, 1, 256)
    _close(tlog, jlog)
    _check_cache(tc, jc)
    nxt = np.array([[5], [250], [17]], np.int32)
    jlog, jc = jm.decode(jp, jc, jnp.asarray(nxt), lora=jl,
                         adapter_ids=jnp.asarray(IDS))
    tlog, tc = tm.decode(tp, tc, torch.from_numpy(nxt), lora=tl,
                         adapter_ids=torch.from_numpy(IDS))
    _close(tlog, jlog)
    _check_cache(tc, jc)
    assert tc["len"].tolist() == [14, 14, 14]


@pytest.mark.parametrize("backend", BACKENDS)
def test_step_functions_match_jax(backend):
    """make_prefill_step (a cache of exactly S positions) and one
    make_decode_step at len == S, where the write falls off the cache in
    both packages."""
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    tokens = _tokens(3, 12, seed=8)
    jbatch = {"tokens": jnp.asarray(tokens), "adapter_ids": jnp.asarray(IDS)}
    tbatch = {"tokens": torch.from_numpy(tokens), "adapter_ids": torch.from_numpy(IDS)}
    jlog, jc = jax_make_prefill_step(jm)(jp, jl, jbatch)
    tlog, tc = make_prefill_step(tm)(tp, tl, tbatch)
    _close(tlog, jlog)
    _check_cache(tc, jc)
    assert tc["k"].shape[2] == 12
    nxt = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    jtok, jc = jax_make_decode_step(jm)(jp, jl, jc, {"tokens": jnp.asarray(nxt),
                                                     "adapter_ids": jnp.asarray(IDS)})
    ttok, tc = make_decode_step(tm)(tp, tl, tc, {"tokens": torch.from_numpy(nxt),
                                                 "adapter_ids": torch.from_numpy(IDS)})
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _check_cache(tc, jc)


@pytest.mark.parametrize("backend", BACKENDS)
def test_greedy_decode_tokens_identical(backend):
    """Prefill, then 4 greedy decode steps: every token equal."""
    (jm, jp, jl), (tm, tp, tl) = _pair(backend)
    tokens = _tokens(3, 11, seed=9)
    steps = 4
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), 11 + steps, lora=jl,
                          adapter_ids=jnp.asarray(IDS))
    tlog, tc = tm.prefill(tp, torch.from_numpy(tokens), 11 + steps, lora=tl,
                          adapter_ids=torch.from_numpy(IDS))
    jtok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)
    ttok = torch.argmax(tlog[:, -1], -1).to(torch.int32)
    jdec, tdec = jax_make_decode_step(jm), make_decode_step(tm)
    jall, tall = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(steps):
        jtok, jc = jdec(jp, jl, jc, {"tokens": jtok[:, None],
                                     "adapter_ids": jnp.asarray(IDS)})
        ttok, tc = tdec(tp, tl, tc, {"tokens": ttok[:, None],
                                     "adapter_ids": torch.from_numpy(IDS)})
        jall.append(np.asarray(jtok))
        tall.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tall), np.stack(jall))
    assert tc["len"].tolist() == [11 + steps] * 3
    _check_cache(tc, jc)


def test_prefill_and_decode_agree_with_forward():
    """The arch-smoke identities on the port alone: prefill of
    tokens[:, :S-1] gives forward's logits at S-2, and decoding token S-1
    then gives forward's logits at S-1."""
    _, (tm, tp, tl) = _pair("jnp")
    S = 17
    tokens = torch.from_numpy(_tokens(3, S, seed=10))
    ids = torch.from_numpy(IDS)
    full, _ = tm.forward(tp, tokens, lora=tl, adapter_ids=ids)
    last, cache = tm.prefill(tp, tokens[:, :S - 1], S, lora=tl, adapter_ids=ids)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, S - 2].numpy(), **XTOL)
    dec, cache = tm.decode(tp, cache, tokens[:, S - 1:], lora=tl, adapter_ids=ids)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, S - 1].numpy(), **XTOL)


def test_forward_keeps_autograd_on_cpu():
    """On the CPU the plain kernel versions differentiate: a loss on the
    forward logits reaches the LoRA B of every attention projection."""
    _, (tm, tp, tl) = _pair("jnp")
    lora = {t: (a, b.clone().requires_grad_()) for t, (a, b) in tl.items()}
    logits, _ = tm.forward(tp, torch.from_numpy(_tokens(3, 9)), lora=lora,
                           adapter_ids=torch.from_numpy(IDS))
    logits.square().mean().backward()
    for t, (_, b) in lora.items():
        assert b.grad is not None and float(b.grad.abs().sum()) > 0, t
        assert float(b.grad[:, 1].abs().max()) == 0.0  # slot 1 is unused


def test_prefill_longer_than_the_cache_raises():
    tm = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cache of 4"):
        tm.prefill(params, torch.zeros((1, 5), dtype=torch.int64), 4)
