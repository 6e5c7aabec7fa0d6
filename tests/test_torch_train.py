"""The port's training path against the reference's, on the CPU.

The same numpy inputs go through ``repro``'s functions and the port's:
``cross_entropy``, the optimizer (``adamw_update`` with a mask,
``clip_by_global_norm``, ``cosine_schedule``, ``lora_only_mask``; within
1e-6), ``sdpa_blockwise`` with a window and a softcap (1e-5), remat's
gradients against none, and one ``make_train_step`` of reduced qwen3-0.6b
against the reference's jnp-backend step from bridged weights, full-parameter
and LoRA-only: the loss and ``grad_norm`` within 1e-5 relative, every
gradient (``jax.grad``) and moment, and every updated leaf, within 1e-4 of
the leaf's largest magnitude (see ``check_step`` for the elements whose
gradient is below AdamW's eps). LoRA slots get a non-zero B from numpy (``init_lora`` zeroes B,
which would hide a broken dA).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import make_train_state as jmake_train_state
from repro.models import make_train_step as jmake_train_step
from repro.models.model import cross_entropy as jcross_entropy
from repro_torch import bridge, configs, optim
from repro_torch.models import (TrainState, attention, build_model, cross_entropy,
                                make_train_state, make_train_step)
from repro_torch.tree import flatten_with_names, unflatten

OPT_TOL = 1e-6
LEAF_TOL = 1e-4  # times the leaf's largest magnitude


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in flatten_with_names(tree)}


def _leaves_close(got, want, tol=LEAF_TOL):
    got, want = _named(got), _named(want)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert np.abs(got[k] - want[k]).max() <= tol * scale, k


def test_cross_entropy_matches_the_reference_with_ignore():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    none = -np.ones((3, 7), np.int32)  # nothing valid: 0, not NaN
    assert float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


def _opt_trees(seed=1):
    rng = np.random.default_rng(seed)

    def leaf(*s):
        return rng.standard_normal(s).astype(np.float32)

    params = {"params": {"w": leaf(4, 6), "b": leaf(6)},
              "lora": {"q": (leaf(2, 4, 3), leaf(2, 3, 6))}}
    grads = jax.tree.map(lambda p: leaf(*p.shape) * 3, params)
    return params, grads


def test_optimizer_matches_the_reference():
    params, grads = _opt_trees()
    mask = joptim.lora_only_mask(params)
    assert optim.lora_only_mask(params) == mask
    jclip, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tgrads = bridge.tensor_tree(grads, "cpu")
    tclip, tnorm = optim.clip_by_global_norm(tgrads, 1.0)
    assert abs(float(tnorm) - float(jnorm)) <= OPT_TOL * float(jnorm)
    assert abs(float(optim.global_norm(tgrads)) - float(joptim.global_norm(grads))) \
        <= OPT_TOL * float(jnorm)
    _leaves_close(tclip, _np_tree(jclip), OPT_TOL)
    jp, js = jax.tree.map(jnp.asarray, params), joptim.adamw_init(params)
    tp, ts = bridge.tensor_tree(params, "cpu"), optim.adamw_init(bridge.tensor_tree(params, "cpu"))
    for step in range(3):  # the bias corrections change with the step
        g = jax.tree.map(lambda t: t * (step + 1), jclip)
        jp, js = joptim.adamw_update(g, js, jp, 1e-2, weight_decay=0.1, mask=mask)
        tp, ts = optim.adamw_update(bridge.tensor_tree(_np_tree(g), "cpu"), ts, tp, 1e-2,
                                    weight_decay=0.1, mask=mask)
        _leaves_close(tp, _np_tree(jp), OPT_TOL)
        _leaves_close({"m": ts.m, "v": ts.v}, _np_tree({"m": js.m, "v": js.v}), OPT_TOL)
        assert int(ts.step) == int(js.step) == step + 1
    _leaves_close(tp["params"], params["params"], 0.0)  # masked: untouched
    updates = jax.tree.map(lambda p: p * 0.5, params)
    _leaves_close(optim.apply_updates(bridge.tensor_tree(params, "cpu"),
                                      bridge.tensor_tree(updates, "cpu")),
                  _np_tree(joptim.apply_updates(params, updates)), OPT_TOL)


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 140])
def test_cosine_schedule_matches_the_reference(step):
    want = float(joptim.cosine_schedule(3e-4, 10, 100)(step))
    got = optim.cosine_schedule(3e-4, 10, 100)(step)
    assert abs(got - want) <= OPT_TOL * 3e-4


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 20.0), (6, 30.0)])
def test_sdpa_blockwise_matches_the_reference(window, softcap):
    """Forward and gradients of ``sdpa_blockwise`` (chunks that do not
    divide S, a window, a softcap) against the reference's."""
    rng = np.random.default_rng(2)
    B, S, H, Hkv, D = 2, 13, 4, 2, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))

    def jfun(q, k, v):
        return jattention.sdpa_blockwise(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                         window=window, softcap=softcap, q_chunk=4,
                                         k_chunk=4)

    want, vjp = jax.vjp(jfun, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    tpos = torch.from_numpy(pos.copy()).long()
    got = attention.sdpa_blockwise(tq, tk, tv, tpos, tpos, window=window, softcap=softcap,
                                   q_chunk=4, k_chunk=4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _lora_numpy(model, n_slots=3, seed=3):
    """LoRA slots with a non-zero B: {target: (A, B)}."""
    rng = np.random.default_rng(seed)
    L, r = model.cfg.num_layers, model.cfg.lora.rank
    return {t: (rng.standard_normal((L, n_slots, i, r)).astype(np.float32) * 0.3,
                rng.standard_normal((L, n_slots, r, o)).astype(np.float32) * 0.05)
            for t, (i, o) in model.lora_dims().items()}


def _batch(cfg, B=3, S=12, seed=4, frames=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "adapter_ids": np.array([1, -1, 1, 0][:B], np.int32)}
    batch["labels"][0, :3] = -1
    if frames:
        batch["frames"] = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)
    return batch


def train_pair(arch, train_lora_only=False, lr=3e-4, remat=False, frames=False):
    """One train step of the reference (jnp backend) and of the port from
    the same weights and batch: (reference state, metrics), (port state,
    metrics), and the port's model, its initial state and batch."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    jm = jbuild_model(jcfg, dtype=jnp.float32)
    jstate = jmake_train_state(jm, jax.random.PRNGKey(0), n_lora_slots=3,
                               train_lora_only=train_lora_only)
    model = build_model(configs.reduced(configs.get(arch)), dtype=torch.float32, device="cpu", remat=remat)
    lora = _lora_numpy(model)
    trainable = {"lora": lora} if train_lora_only else {"params": jstate.params, "lora": lora}
    jstate = dataclasses.replace(jstate, lora=jax.tree.map(jnp.asarray, lora),
                                 opt=joptim.adamw_init(trainable))
    batch = _batch(jcfg, frames=frames)
    jnew, jmet = jmake_train_step(jm, lr=lr, train_lora_only=train_lora_only)(
        jstate, jax.tree.map(jnp.asarray, batch))
    params = bridge.tensor_tree(_np_tree(jstate.params), "cpu")
    tlora = bridge.tensor_tree(lora, "cpu")
    state = TrainState(params=params, lora=tlora,
                       opt=optim.adamw_init({"lora": tlora} if train_lora_only
                                            else {"params": params, "lora": tlora}),
                       step=torch.zeros((), dtype=torch.int32))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    new, met = make_train_step(model, lr=lr, train_lora_only=train_lora_only)(state, tbatch)
    return (jnew, jmet), (new, met), (model, state, tbatch)


def check_step(ref_out, port_out, eps=1e-8):
    """The loss and grad_norm within 1e-5 relative; the moments (m is
    (1 − b1)·g, v (1 − b2)·g²: the clipped gradients) and the updated
    leaves within 1e-4 of the leaf's largest magnitude. AdamW's first step
    moves an element by lr·g/(|g| + eps): where |g| is below 100·eps that
    quotient amplifies the last bits of g (summed in another order), so
    those elements' updates are held through their moments alone."""
    (jnew, jmet), (new, met) = ref_out, port_out
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(float(jmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) \
        <= 1e-5 * float(jmet["grad_norm"])
    _leaves_close({"m": new.opt.m, "v": new.opt.v},
                  _np_tree({"m": jnew.opt.m, "v": jnew.opt.v}))
    got = _named({"params": new.params, "lora": new.lora})
    want = _named(_np_tree({"params": jnew.params, "lora": jnew.lora}))
    m = _named(_np_tree(jnew.opt.m))
    assert got.keys() == want.keys()
    for k in want:
        m_k = m.get(k)  # None: a frozen leaf, which must come back unchanged
        keep = True if m_k is None else np.abs(m_k) >= 0.1 * 100 * eps  # |g| >= 100·eps
        err = np.where(keep, np.abs(got[k] - want[k]), 0.0).max()
        assert err <= LEAF_TOL * max(np.abs(want[k]).max(), 1e-30), k
    assert int(new.step) == int(jnew.step) == 1


@pytest.mark.parametrize("lora_only", [False, True], ids=["full", "lora_only"])
def test_train_step_matches_the_reference(lora_only):
    """reduced qwen3-0.6b: one step, full-parameter and LoRA-only; under
    LoRA-only the base weights come back as the same tensors."""
    ref_out, port_out, (_, state, _) = train_pair("qwen3-0.6b", train_lora_only=lora_only)
    check_step(ref_out, port_out)
    if lora_only:
        new = port_out[0]
        assert all(a is b for (_, a), (_, b) in zip(flatten_with_names(new.params),
                                                   flatten_with_names(state.params)))


def test_train_step_gradients_match_jax_grad():
    """The gradients themselves (before clipping) of the port's loss against
    ``jax.grad`` of the reference's, reduced qwen3-0.6b, every leaf."""
    jcfg = jconfigs.reduced(jconfigs.get("qwen3-0.6b"))
    jm = jbuild_model(jcfg, dtype=jnp.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    model = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    lora = _lora_numpy(model)
    batch = _batch(jcfg)

    def jloss(tr):
        logits, _ = jm.forward(tr["params"], jnp.asarray(batch["tokens"]), lora=tr["lora"],
                               adapter_ids=jnp.asarray(batch["adapter_ids"]))
        return jcross_entropy(logits, jnp.asarray(batch["labels"]))

    jgrads = jax.grad(jloss)({"params": jparams, "lora": jax.tree.map(jnp.asarray, lora)})
    tree = bridge.tensor_tree({"params": _np_tree(jparams), "lora": lora}, "cpu")
    names = [n for n, _ in flatten_with_names(tree)]
    live = [t.requires_grad_(True) for _, t in flatten_with_names(tree)]
    logits, _ = model.forward(tree["params"], torch.from_numpy(batch["tokens"]),
                              lora=tree["lora"],
                              adapter_ids=torch.from_numpy(batch["adapter_ids"]))
    grads = torch.autograd.grad(cross_entropy(logits, torch.from_numpy(batch["labels"])),
                                live)
    _leaves_close(dict(zip(names, grads)), dict(_named(jgrads)))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """remat (per-layer recomputation, "full" or "dots") changes what is
    kept, not what is computed: the gradients equal those without it."""
    cfg = configs.reduced(configs.get("qwen3-0.6b"))
    plain = build_model(cfg, dtype=torch.float32, device="cpu")
    remat = build_model(cfg, dtype=torch.float32, device="cpu", remat=True, remat_policy=policy)
    gen = torch.Generator().manual_seed(0)
    params, lora = plain.init_params(gen), plain.init_lora(gen, 3)
    lora = {t: (a, torch.randn_like(b) * 0.05) for t, (a, b) in lora.items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tree = {"params": params, "lora": lora}
    out = []
    for model in (plain, remat):
        live = [t.detach().clone().requires_grad_(True) for _, t in flatten_with_names(tree)]
        tr = unflatten(tree, live)
        logits, _ = model.forward(tr["params"], batch["tokens"], lora=tr["lora"],
                                  adapter_ids=batch["adapter_ids"])
        out.append(torch.autograd.grad(cross_entropy(logits, batch["labels"]), live))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_make_train_state_lora_only_moments_cover_the_adapters():
    model = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    st = make_train_state(model, torch.Generator().manual_seed(0), n_lora_slots=2,
                          train_lora_only=True)
    assert set(st.opt.m) == {"lora"} and int(st.step) == 0
    full = make_train_state(model, torch.Generator().manual_seed(0), n_lora_slots=0)
    assert full.lora is None and set(full.opt.m) == {"params", "lora"}
