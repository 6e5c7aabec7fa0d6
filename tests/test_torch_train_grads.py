"""The plain backward versions of the training kernels, and the autograd
Functions that carry them, against autograd and against the reference.

``ref.flash_prefill_bwd_ref`` and ``ref.fused_sgmv_bwd_ref`` (the card's
kernels are held against them) are written out as formulas, not as
autograd of the forward; here they meet ``torch.autograd.grad`` of the
plain forwards in float64 (1e-10), and ``jax.grad`` of the reference's
``sdpa`` (causal) and of its base product plus ``lora_delta`` from the same
numpy inputs in float32 (1e-5 of the largest gradient). On the CPU the
wrappers' autograd Functions take these plain versions, so the same
Functions, reached through ``gqa_full`` and ``_proj``, are held against
``jax.grad`` of the reference's own layers.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro_torch import bridge, configs
from repro_torch.kernels import flash_prefill, flash_prefill_fwd, fused_sgmv, ref
from repro_torch.models import attention

F64_TOL = 1e-10
F32_TOL = 1e-5  # times the largest gradient magnitude


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


ATTN_CASES = [  # (B, H, Hkv, S, D): G = 1, 3, 4; D = 20 and 64
    (2, 4, 4, 9, 20),
    (2, 6, 2, 13, 20),
    (1, 8, 2, 11, 64),
]
SGMV_IDS = [[1, -1, 1], [-1, -1, 0], [0, 2, 1]]  # a base row, repeated ids


def _attn_inputs(B, H, Hkv, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, S, D))]


@pytest.mark.parametrize("B,H,Hkv,S,D", ATTN_CASES)
def test_flash_prefill_bwd_ref_matches_autograd_f64(B, H, Hkv, S, D):
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(B, H, Hkv, S, D, np.float64))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ref.flash_prefill_ref(*leaves)
    want = torch.autograd.grad(o, leaves, do)
    lse = ref.flash_prefill_lse_ref(q, k)
    got = ref.flash_prefill_bwd_ref(q, k, v, o.detach(), lse, do)
    for g, w in zip(got, want):
        _close(g, w, F64_TOL)


@pytest.mark.parametrize("ids", SGMV_IDS)
def test_fused_sgmv_bwd_ref_matches_autograd_f64(ids):
    rng = np.random.default_rng(1)
    x, w, a, b, dy = (torch.from_numpy(rng.standard_normal(s))
                      for s in ((3, 5, 12), (12, 10), (3, 12, 4), (3, 4, 10), (3, 5, 10)))
    ids = torch.tensor(ids)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, a, b)]
    y = ref.fused_sgmv_ref(*leaves, ids, 0.7)
    want = torch.autograd.grad(y, leaves, dy)
    got = ref.fused_sgmv_bwd_ref(x, w, a, b, ids, 0.7, dy)
    for g, wt in zip(got, want):
        _close(g, wt, F64_TOL)
    dx, dw, _, _ = ref.fused_sgmv_bwd_ref(x, w, a, b, ids, 0.7, dy, need_dw=False)
    assert dw is None and torch.equal(dx, got[0])
    for n in range(3):  # an adapter with no live row gets no gradient
        if n not in ids.tolist():
            assert not got[2][n].any() and not got[3][n].any()


def _jax_causal_sdpa(q, k, v):
    """The reference's attention on head-major inputs: its ``sdpa`` under
    the causal mask of positions 0 .. S-1."""
    S = q.shape[2]
    pos = jnp.arange(S)[None, :]
    mask = jcommon.causal_mask(pos, pos)
    out = jattention.sdpa(*(t.transpose(0, 2, 1, 3) for t in (q, k, v)), mask)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,H,Hkv,S,D", ATTN_CASES)
def test_flash_prefill_backward_matches_jax_grad(B, H, Hkv, S, D):
    """The wrapper's Function (the plain backward on the CPU) against
    ``jax.grad`` of the reference's causal ``sdpa``; the inputs are
    (B, S, H, D) tensors transposed to head-major views, as ``gqa_full``
    hands them over."""
    q, k, v, do = _attn_inputs(B, H, Hkv, S, D, np.float32, seed=2)
    _, vjp = jax.vjp(_jax_causal_sdpa, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    views = [torch.from_numpy(np.ascontiguousarray(t.transpose(0, 2, 1, 3)))
             .transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    out = flash_prefill(*views)
    got = torch.autograd.grad(out, views, torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)
    _, lse = flash_prefill_fwd(*(t.detach() for t in views))
    direct = ref.flash_prefill_bwd_ref(*(t.detach() for t in views), out.detach(), lse,
                                       torch.from_numpy(do))
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


@pytest.mark.parametrize("ids", SGMV_IDS)
def test_fused_sgmv_backward_matches_jax_grad(ids):
    rng = np.random.default_rng(3)
    x, w, a, b, dy = (rng.standard_normal(s).astype(np.float32)
                      for s in ((3, 5, 24), (24, 16), (3, 24, 4), (3, 4, 16), (3, 5, 16)))
    ids = np.asarray(ids, np.int32)

    def jfun(x, w, a, b):
        return x @ w + jcommon.lora_delta(x, a, b, jnp.asarray(ids), 0.5)

    _, vjp = jax.vjp(jfun, *map(jnp.asarray, (x, w, a, b)))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, w, a, b)]
    y = fused_sgmv(*leaves, torch.from_numpy(ids), scale=0.5)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for g, wt in zip(got, want):
        _close(g, wt, F32_TOL)


def test_fused_sgmv_skips_the_gradients_nobody_needs(monkeypatch):
    """A frozen W forms no dW (``needs_input_grad``); an x that needs no
    gradient gets none."""
    sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")
    calls = []
    monkeypatch.setattr(sgmv_mod, "fused_sgmv_bwd_ref",
                        lambda *a: calls.append(a[-1]) or ref.fused_sgmv_bwd_ref(*a))
    x, w = torch.randn((2, 3, 8)), torch.randn((8, 6))
    a = torch.randn((2, 8, 4), requires_grad=True)
    b = torch.randn((2, 4, 6), requires_grad=True)
    y = fused_sgmv(x, w, a, b, torch.tensor([0, 1]))
    y.sum().backward()
    assert calls == [False] and x.grad is None and w.grad is None
    assert a.grad is not None and b.grad is not None


def _gqa_pair(S=10, seed=4):
    """The reference's GQA layer params (reduced qwen3-0.6b) with LoRA
    slots, bridged to the port, and an input."""
    jcfg = jconfigs.reduced(jconfigs.get("qwen3-0.6b"))
    cfg = configs.reduced(configs.get("qwen3-0.6b"))
    jm = jtransformer.LM(jcfg, jnp.float32)
    lp = jax.tree.map(lambda t: np.asarray(t[0]), jm.init_params(jax.random.PRNGKey(0))
                      ["layers"]["mixer"])
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d)}
    lora = {t: (rng.standard_normal((3, i, 4)).astype(np.float32) * 0.2,
                rng.standard_normal((3, 4, o)).astype(np.float32) * 0.2)
            for t, (i, o) in dims.items()}
    x = rng.standard_normal((3, S, d)).astype(np.float32)
    dy = rng.standard_normal((3, S, d)).astype(np.float32)
    ids = np.array([2, -1, 0], np.int32)
    return jcfg, cfg, lp, lora, x, dy, ids


def test_gqa_full_gradients_match_the_reference():
    """Every gradient of one attention layer — x, the weights and the LoRA
    slots — through ``gqa_full`` (``fused_sgmv`` and ``flash_prefill``'s
    Functions) against ``jax.grad`` of the reference's ``gqa_full``."""
    jcfg, cfg, lp, lora, x, dy, ids = _gqa_pair()
    S = x.shape[1]

    def jfun(x, lp, lora):
        pos = jnp.broadcast_to(jnp.arange(S)[None, :], x.shape[:2])
        return jattention.gqa_full(lp, x, pos, jcfg, lora=lora,
                                   adapter_ids=jnp.asarray(ids), lora_scale=0.5)[0]

    _, vjp = jax.vjp(jfun, jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                     jax.tree.map(jnp.asarray, lora))
    jx, jlp, jlora = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tlp = {k: t.requires_grad_(True) for k, t in bridge.tensor_tree(lp, "cpu").items()}
    tlora = {k: tuple(t.requires_grad_(True) for t in ab)
             for k, ab in bridge.tensor_tree(lora, "cpu").items()}
    rope = attention.step_rope(cfg, torch.arange(S))
    out = attention.gqa_full(tlp, tx, rope, cfg, lora=tlora,
                             adapter_ids=torch.from_numpy(ids), lora_scale=0.5)[0]
    names = sorted(tlp)
    leaves = [tx] + [tlp[k] for k in names] + [t for k in sorted(tlora) for t in tlora[k]]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    want = ([jx] + [jlp[k] for k in names]
            + [t for k in sorted(jlora) for t in jlora[k]])
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


def test_proj_gradient_without_lora_is_a_plain_product():
    """A projection without an adapter is ``x @ w`` and keeps its
    gradient; with one it goes through ``fused_sgmv``'s Function."""
    x = torch.randn((2, 3, 8), requires_grad=True)
    w = torch.randn((8, 6), requires_grad=True)
    (gx, gw) = torch.autograd.grad(attention._proj(x, w, None, "q", None, 1.0).sum(),
                                   (x, w))
    _close(gx, torch.ones((2, 3, 6)) @ w.T, 1e-6)
    _close(gw, x.reshape(6, 8).T @ torch.ones((6, 6)), 1e-6)
    a, b = torch.randn((1, 8, 2)), torch.zeros((1, 2, 6), requires_grad=True)
    y = attention._proj(x, w, {"q": (a, b)}, "q", torch.tensor([0, -1]), 1.0)
    assert y.grad_fn is not None and "FusedSgmv" in type(y.grad_fn).__name__
