"""The port's models in bf16 against the reference's bf16 models.

Both packages build the model in bf16 (the reference's default dtype) on
the same weights: the reference's ``init_params`` in bf16, carried to the
port bit for bit by ``bridge.tensor_tree(..., dtype=None)``, and non-zero
LoRA slots from numpy rounded to bf16 on both sides. Each model runs the
static path: ``prefill``, a row-masked ``extend`` (ragged rows), then four
``decode`` steps fed the reference's greedy tokens. The reference runs its
Pallas backend (interpret mode), as the port runs its kernels: each
projection rounds once, after the f32 sum of x·W and the LoRA delta, and
attention scores stay f32 (its jnp backend rounds both to bf16, which
alone moves logits by ~3 % of their scale).

bf16 rounds at other places in XLA and PyTorch (every matmul output, every
elementwise op in another order), so the logits are held within ``LOGIT_TOL``
of the reference's largest |logit| at that step, and the greedy tokens are
equal wherever the reference's top-2 gap exceeds twice that tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro_torch import bridge, configs
from repro_torch.models import build_model

# share of the reference's max |logit| that the port's bf16 logits may miss
# it by: a few bf16 ulps (2^-8 = 0.0039 relative) of the logits' scale, over
# two to four layers of bf16 activations rounded in other places (measured:
# 0.007-0.010 on qwen3-0.6b, on the CPU)
LOGIT_TOL = 0.03
ARCHS = ["qwen3-0.6b", "llama-7b", "deepseek-v2-lite-16b"]
BACKEND = "pallas"

def _pair(arch, kv_quant=False, n_slots=3):
    """The reference's bf16 LM and the port's, on the same bf16 weights."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tcfg = configs.reduced(configs.get(arch))
    jm = jax_build_model(jcfg, dtype=jnp.bfloat16, kernel_backend=BACKEND,
                         kv_quant=kv_quant)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    if jcfg.moe is not None:  # distinct experts: the reference's init repeats one
        ffn = dict(jparams["layers"]["ffn"])
        for key in ("w_gate", "w_up", "w_down"):
            leaf = ffn[key]
            ffn[key] = (leaf.astype(jnp.float32) + rng.standard_normal(
                leaf.shape, np.float32) * 0.05).astype(jnp.bfloat16)
        jparams["layers"] = dict(jparams["layers"], ffn=ffn)
    jl = {t: (jnp.asarray(rng.standard_normal(a.shape, np.float32) * 0.1, jnp.bfloat16),
              jnp.asarray(rng.standard_normal(b.shape, np.float32) * 0.1, jnp.bfloat16))
          for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), n_slots).items()}
    tm = build_model(dataclasses.replace(tcfg), device="cpu", kv_quant=kv_quant)
    assert tm.dtype == torch.bfloat16  # the default, as the reference's
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu", None)
    tlora = bridge.tensor_tree(jax.tree.map(np.asarray, jl), "cpu", None)
    return (jm, jparams, jl), (tm, tparams, tlora)


def _check(got, want, rows_cols=None):
    """Port logits ``got`` against the reference's ``want`` (B, P, V) at the
    positions ``rows_cols`` (a list of (b, p)), all if None: the tolerance
    rule and the top-2-gap rule of the module docstring. Returns the
    reference's greedy tokens and how many of them the rule held."""
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if rows_cols is None:
        rows_cols = [(b, p) for b in range(w.shape[0]) for p in range(w.shape[1])]
    g = np.stack([g[b, p] for b, p in rows_cols])
    w = np.stack([w[b, p] for b, p in rows_cols])
    tol = LOGIT_TOL * float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert err <= tol, f"max |logit diff| {err:.4g} > {tol:.4g}"
    top2 = np.sort(w, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])
    return w.argmax(-1), int(clear.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_static_path_matches_reference(arch):
    (jm, jp, jl), (tm, tp, tl) = _pair(arch)
    rng = np.random.default_rng(7)
    B, S, T = 2, 12, 32
    ids = np.array([1, -1], np.int32)
    tids = torch.from_numpy(ids)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), T, lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.prefill(tp, torch.from_numpy(tokens), T, lora=tl, adapter_ids=tids)
    assert tlog.dtype == torch.bfloat16 and tc["k" if "k" in tc else "latent"].dtype == torch.bfloat16
    _, held = _check(tlog, jlog)
    # a row-masked chunk: row 0 takes 6 tokens, row 1 three (pads after)
    chunk = rng.integers(0, jm.cfg.vocab_size, size=(B, 6)).astype(np.int32)
    lens = np.array([6, 3], np.int32)
    start = np.full((B,), S, np.int32)
    jlog, jc = jm.extend(jp, jc, jnp.asarray(chunk), jnp.asarray(start), lora=jl,
                         adapter_ids=jnp.asarray(ids), all_logits=True,
                         true_lens=jnp.asarray(lens))
    tlog, tc = tm.extend(tp, tc, torch.from_numpy(chunk), torch.from_numpy(start), lora=tl,
                         adapter_ids=tids, all_logits=True, true_lens=torch.from_numpy(lens))
    real = [(b, p) for b in range(B) for p in range(int(lens[b]))]
    nxt, n = _check(tlog, jlog, real)
    held += n
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    tok = np.array([nxt[int(lens[0]) - 1], nxt[-1]], np.int32)[:, None]
    for _ in range(4):  # greedy decode, fed the reference's tokens
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), lora=jl, adapter_ids=jnp.asarray(ids))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok), lora=tl, adapter_ids=tids)
        tok, n = _check(tlog, jlog)
        tok, held = tok[:, None].astype(np.int32), held + n
    assert held >= 4  # the top-2 rule held some tokens


def test_bf16_int8_kv_matches_reference_and_halves_the_cache():
    """The int8 KV cache under a bf16 model: int8 payload with f32 scales,
    under 0.7 of the bf16 cache's bytes (``tests/test_kv_quant.py``), and
    prefill + decode logits against the reference's int8 bf16 model."""
    cfg = configs.reduced(configs.get("qwen3-0.6b"))
    fp = build_model(cfg, device="cpu")
    q8 = build_model(cfg, device="cpu", kv_quant=True)
    cf, cq = fp.init_cache(4, 64), q8.init_cache(4, 64)
    assert cf["k"].dtype == torch.bfloat16 and cq["k"].dtype == torch.int8
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c.values())  # noqa: E731
    assert nbytes(cq) < nbytes(cf) * 0.7

    (jm, jp, jl), (tm, tp, tl) = _pair("qwen3-0.6b", kv_quant=True)
    rng = np.random.default_rng(8)
    ids = np.array([0, 2], np.int32)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 10)).astype(np.int32)
    jlog, jc = jm.prefill(jp, jnp.asarray(tokens), 24, lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tc = tm.prefill(tp, torch.from_numpy(tokens), 24, lora=tl,
                          adapter_ids=torch.from_numpy(ids))
    assert tc["k"].dtype == torch.int8
    tok = _check(tlog, jlog)[0][:, None].astype(np.int32)
    for _ in range(2):
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), lora=jl, adapter_ids=jnp.asarray(ids))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok), lora=tl,
                             adapter_ids=torch.from_numpy(ids))
        tok = _check(tlog, jlog)[0][:, None].astype(np.int32)


def test_bridge_carries_bf16_bit_for_bit():
    """A reference bf16 parameter tree crosses unchanged: every leaf keeps
    its dtype (bf16 weights, f32 router, int leaves) and its bits."""
    jm = jax_build_model(jconfigs.reduced(jconfigs.get("deepseek-v2-lite-16b")))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = dict(jp, ints=jnp.arange(5, dtype=jnp.int32))
    tp = bridge.tensor_tree(jax.tree.map(np.asarray, tree), "cpu", None)
    jleaves = jax.tree.leaves(tree)
    tleaves = jax.tree.leaves(tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jleaves) == len(tleaves)
    kinds = set()
    for j, t in zip(jleaves, tleaves):
        a = np.asarray(j)
        kinds.add(str(a.dtype))
        if a.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(a.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert t.dtype == getattr(torch, str(a.dtype))
            assert np.array_equal(a, t.numpy())
    assert {"bfloat16", "float32", "int32"} <= kinds
