"""RWKV-6, the RG-LRU hybrid and seamless-m4t in bf16 against the
reference's bf16 models.

Reduced rwkv6-1.6b, recurrentgemma-2b (window 16) and
seamless-m4t-large-v2 are built in bf16 (the default of both packages'
``build_model``) on the same weights: the reference's ``init_params`` in
bf16, carried to the port bit for bit by ``bridge.tensor_tree(...,
dtype=None)``, and non-zero LoRA slots from numpy rounded to bf16 on both
sides. The reference runs its Pallas backend in interpret mode, as
``tests/test_torch_bf16_model.py`` builds its pair. Each family runs the
static path: ``prefill``, an ``extend`` (row-masked with ragged rows; for
seamless, whose ``extend`` takes no mask, unmasked), then four ``decode``
steps fed the reference's greedy tokens. Three rules hold at every call:

- Anchored on f32. The reference built in f32 on the same weights, upcast,
  is the anchor. The port's bf16 logits lie within ``F32_MULT`` times the
  reference's bf16 distance from it, plus ``F32_FLOOR`` of its max |logit|.
  The recurrences spread more in bf16 than the dense families do, and
  RWKV's r/k/v/o round once in ``fused_sgmv`` where the reference rounds
  x·W, the LoRA delta and their sum apart, so neither bf16 model is the
  other's yardstick. Measured on the CPU over six weight and input seeds
  (``python tests/test_torch_bf16_families.py``), (port's distance − 0.005)
  / reference's at any call was at most 1.61 (rwkv6), 1.56 (recurrentgemma)
  and 1.08 (seamless).
- Against the reference. The port's bf16 logits lie within
  ``LOGIT_TOL[arch]`` of the reference's max |logit|, and the greedy tokens
  are equal wherever the reference's top-2 gap exceeds twice that. Two bf16
  models that each stray from f32 by their own spread lie up to the sum of
  the two spreads apart: over the same six seeds the largest distance at
  any call was 0.0477 (rwkv6), 0.1111 (recurrentgemma, where the two lay
  0.0647 and 0.0843 from f32) and 0.0179 (seamless). This file runs the
  first seed.
- Leaf for leaf. The cache and state leaves have the reference's dtypes
  and shapes (RWKV's ``wkv`` and the RG-LRU's ``h`` f32, the token-shift
  anchors, the conv window and the KV bf16), and ``len`` is the
  reference's.

Every kernel call of the port's run is also held to what its launch would
be on the card: all float operands bf16 (a mixed launch raises there), and
the loop the path rules give its shape and addresses (``bf16_path``)
``wgmma`` for ``fused_sgmv`` over more than 16 rows and for
``ragged_extend``, ``skinny`` for ``fused_sgmv`` over at most 16, ``split``
for ``paged_attention``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_bf16_families.py
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro_torch import bridge, configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import build_model

sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")
ragged_mod = importlib.import_module("repro_torch.kernels.ragged_extend")
paged_mod = importlib.import_module("repro_torch.kernels.paged_attention")

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "seamless-m4t-large-v2"]
F32_MULT = 2.0
F32_FLOOR = 0.005
LOGIT_TOL = {"rwkv6-1.6b": 0.06, "recurrentgemma-2b": 0.12,
             "seamless-m4t-large-v2": 0.025}
# tokens the top-2 rule must hold of the 2 + 13 + 8 compared positions: at
# recurrentgemma's 0.12 only gaps over 0.24 of the max |logit| count (2 at
# this file's seed; rwkv6 holds 7, seamless 9)
MIN_HELD = 2
B, S, T, CHUNK, STEPS = 2, 12, 32, 9, 4
LENS = np.array([CHUNK, 4], np.int32)  # the masked extend's real tokens a row
S_SRC = 10  # seamless's frames


def _upcast(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                        tree)


def _models(arch, seed=3):
    """The reference in bf16 and in f32 on the same weights upcast, and the
    port in bf16: (model, params, lora) each, from ``seed``."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    jm = jax_build_model(jcfg, dtype=jnp.bfloat16, kernel_backend="pallas")
    jp = jm.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    jl = {t: (jnp.asarray(rng.standard_normal(a.shape, np.float32) * 0.1, jnp.bfloat16),
              jnp.asarray(rng.standard_normal(b.shape, np.float32) * 0.1, jnp.bfloat16))
          for t, (a, b) in jm.init_lora(jax.random.PRNGKey(seed + 2), 3).items()}
    j32 = jax_build_model(jcfg, dtype=jnp.float32, kernel_backend="pallas")
    tm = build_model(configs.reduced(configs.get(arch)), device="cpu")
    assert tm.dtype == torch.bfloat16  # the default, as the reference's
    tp, tl = (bridge.tensor_tree(jax.tree.map(np.asarray, t), "cpu", None) for t in (jp, jl))
    return (jm, jp, jl), (j32, _upcast(jp), _upcast(jl)), (tm, tp, tl)


def _launch_spy(monkeypatch):
    """Wrap the kernel wrappers the models call: each call's float operands
    must share bf16, and its loop on the card (by the path rules, from the
    call's shapes and addresses) is counted."""
    paths = {}

    def ptrs(*ts):
        return tuple(t.data_ptr() for t in ts)

    def loop(name, a):
        if name == "fused_sgmv":
            x, w, la, lb = a[:4]
            Bx, Sx, d_in = x.shape
            return sgmv_mod.bf16_path(Bx * Sx, d_in, w.shape[1], ptrs(x, w, la, lb), x.dtype)
        if name == "ragged_extend":
            q, k, v = a[:3]
            return ragged_mod.bf16_path(*q.shape[:3], k.shape[1], k.shape[2], q.shape[3],
                                        ptrs(q, k, v))
        q, kp, vp = a[:3]
        return paged_mod.bf16_path(q.shape[0], q.shape[1] // kp.shape[2], kp.shape[2],
                                   q.shape[2], ptrs(q, kp, vp))

    for name in ("fused_sgmv", "ragged_extend", "paged_attention"):
        fn = getattr(kernel_ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            floats = {t.dtype for t in a if isinstance(t, torch.Tensor)
                      and t.is_floating_point()}
            assert floats == {torch.bfloat16}, f"{_name} called with {floats}"
            key = (_name, loop(_name, a), int(a[0].shape[0] * a[0].shape[1])
                   if _name == "fused_sgmv" else None)
            paths[key] = paths.get(key, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernel_ops, name, spy)
    return paths


def _check(arch, got, want, want32, rows_cols=None, record=None):
    """One call's port logits ``got`` against the reference's bf16 ``want``
    and f32 ``want32`` (B, P, V) at ``rows_cols`` (all positions if None):
    the rules of the module docstring, or, with ``record`` (a list), only
    the distances appended to it (shares of the max |f32 logit|: the
    reference's bf16 and the port's from f32; the port's from the
    reference's, of its max |logit|). Returns the reference's greedy
    tokens and how many of them the top-2 rule held."""
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    w32 = np.asarray(want32)
    if rows_cols is None:
        rows_cols = [(b, p) for b in range(w.shape[0]) for p in range(w.shape[1])]
    g, w, w32 = (np.stack([a[b, p] for b, p in rows_cols]) for a in (g, w, w32))
    top32, top = float(np.abs(w32).max()), float(np.abs(w).max())
    ref_spread = float(np.abs(w - w32).max())
    port_spread = float(np.abs(g - w32).max())
    err = float(np.abs(g - w).max())
    tol = LOGIT_TOL[arch] * top
    top2 = np.sort(w, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    if record is not None:
        record.append((ref_spread / top32, port_spread / top32, err / top))
        return w.argmax(-1), int(clear.sum())
    assert port_spread <= F32_MULT * ref_spread + F32_FLOOR * top32, (
        f"port bf16 {port_spread:.4g} from f32, reference bf16 {ref_spread:.4g} "
        f"(max |f32 logit| {top32:.4g})")
    assert err <= tol, f"max |logit diff| {err:.4g} > {tol:.4g}"
    np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])
    return w.argmax(-1), int(clear.sum())


def _check_leaves(tc, jc):
    """The port's cache leaf for leaf the reference's: names, dtypes,
    shapes, and ``len`` equal."""
    assert set(tc) == set(jc)
    for key, leaf in jc.items():
        want = np.asarray(leaf)
        got = tc[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), key
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _static_path(arch, seed=3, record=None):
    """The static path of both packages' bf16 models and the reference's
    f32 one from ``seed`` (inputs from ``seed + 4``), each call held by
    :func:`_check` (or its distances appended to ``record``). Returns the
    port's model and how many tokens the top-2 rule held."""
    (jm, jp, jl), (j32, p32, l32), (tm, tp, tl) = _models(arch, seed)
    encdec = jm.cfg.is_encdec
    rng = np.random.default_rng(seed + 4)
    ids = np.array([1, -1], np.int32)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    jkw, j32kw, tkw = (dict(lora=jl, adapter_ids=jids), dict(lora=l32, adapter_ids=jids),
                       dict(lora=tl, adapter_ids=tids))
    if encdec:
        frames = rng.standard_normal((B, S_SRC, jm.cfg.d_model)).astype(np.float32)
        jargs = (jnp.asarray(frames), jnp.asarray(tokens), T)
        jlog, jc = jm.prefill(jp, *jargs, **jkw)
        wlog, wc = j32.prefill(p32, *jargs, **j32kw)
        tlog, tc = tm.prefill(tp, torch.from_numpy(frames), torch.from_numpy(tokens), T, **tkw)
    else:
        jlog, jc = jm.prefill(jp, jnp.asarray(tokens), T, **jkw)
        wlog, wc = j32.prefill(p32, jnp.asarray(tokens), T, **j32kw)
        tlog, tc = tm.prefill(tp, torch.from_numpy(tokens), T, **tkw)
    assert tlog.dtype == torch.bfloat16
    _check_leaves(tc, jc)
    _, held = _check(arch, tlog, jlog, wlog, record=record)

    chunk = rng.integers(0, jm.cfg.vocab_size, size=(B, CHUNK)).astype(np.int32)
    start = np.full((B,), S, np.int32)
    jchunk, jstart = jnp.asarray(chunk), jnp.asarray(start)
    tchunk, tstart = torch.from_numpy(chunk), torch.from_numpy(start)
    if encdec:  # the reference's extend takes no mask: every row real
        jlog, jc = jm.extend(jp, jc, jchunk, jstart, **jkw)
        wlog, wc = j32.extend(p32, wc, jchunk, jstart, **j32kw)
        tlog, tc = tm.extend(tp, tc, tchunk, tstart, **tkw)
        nxt, n = _check(arch, tlog, jlog, wlog, record=record)
    else:
        mask = dict(all_logits=True, true_lens=jnp.asarray(LENS))
        jlog, jc = jm.extend(jp, jc, jchunk, jstart, **jkw, **mask)
        wlog, wc = j32.extend(p32, wc, jchunk, jstart, **j32kw, **mask)
        tlog, tc = tm.extend(tp, tc, tchunk, tstart, **tkw, all_logits=True,
                             true_lens=torch.from_numpy(LENS))
        real = [(b, p) for b in range(B) for p in range(int(LENS[b]))]
        nxt, n = _check(arch, tlog, jlog, wlog, real, record)
        nxt = nxt[np.cumsum(LENS) - 1]  # each row's last real position
    held += n
    _check_leaves(tc, jc)
    tok = nxt.astype(np.int32)[:, None]
    for _ in range(STEPS):  # greedy decode, fed the reference's tokens
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), **jkw)
        wlog, wc = j32.decode(p32, wc, jnp.asarray(tok), **j32kw)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok), **tkw)
        tok, n = _check(arch, tlog, jlog, wlog, record=record)
        tok, held = tok[:, None].astype(np.int32), held + n
        _check_leaves(tc, jc)
    return tm, held


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_family_static_path_matches_reference(arch, monkeypatch):
    paths = _launch_spy(monkeypatch)
    tm, held = _static_path(arch)
    assert held >= MIN_HELD, held
    cfg = tm.cfg
    # each call on the loop its launch takes on the card
    n_lora = len(tm.lora_dims())
    for (name, loop, rows), calls in paths.items():
        want = {"fused_sgmv": "skinny" if rows is not None and rows <= 16 else "wgmma",
                "ragged_extend": "wgmma", "paged_attention": "split"}[name]
        assert loop == want, f"{arch}: {calls} {name} calls on {loop} (rows {rows})"
    sgmv_calls = sum(c for (name, _, _), c in paths.items() if name == "fused_sgmv")
    lora_layers = (tm._layer_types().count("attn") if cfg.rglru is not None
                   else cfg.num_layers)
    assert sgmv_calls == n_lora * lora_layers * (2 + STEPS)
    attn = {name: sum(c for (k, _, _), c in paths.items() if k == name)
            for name in ("ragged_extend", "paged_attention")}
    assert attn == ({"ragged_extend": 2 * cfg.num_layers,
                     "paged_attention": STEPS * cfg.num_layers} if cfg.is_encdec
                    else {"ragged_extend": 0, "paged_attention": 0})


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_family_bf16_tree_bit_for_bit(arch):
    """Each family's bf16 reference tree crosses unchanged, leaf for leaf:
    among them RWKV's bonus ``u`` and decay ``w0``, ``wa``, ``wb``, the
    RG-LRU's ``lam`` and conv, and seamless's encoder and cross weights."""
    jm = jax_build_model(jconfigs.reduced(jconfigs.get(arch)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = bridge.tensor_tree(jax.tree.map(np.asarray, jp), "cpu", None)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    names = set()
    for (path, j), (_, t) in zip(jflat, tflat):
        a = np.asarray(j)
        names.update(k.key for k in path)
        assert a.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16, path
        assert tuple(t.shape) == a.shape
        assert np.array_equal(a.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
    want = {"rwkv6-1.6b": {"u", "w0", "wa", "wb", "ln_x"},
            "recurrentgemma-2b": {"lam", "conv_w", "conv_b"},
            "seamless-m4t-large-v2": {"encoder", "cross", "enc_norm"}}[arch]
    assert want <= names


if __name__ == "__main__":
    # the spreads behind F32_MULT, F32_FLOOR and LOGIT_TOL over six seeds:
    # PYTHONPATH=src python tests/test_torch_bf16_families.py [arch ...]
    import sys

    for arch in sys.argv[1:] or ARCHS:
        for seed in (3, 10, 11, 12, 13, 14):
            rec = []
            _static_path(arch, seed, rec)
            ref, port, diff = (max(r[i] for r in rec) for i in range(3))
            ratio = max((p - F32_FLOOR) / r for r, p, _ in rec)
            print(f"{arch} seed {seed}: reference bf16 to f32 {ref:.4f}, port bf16 to "
                  f"f32 {port:.4f}, port to reference {diff:.4f}, largest (port - "
                  f"{F32_FLOOR}) / reference at a call {ratio:.2f}", flush=True)
