"""The port's model against the reference's, on the reduced qwen3-0.6b.

Weights come from the reference's ``init_params`` and go to the port through
``repro_torch.bridge``; LoRA slots get non-zero A and B from numpy (the
reference's ``init_lora`` zeroes B, and a zero B would hide a broken delta).
Tolerances: 1e-5 for the building blocks, 1e-4 for ``extend`` logits and
caches (two layers of f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import common as jcommon
from repro_torch import bridge
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.models import common

TOL = dict(rtol=1e-5, atol=1e-5)
XTOL = dict(rtol=1e-4, atol=1e-4)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3
    s = rng.standard_normal((64,), np.float32) * 0.1
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16), np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [90, 91, 92, 93, 94, 95, 96]], np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lora_delta_matches_jax_and_negative_id_is_zero():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 32), np.float32)
    a = rng.standard_normal((2, 32, 4), np.float32)
    b = rng.standard_normal((2, 4, 24), np.float32)
    ids = np.array([1, -1, 0], np.int32)
    want = jcommon.lora_delta(*map(jnp.asarray, (x, a, b, ids)), 0.5)
    got = common.lora_delta(*map(torch.from_numpy, (x, a, b, ids)), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.all(got[1] == 0)


def test_sdpa_and_causal_mask_match_jax():
    from repro.models.attention import sdpa as jax_sdpa
    from repro_torch.models.attention import sdpa

    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4, 16), np.float32)
    k = rng.standard_normal((2, 9, 2, 16), np.float32)
    v = rng.standard_normal((2, 9, 2, 16), np.float32)
    qpos = np.array([[4, 5, 6, 7, 8], [0, 1, 2, 3, 4]], np.int32)
    kpos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    valid = kpos < np.array([[9], [5]])
    jmask = jcommon.causal_mask(jnp.asarray(qpos), jnp.asarray(kpos), jnp.asarray(valid))
    tmask = common.causal_mask(*map(torch.from_numpy, (qpos, kpos, valid)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = jax_sdpa(*map(jnp.asarray, (q, k, v)), jmask)
    got = sdpa(*map(torch.from_numpy, (q, k, v)), tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pair(T, n_slots=3):
    """The reference LM and the port's, sharing weights and LoRA slots."""
    jcfg = jconfigs.reduced(jconfigs.get("qwen3-0.6b"))
    jm = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lora = {t: (rng.standard_normal(a.shape, np.float32) * 0.1,
                rng.standard_normal(b.shape, np.float32) * 0.1)
            for t, (a, b) in jm.init_lora(jax.random.PRNGKey(5), n_slots).items()}
    tm = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    tparams = bridge.tensor_tree(jax.tree.map(np.asarray, jparams), "cpu")
    tlora = bridge.tensor_tree(lora, "cpu")
    # a cache with history: random K/V below each row's start
    B = 4
    start = np.array([0, 5, 12, 3], np.int32)
    jcache = jm.init_cache(B, T)
    k = rng.standard_normal(jcache["k"].shape, np.float32)
    v = rng.standard_normal(jcache["v"].shape, np.float32)
    live = np.arange(T)[None, :] < start[:, None]  # (B, T)
    k *= live[None, :, :, None, None]
    v *= live[None, :, :, None, None]
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(start)}
    tcache = tm.init_cache(B, T)
    tcache["k"].copy_(torch.from_numpy(k))
    tcache["v"].copy_(torch.from_numpy(v))
    tcache["len"] = torch.from_numpy(start.copy())
    jl = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in lora.items()}
    return (jm, jparams, jl, jcache), (tm, tparams, tlora, tcache), start


def _check_cache(jc, tc, rows=None):
    for key in ("k", "v", "len"):
        want = np.asarray(jc[key])
        got = tc[key].numpy()
        if rows is not None:
            got = got[:, rows] if key != "len" else got[rows]
            want = want[:, rows] if key != "len" else want[rows]
        np.testing.assert_allclose(got, want, **XTOL)


def test_extend_row_masked_mixed_chunk_matches_jax():
    """A mixed chunk: a full prefill row, a decode rider (true_lens 1), an
    idle row (true_lens 0) and a partial row, through ragged_extend."""
    (jm, jp, jl, jc), (tm, tp, tl, tc), start = _pair(T=48)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 256, size=(4, 8)).astype(np.int32)
    true_lens = np.array([8, 1, 0, 5], np.int32)
    ids = np.array([2, -1, 0, 1], np.int32)
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(tokens), jnp.asarray(start),
                           lora=jl, adapter_ids=jnp.asarray(ids),
                           all_logits=True, true_lens=jnp.asarray(true_lens))
    tlog, tnew = tm.extend(tp, tc, torch.from_numpy(tokens),
                           torch.from_numpy(start), lora=tl,
                           adapter_ids=torch.from_numpy(ids), all_logits=True,
                           true_lens=torch.from_numpy(true_lens))
    for b in range(4):  # real positions; pads are nobody's next token
        n = true_lens[b]
        np.testing.assert_allclose(tlog[b, :n].numpy(), np.asarray(jlog)[b, :n],
                                   **XTOL)
    _check_cache(jnew, tnew)
    # gathering before the unembedding gives the same numbers
    (_, _, _, _), (tm2, tp2, tl2, tc2), _ = _pair(T=48)
    last = np.maximum(true_lens - 1, 0)[:, None]
    glog, _ = tm2.extend(tp2, tc2, torch.from_numpy(tokens),
                         torch.from_numpy(start), lora=tl2,
                         adapter_ids=torch.from_numpy(ids),
                         true_lens=torch.from_numpy(true_lens),
                         logit_positions=torch.from_numpy(last))
    np.testing.assert_allclose(
        glog[:, 0].numpy(), tlog[torch.arange(4), torch.from_numpy(last[:, 0])].numpy(),
        **TOL)


@pytest.mark.parametrize("T", [96, 50], ids=["paged", "ragged"])
def test_extend_decode_s1_matches_jax(T):
    """S = 1 without a token mask: paged decode when a page size divides T,
    ragged_extend with true_lens 1 when none does."""
    (jm, jp, jl, jc), (tm, tp, tl, tc), start = _pair(T=T)
    tokens = np.array([[3], [77], [200], [9]], np.int32)
    ids = np.array([0, 1, -1, 2], np.int32)
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(tokens), jnp.asarray(start),
                           lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tnew = tm.extend(tp, tc, torch.from_numpy(tokens),
                           torch.from_numpy(start), lora=tl,
                           adapter_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **XTOL)
    _check_cache(jnew, tnew)


def test_extend_keep_rows_writes_only_kept_rows():
    """The in-place port writes and advances only kept rows: the rows the
    reference's engine keeps from its new cache, the others untouched."""
    (jm, jp, jl, jc), (tm, tp, tl, tc), start = _pair(T=96)
    before = {k: v.clone() for k, v in tc.items()}
    tokens = np.array([[3], [77], [200], [9]], np.int32)
    ids = np.array([0, 1, -1, 2], np.int32)
    keep = np.array([True, False, True, False])
    jlog, jnew = jm.extend(jp, jc, jnp.asarray(tokens), jnp.asarray(start),
                           lora=jl, adapter_ids=jnp.asarray(ids))
    tlog, tnew = tm.extend(tp, tc, torch.from_numpy(tokens),
                           torch.from_numpy(start), lora=tl,
                           adapter_ids=torch.from_numpy(ids),
                           keep_rows=torch.from_numpy(keep))
    kept = np.flatnonzero(keep)
    np.testing.assert_allclose(tlog.numpy()[kept], np.asarray(jlog)[kept], **XTOL)
    _check_cache(jnew, tnew, rows=kept)
    for key in ("k", "v"):
        assert torch.equal(tnew[key][:, ~torch.from_numpy(keep)],
                           before[key][:, ~torch.from_numpy(keep)])
    assert tnew["len"].tolist() == [start[0] + 1, start[1], start[2] + 1, start[3]]


def test_extend_skips_writes_past_the_cache():
    """A row at len == T writes nothing (the reference's scatter drops it)."""
    tm = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0))
    cache = tm.init_cache(2, 16)
    start = torch.tensor([16, 2], dtype=torch.int32)
    logits, cache = tm.extend(params, cache, torch.tensor([[1], [2]]), start)
    assert torch.isfinite(logits).all()
    assert torch.all(cache["k"][:, 0] == 0)
    assert torch.any(cache["k"][:, 1, 2] != 0)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_recurrent_and_encdec_layouts_extend(arch):
    """The recurrent and encoder-decoder layouts build on the CPU and run
    one ``extend``; they are held against the reference in
    ``tests/test_torch_recurrent.py`` and ``tests/test_torch_encdec.py``."""
    cfg = configs.reduced(configs.get(arch))
    tm = build_model(cfg, dtype=torch.float32, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0))
    if cfg.is_encdec:
        cache = tm.init_cache(2, 16, 6)
    else:
        cache = tm.init_cache(2, 16)
    tokens = torch.tensor([[1, 2, 3], [4, 5, 6]])
    logits, cache = tm.extend(params, cache, tokens, torch.tensor([0, 5], dtype=torch.int32))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert cache["len"].tolist() == [3, 8]
