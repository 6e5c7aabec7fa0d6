"""The model's training knobs against the reference on the CPU, from
bridged weights: RWKV's layer loop under ``remat`` (one train step, as
``test_torch_train_layouts`` checks it without), and ``LM(q_chunk > 0)``,
which sends windowed or soft-capped attention through
``attention.sdpa_blockwise``, against the reference's
``build_model(q_chunk=...)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.models.model import cross_entropy as jcross_entropy
from repro_torch import bridge, configs
from repro_torch.models import attention, build_model, cross_entropy
from repro_torch.tree import flatten_with_names
from test_torch_train import _batch, _leaves_close, _lora_numpy, _named, _np_tree, \
    check_step, train_pair


def test_rwkv_train_step_under_remat_matches_the_reference():
    """RWKV's layer loop under ``remat`` (each layer recomputed in the
    backward pass) against the reference's step without it."""
    ref_out, port_out, _ = train_pair("rwkv6-1.6b", remat=True)
    check_step(ref_out, port_out)


@pytest.mark.parametrize("arch,softcap", [("recurrentgemma-2b", 0.0), ("qwen3-0.6b", 30.0)],
                         ids=["window", "softcap"])
def test_q_chunk_model_matches_the_reference(arch, softcap, monkeypatch):
    """``build_model(q_chunk=8)`` at S = 24: the hybrid's windowed attention
    layers (window 16) or qwen3's soft-capped attention go through
    ``sdpa_blockwise`` in chunks of 8; the loss within 1e-5 relative and
    every gradient leaf within 1e-4 of its largest magnitude against the
    reference's model built with the same ``q_chunk``."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    cfg = configs.reduced(configs.get(arch))
    if softcap:
        jcfg = dataclasses.replace(jcfg, logit_softcap=softcap)
        cfg = dataclasses.replace(cfg, logit_softcap=softcap)
    jm = jbuild_model(jcfg, dtype=jnp.float32, q_chunk=8)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    model = build_model(cfg, dtype=torch.float32, device="cpu", q_chunk=8)
    lora = _lora_numpy(model)
    batch = _batch(jcfg, S=24)

    def jloss(tr):
        logits, _ = jm.forward(tr["params"], jnp.asarray(batch["tokens"]), lora=tr["lora"],
                               adapter_ids=jnp.asarray(batch["adapter_ids"]))
        return jcross_entropy(logits, jnp.asarray(batch["labels"]))

    jl, jgrads = jax.value_and_grad(jloss)({"params": jparams,
                                           "lora": jax.tree.map(jnp.asarray, lora)})
    chunks = []
    blockwise = attention.sdpa_blockwise
    monkeypatch.setattr(attention, "sdpa_blockwise",
                        lambda *a, **kw: chunks.append(kw["q_chunk"]) or blockwise(*a, **kw))
    tree = bridge.tensor_tree({"params": _np_tree(jparams), "lora": lora}, "cpu")
    names = [n for n, _ in flatten_with_names(tree)]
    live = [t.requires_grad_(True) for _, t in flatten_with_names(tree)]
    logits, _ = model.forward(tree["params"], torch.from_numpy(batch["tokens"]),
                              lora=tree["lora"],
                              adapter_ids=torch.from_numpy(batch["adapter_ids"]))
    loss = cross_entropy(logits, torch.from_numpy(batch["labels"]))
    grads = torch.autograd.grad(loss, live)
    loss = float(loss.detach())
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.rglru is None
                 or cfg.rglru.block_pattern[i % len(cfg.rglru.block_pattern)] == "attn")
    assert chunks == [8] * n_attn
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    _leaves_close(dict(zip(names, grads)), dict(_named(jgrads)))
