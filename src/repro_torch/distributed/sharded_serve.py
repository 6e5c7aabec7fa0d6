"""The sharded prefill and decode steps: the torch counterparts of what
GSPMD makes of the reference's ``make_prefill_step`` and
``make_decode_step`` under the placements of
:mod:`repro_torch.distributed.sharding`, on a ("data", "model")
``DeviceMesh``, as the reference's dry run lowers them.

Each rank holds its shards of the params and LoRA (``param_specs``
without ``cfg``, as the dry run places them), its rows of the batch
(``batch_specs``) and its shard of the cache (``cache_specs``):
:func:`serve_state_specs` names the specs of all three, and
``make_shardings`` / ``shard_tree`` cut a whole tree to a rank's part.
Every family runs: dense GQA (the int8 KV cache included), MLA + MoE,
RWKV-6, the RG-LRU hybrid and the encoder-decoder. Where ``model`` > 1 the
forward runs with the tensor- and expert-parallel collectives of
:mod:`repro_torch.distributed.tensor_parallel`, and the cache is used
where it lies: a cache sharded by kv heads is attended by this rank's
query heads; one sharded in time (fewer kv heads than ranks, MLA's latent,
the hybrid's ring) is written by the rank that owns each slot and attended
by every query head over the rank's slots, the partial outputs merged by
their log-sum-exp over ``model``. No cache leaf is ever gathered. RWKV's
``wkv`` holds the rank's heads; the replicated states (RWKV's token-shift
anchors, the RG-LRU's ``h`` and ``conv``) stay equal on every rank.
``len`` stays on the host with the rank's rows. An MoE counts its experts'
capacity over the whole batch (``moe_ffn``'s ``data_group``).

The logits and the greedy tokens are whole (equal on every rank of a
``model`` group) for the rank's rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.model import make_decode_step
from ..tree import flatten_with_names, leaves, unflatten
from .sharding import axis_sizes, cache_specs, param_specs
from .tensor_parallel import TensorParallel


def serve_state_specs(params, lora, cache, mesh) -> dict[str, tuple]:
    """The spec of every leaf of a serving state, by ``params/``,
    ``lora/`` and ``cache/`` path names: params and LoRA by
    ``param_specs`` (without ``cfg``, as the reference's dry run places
    them), the whole cache by ``cache_specs``."""
    out = {}
    for prefix, specs in (("params", param_specs(params, mesh)),
                          ("lora", param_specs(lora or {}, mesh)),
                          ("cache", cache_specs(cache, mesh))):
        out.update({f"{prefix}/{n}": s for n, s in specs.items()})
    return out


def whole_cache(model, batch: int, max_len: int, src_len: int | None = None):
    """The whole cache ``model.init_cache`` makes, on the meta device (its
    shapes and dtypes; ``len`` on the host): what :func:`serve_state_specs`
    and :func:`make_sharded_prefill_step` read."""
    meta = dataclasses.replace(model, device=torch.device("meta"), tp=None)
    if model.cfg.is_encdec:
        return meta.init_cache(batch, max_len, src_len)
    return meta.init_cache(batch, max_len)


@dataclasses.dataclass
class _ServingTP(TensorParallel):
    """The model axis of the serving steps, whose weights stay fixed from
    call to call: :meth:`prepare` (which all-gathers the layer-stacked dense
    FFNs whole) runs again only when ``params`` or ``lora`` changed, a leaf
    replaced or written in place (its version counter), and keeps the last
    result. One object is shared by a model's prefill and decode steps."""

    memo: dict = dataclasses.field(default_factory=dict, repr=False)

    def prepare(self, params, lora, cfg):
        if torch.is_grad_enabled():
            return super().prepare(params, lora, cfg)
        key = tuple((id(t), t._version) for t in leaves((params, lora)))
        if self.memo.get("key") != key:
            self.memo.clear()  # the old copies go before the new ones are made
            # the inputs are kept, so the ids in the key stay theirs
            self.memo.update(key=key, inputs=(params, lora),
                             out=super().prepare(params, lora, cfg))
        return self.memo["out"]


def sharded_model(model, shardings: dict):
    """``model`` on this rank: with the model axis's tensor parallelism
    (the params' and the cache's specs) where ``model`` > 1, and the
    ``data`` group for an MoE's capacity where ``data`` > 1. A model this
    function made is returned as it is, so the prefill and decode steps
    built from it share one preparation of the weights. ``shardings``:
    ``make_shardings(serve_state_specs(params, lora, cache, mesh), mesh)``
    of the whole state."""
    mesh = next(iter(shardings.values())).mesh
    axes = axis_sizes(mesh)
    if tuple(axes) != ("data", "model"):
        raise ValueError(f"a ('data', 'model') mesh, not {tuple(axes)}")
    n_data, n_model = axes["data"], axes["model"]

    def under(prefix):
        return {n[len(prefix):]: s.spec for n, s in shardings.items() if n.startswith(prefix)}

    if n_model > 1 and not isinstance(model.tp, _ServingTP):
        model = dataclasses.replace(model, tp=_ServingTP(
            mesh.get_group("model"), n_model, mesh.get_coordinate()[1], under("params/"),
            cache_specs=under("cache/")))
    if n_data > 1 and model.cfg.moe is not None:
        model = dataclasses.replace(model, data_group=mesh.get_group("data"))
    return model


def make_sharded_prefill_step(model, shardings: dict, cache):
    """prefill_step(local params, local lora, local batch) -> (last-token
    logits (B_local, 1, vocab) whole, this rank's cache): a fresh prefill
    of ``batch["tokens"]`` into this rank's shards of a zero ``cache`` (an
    encoder-decoder first encodes ``batch["frames"]``). ``model``: as given
    to :func:`sharded_model`; ``shardings`` as there; ``cache``: the whole
    cache the step fills (its shapes and dtypes: :func:`whole_cache`),
    whose time axis bounds the prompt (a recurrent state or ring bounds
    none)."""
    model = sharded_model(model, shardings)
    leaves_ = [(n, shardings[f"cache/{n}"].local_shape(tuple(t.shape)), t.dtype)
               for n, t in flatten_with_names(cache)]
    timed = [cache[n] for n in ("k", "latent") if n in cache]
    max_len = None if getattr(model, "recurrent", False) or not timed else timed[0].shape[2]

    def zero_cache():
        return unflatten(cache, [torch.zeros(shape, dtype=dt, device="cpu" if n == "len"
                                             else model.device)
                                 for n, shape, dt in leaves_])

    def prefill_step(params, lora, batch):
        kw = dict(lora=lora, adapter_ids=batch.get("adapter_ids"), cache=zero_cache())
        T = max_len or batch["tokens"].shape[1]
        if model.cfg.is_encdec:
            return model.prefill(params, batch["frames"], batch["tokens"], T, **kw)
        return model.prefill(params, batch["tokens"], T,
                             extra_embeds=batch.get("extra_embeds"),
                             mrope_positions=batch.get("mrope_positions"), **kw)

    return prefill_step


def make_sharded_decode_step(model, shardings: dict):
    """``make_decode_step`` of :func:`sharded_model`: decode_step(local
    params, local lora, local cache, local batch) -> (next tokens
    (B_local,) int32, cache), one greedy token per row against this rank's
    shard of the cache, which is updated in place."""
    return make_decode_step(sharded_model(model, shardings))
