"""Decoder-only LM (PyTorch counterpart of ``repro.models.transformer.LM``):
the dense GQA, MLA, MoE, RWKV-6 and RG-LRU hybrid layouts.

Parameters keep the reference's pytree layout as nested dicts of tensors,
with the layers stacked on a leading axis, so :mod:`repro_torch.bridge`
maps one onto the other leaf by leaf:

  {"embed", "final_norm", ["lm_head"],
   "layers": {"norm1", "norm2",
              "mixer": {"wq", "wk", "wv", "wo", ["q_norm", "k_norm"]}
                    or {"wq", "w_kv_a", "kv_norm", "w_kv_b", "wo"} (MLA)
                    or RWKV's time and channel mix (no "ffn"),
              "ffn": {"w_gate", "w_up", "w_down"}
                  or {"router", "w_gate", "w_up", "w_down", ["shared"]} (MoE)}}

and for the RG-LRU hybrid (recurrentgemma) ``{"rec_layers",
"attn_layers", "ffn_layers", "norms"}`` in place of "layers", each stacked
over the layers of its kind (``_layer_types`` gives the pattern; the
hybrid's LoRA is indexed by the global layer).

Public surface (functions of the params, as in the reference):
  init_params(gen)                          -> params
  init_lora(gen, n_slots)                   -> stacked multi-LoRA params
  init_cache(batch, max_len)                -> decode cache
  forward(params, tokens, ...)              -> (logits, aux)
  prefill(params, tokens, max_len, ...)     -> (last logits, cache)
  extend(params, cache, tokens, start, ...) -> (logits, cache)
  decode(params, cache, tokens, ...)        -> (logits, cache)

The cache is {"k", "v"} (L, B, T, Hkv, D), int8 with f32 "k_scale" and
"v_scale" (L, B, T, Hkv) under ``kv_quant``, or MLA's {"latent" (L, B, T,
kv_lora), "krope" (L, B, T, rope)}, or RWKV's state {"tm_x", "wkv" (f32),
"cm_x"} (L, B, ...), or the hybrid's {"h" (f32), "conv"} (recurrent
layers, B, ...) and {"k", "v"} (attention layers, B, W, Hkv, D) with W =
min(max_len, window), a ring of slots where W is the window; plus "len".
``forward`` and ``prefill`` run a fresh sequence (GQA through
``flash_prefill`` unless the config sets a logit softcap; MLA expanded,
through the plain attention); ``extend`` (and ``decode``, which is
``extend`` at ``cache["len"]`` with one token per row) runs against the
cache. ``prefill`` writes each layer's cache rows into a new cache in
place, where the reference pads; the recurrent layouts prefill as
``extend`` from a zero state, as the reference's hybrid does, and RWKV's
``forward`` runs every layer from a zero state, as the reference's does.
``extend`` updates the cache in place and returns it: only the real tokens of kept
rows are written (on an MoE config an unkept row's tokens reach the
experts as the reference's do, see ``attention.cached_step``), a recurrent
state changes only in kept rows, and ``len`` advances only for kept rows.
``cache["len"]`` is a host-side (CPU) int32 tensor, so planning a step
never waits on the device. As in the reference, ``forward``, ``prefill``,
``extend`` and ``decode`` take ``mrope_positions`` (3, B, S), which rotate
q and k by M-RoPE on a config with ``mrope_sections``, and all but
``decode`` take ``extra_embeds`` (B, S, d), added to the token embeddings
(the modality frontend's stub). The MoE auxiliary loss is summed over the
layers by ``forward``. As in the reference's ``LM``, attention runs
without a sliding window except in the hybrid's attention layers, which
take the config's window (and so the plain attention, as the reference
routes a window).

Under tensor parallelism (``tp``) ``forward``, ``prefill``, ``extend`` and
``decode`` run on this rank's shards of the params and LoRA and (the
sharded serving steps, :mod:`repro_torch.distributed.sharded_serve`) of the
cache, as ``tp.cache_specs`` places it; the logits are whole.

Training knobs, the reference's ``LM`` fields: ``remat`` recomputes each
layer of ``forward`` in the backward pass (``torch.utils.checkpoint``,
non-reentrant) instead of keeping its activations; ``remat_policy``
"dots" keeps the outputs of the plain matrix products (``aten.mm``,
``aten.addmm``: ``dots_with_no_batch_dims_saveable``) and recomputes the
rest (selective activation checkpointing), "full" keeps nothing. The
kernels are no aten operations, so the policy never keeps their outputs:
under either policy the forward's kernels run again in the backward, and
their launch counts double. As in the reference, the hybrid's layers are
not rematerialised. ``q_chunk`` > 0 sends windowed or soft-capped
attention through ``attention.sdpa_blockwise`` (see ``gqa_full``). The
reference's ``unroll`` (a Python loop instead of ``lax.scan``, for the
dry-run's cost analysis) has no meaning here: the layers are always a
Python loop.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (cached_step, gqa_cached, gqa_full, init_gqa, init_mla,
                        mla_cached, mla_full, quantize_kv_rows, step_rope)
from .common import dense_init, embed_init, init_rms, rms_norm
from .ffn import dense_ffn, init_dense_ffn, init_moe, moe_ffn
from .recurrent import (init_rglru_layers, init_rwkv_layers, rglru_block,
                        rglru_state_init, rwkv_channel_mix, rwkv_state_init,
                        rwkv_time_mix)


# the products "dots" keeps: plain matrix products with no batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn, policy: str, *args):
    """``fn(*args)`` recomputed in the backward pass: everything under
    "full", all but the plain matrix products under "dots"."""
    kw = {}
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    elif policy != "full":
        raise ValueError(f"remat_policy {policy!r}: 'full' or 'dots'")
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


def layer_views(tree, n: int) -> list:
    """The ``n`` layers of a layer-stacked dict / tuple tree (or of None),
    each leaf unbound once (``torch.unbind``, views): under autograd one
    stack gathers a leaf's gradients over all its layers, where indexing
    each layer apart would give every layer's gradient as a zero tensor of
    the whole stack, added up layer by layer."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        per = {k: layer_views(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        per = [layer_views(v, n) for v in tree]
        return [tuple(p[i] for p in per) for i in range(n)]
    return list(torch.unbind(tree, 0))


@dataclasses.dataclass
class LM:
    cfg: ModelConfig
    dtype: torch.dtype = torch.bfloat16  # the reference's default
    device: torch.device | str | None = None  # None: the card, raising without one
    kv_quant: bool = False  # int8 KV cache with per-(token, head) f32 scales
    remat: bool = False  # recompute each layer of forward in the backward
    q_chunk: int = 0  # > 0: windowed / soft-capped attention blockwise
    remat_policy: str = "full"  # or "dots": keep the matrix products
    # tensor parallelism over a mesh's model axis (``forward`` on local
    # shards): a distributed.tensor_parallel.TensorParallel
    tp: object = None
    # the data-parallel process group whose ranks hold the batch's rows: an
    # MoE FFN fills its queues and counts its load over the whole batch
    data_group: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------ init
    def init_params(self, gen: torch.Generator) -> dict:
        """Random weights drawn from ``gen`` (on the generator's device) and
        placed on the model's device: the same seed gives the same weights
        whatever the model's device is when ``gen`` is a CPU generator."""
        cfg, L, dt, dev = self.cfg, self.cfg.num_layers, self.dtype, self.device
        params: dict = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "final_norm": init_rms(cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt, dev)
        if cfg.rglru is not None:
            params.update(self._init_hybrid_layers(gen))
            return params
        norms = {"norm1": torch.zeros((L, cfg.d_model), dtype=dt, device=dev),
                 "norm2": torch.zeros((L, cfg.d_model), dtype=dt, device=dev)}
        if cfg.rwkv is not None:  # RWKV carries its own channel mix, no FFN
            params["layers"] = {**norms, "mixer": init_rwkv_layers(gen, cfg, L, dt, dev)}
            return params
        params["layers"] = {
            **norms,
            "mixer": (init_mla(gen, cfg, L, dt, dev) if cfg.mla is not None
                      else init_gqa(gen, cfg, L, dt, dev)),
            "ffn": (init_moe(gen, cfg, L, dt, dev) if cfg.moe is not None
                    else init_dense_ffn(gen, L, cfg.d_model, cfg.d_ff, dt, dev)),
        }
        return params

    def _layer_types(self) -> list[str]:
        """The hybrid's layer kinds, "rec" or "attn", by its block pattern."""
        pat = self.cfg.rglru.block_pattern
        return [pat[i % len(pat)] for i in range(self.cfg.num_layers)]

    def _init_hybrid_layers(self, gen: torch.Generator) -> dict:
        cfg, L, dt, dev = self.cfg, self.cfg.num_layers, self.dtype, self.device
        types = self._layer_types()
        return {
            "rec_layers": init_rglru_layers(gen, cfg, types.count("rec"), dt, dev),
            "attn_layers": init_gqa(gen, cfg, types.count("attn"), dt, dev),
            "ffn_layers": init_dense_ffn(gen, L, cfg.d_model, cfg.d_ff, dt, dev),
            "norms": {"norm1": torch.zeros((L, cfg.d_model), dtype=dt, device=dev),
                      "norm2": torch.zeros((L, cfg.d_model), dtype=dt, device=dev)},
        }

    # ------------------------------------------------------------------ LoRA
    def lora_dims(self) -> dict[str, tuple[int, int]]:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        if cfg.rwkv is not None:
            dims = {"r": (d, d), "k": (d, d), "v": (d, d), "o": (d, d)}
        elif cfg.mla is not None:
            m = cfg.mla
            dims = {
                "q": (d, cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                "kv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
                "o": (cfg.num_heads * m.v_head_dim, d),
            }
        else:
            dims = {
                "q": (d, cfg.num_heads * hd),
                "k": (d, cfg.num_kv_heads * hd),
                "v": (d, cfg.num_kv_heads * hd),
                "o": (cfg.num_heads * hd, d),
            }
        return {t: dims[t] for t in cfg.lora.targets if t in dims}

    def init_lora(self, gen: torch.Generator, n_slots: int) -> dict:
        """Stacked multi-LoRA params {target: (A (L, slots, din, r),
        B (L, slots, r, dout))}; B starts at zero, as in the reference."""
        cfg = self.cfg
        r, L = cfg.lora.rank, cfg.num_layers
        out = {}
        for t, (din, dout) in self.lora_dims().items():
            a = torch.randn((L, n_slots, din, r), generator=gen, device=gen.device)
            a = (a * (1.0 / din ** 0.5)).to(self.device, self.dtype)
            b = torch.zeros((L, n_slots, r, dout), dtype=self.dtype, device=self.device)
            out[t] = (a, b)
        return out

    @property
    def lora_scale(self) -> float:
        return self.cfg.lora.alpha / self.cfg.lora.rank

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        L = cfg.num_layers
        if cfg.rwkv is not None:
            cache = rwkv_state_init(cfg, batch, self.dtype, dev, n_layers=L)
        elif cfg.rglru is not None:
            types = self._layer_types()
            cache = rglru_state_init(cfg, batch, self.dtype, dev,
                                     n_layers=types.count("rec"))
            W = min(max_len, cfg.window_size or max_len)
            shape = (types.count("attn"), batch, W, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache["k"] = torch.zeros(shape, dtype=self.dtype, device=dev)
            cache["v"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        elif cfg.mla is not None:
            m = cfg.mla
            cache = {
                "latent": torch.zeros((L, batch, max_len, m.kv_lora_rank),
                                      dtype=self.dtype, device=dev),
                "krope": torch.zeros((L, batch, max_len, m.qk_rope_head_dim),
                                     dtype=self.dtype, device=dev),
            }
        else:
            shape = (L, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            kv_dtype = torch.int8 if self.kv_quant else self.dtype
            cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                     "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}
            if self.kv_quant:
                for key in ("k_scale", "v_scale"):
                    cache[key] = torch.zeros(shape[:-1], dtype=torch.float32,
                                             device=dev)
        cache["len"] = torch.zeros((batch,), dtype=torch.int32)  # host side
        return cache

    # ------------------------------------------------------------ embeddings
    def _embed(self, params, tokens, extra_embeds=None):
        if self.tp is not None:
            x = self.tp.embed(params["embed"], tokens, self.cfg.vocab_size).to(self.dtype)
        else:
            x = params["embed"][tokens].to(self.dtype)
        if extra_embeds is not None:  # the modality frontend's stub
            x = x + torch.as_tensor(extra_embeds).to(x.device, self.dtype)
        return x

    def _unembed(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        tied = self.cfg.tie_embeddings
        if self.tp is not None:
            return self.tp.logits(x, params["embed" if tied else "lm_head"],
                                  self.cfg.vocab_size, transposed=tied)
        if tied:
            return x @ params["embed"].T
        return x @ params["lm_head"]

    # ---------------------------------------------------------- layer bodies
    def _ffn(self, lp, h2):
        """The layer's FFN: (out, MoE aux loss, or None for a dense FFN)."""
        if self.cfg.moe is not None:
            return moe_ffn(lp["ffn"], h2, self.cfg, self.data_group, self.tp)
        return dense_ffn(lp["ffn"], h2, self.cfg.activation), None

    def _layer_full(self, lp, lora_slice, x, rope, adapter_ids, whole_kv=False):
        """One layer over a fresh sequence; returns (x, aux, cache rows):
        (k, v) (every kv head with ``whole_kv``), or MLA's (latent, k_rope)."""
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if cfg.mla is not None:
            mixed, kv = mla_full(lp["mixer"], h, rope, cfg, lora=lora_slice,
                                 adapter_ids=adapter_ids, lora_scale=self.lora_scale,
                                 tp=self.tp)
        else:
            mixed, kv = gqa_full(lp["mixer"], h, rope, cfg, lora=lora_slice,
                                 adapter_ids=adapter_ids, lora_scale=self.lora_scale,
                                 q_chunk=self.q_chunk, tp=self.tp, whole_kv=whole_kv)
        x = x + mixed
        out, aux = self._ffn(lp, rms_norm(x, lp["norm2"], cfg.norm_eps))
        return x + out, aux, kv

    @property
    def recurrent(self) -> bool:
        """RWKV or the RG-LRU hybrid: a state per row, not a per-token KV."""
        return self.cfg.rwkv is not None or self.cfg.rglru is not None

    def _rwkv_layer(self, lp, lora_slice, x, state, adapter_ids, token_mask=None):
        """One RWKV layer (time mix, then channel mix) from ``state``;
        returns (x, new state)."""
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        mixed, state = rwkv_time_mix(lp["mixer"], h, state, cfg, lora_slice,
                                     adapter_ids, self.lora_scale, token_mask, self.tp)
        x = x + mixed
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        out, state = rwkv_channel_mix(lp["mixer"], h2, state, cfg, token_mask, self.tp)
        return x + out, state

    def _hybrid_layers(self, params, x, mixer):
        """Run the hybrid's layers in order: ``mixer(kind, index of its
        kind, layer params, global index, h)`` gives each layer's mixed
        output; the dense FFN follows every layer."""
        cfg = self.cfg
        types = self._layer_types()
        L = len(types)
        norms, ffn = layer_views(params["norms"], L), layer_views(params["ffn_layers"], L)
        kinds = {k: layer_views(params[f"{k}_layers"], types.count(k))
                 for k in ("rec", "attn")}
        seen = {"rec": 0, "attn": 0}
        for i, kind in enumerate(types):
            h = rms_norm(x, norms[i]["norm1"], cfg.norm_eps)
            j = seen[kind]
            seen[kind] += 1
            x = x + mixer(kind, j, kinds[kind][j], i, h)
            h2 = rms_norm(x, norms[i]["norm2"], cfg.norm_eps)
            x = x + dense_ffn(ffn[i], h2, cfg.activation)
        return x

    def _hybrid_full(self, params, x, lora, adapter_ids):
        """Every layer of the hybrid over a fresh sequence (zero state,
        positions 0 .. S-1), the attention layers through ``gqa_full`` with
        the config's window."""
        cfg, dev = self.cfg, self.device
        B, S, _ = x.shape
        rope = step_rope(cfg, torch.arange(S, device=dev))
        loras = layer_views(lora or None, cfg.num_layers)

        def mixer(kind, j, lp, i, h):
            if kind == "rec":
                return rglru_block(lp, h, rglru_state_init(cfg, B, self.dtype, dev),
                                   cfg, tp=self.tp)[0]
            return gqa_full(lp, h, rope, cfg, lora=loras[i],
                            adapter_ids=adapter_ids, lora_scale=self.lora_scale,
                            window=cfg.window_size, q_chunk=self.q_chunk, tp=self.tp)[0]

        return self._hybrid_layers(params, x, mixer)

    def _recurrent_cached(self, params, cache, x, start, lora, adapter_ids,
                          true_lens=None, keep_rows=None):
        """Every layer of a recurrent layout against ``cache``, updated in
        place: a layer's new state is written for the kept rows only (all
        rows without ``keep_rows``); the hybrid's attention layers write
        their window as ``cached_step`` plans it."""
        cfg, dev, tp = self.cfg, self.device, self.tp
        B, S, _ = x.shape
        keep = None
        if keep_rows is not None:
            keep = torch.as_tensor(keep_rows).to(dev, torch.bool, non_blocking=True)

        def store(leaf, i, old, new):
            if keep is not None:
                new = torch.where(keep.view(B, *(1,) * (new.dim() - 1)), new, old)
            leaf[i].copy_(new)

        if cfg.rwkv is not None:
            mask = None
            if true_lens is not None:
                tl = torch.as_tensor(true_lens).to(dev, torch.int64, non_blocking=True)
                mask = torch.arange(S, device=dev)[None, :] < tl[:, None]
            return self._rwkv_layers(params, x, lora, adapter_ids, cache, mask, store)
        T, shard = self._cache_slots(cache, "k")
        step = cached_step(start, S, T, dev, cfg, true_lens=true_lens,
                           keep_rows=keep_rows, window=cfg.window_size, shard=shard)
        mask = None
        if step.true_lens is not None:
            mask = torch.arange(S, device=dev)[None, :] < step.true_lens[:, None]
        loras = layer_views(lora or None, cfg.num_layers)

        def mixer(kind, j, lp, i, h):
            if kind == "rec":
                st = {"h": cache["h"][j], "conv": cache["conv"][j]}
                out, new = rglru_block(lp, h, st, cfg, mask, tp=tp)
                if tp is not None and tp.units(cfg.rglru.lru_width or cfg.d_model):
                    # this rank's channels of the replicated state: gathered,
                    # so that every replica stays equal
                    new = {k: tp.gather(t) for k, t in new.items()}
                for k in st:
                    store(cache[k], j, st[k], new[k])
                return out
            return gqa_cached(lp, h, step, cache["k"][j], cache["v"][j], cfg,
                              lora=loras[i], adapter_ids=adapter_ids,
                              lora_scale=self.lora_scale, tp=tp)

        return self._hybrid_layers(params, x, mixer)

    def _rwkv_layers(self, params, x, lora, adapter_ids, cache=None, mask=None,
                     store=None):
        """RWKV's layers in order. With ``cache`` (``extend``) each starts
        from its state there and ``store(leaf, i, old, new)`` writes the new
        one; without (``forward``) each starts from a zero state, nothing is
        written, and under ``remat`` and autograd each layer is recomputed
        in the backward pass."""
        cfg, L, B = self.cfg, self.cfg.num_layers, x.shape[0]
        names = ("tm_x", "wkv", "cm_x")
        remat = self.remat and cache is None and torch.is_grad_enabled()

        def layer(lp, lsl, x, i):
            st = (rwkv_state_init(cfg, B, self.dtype, self.device) if cache is None
                  else {k: cache[k][i] for k in names})
            return self._rwkv_layer(lp, lsl, x, st, adapter_ids, mask)

        for i, (lp, lsl) in enumerate(zip(layer_views(params["layers"], L),
                                          layer_views(lora or None, L))):
            if remat:
                x = remat_call(lambda *a: layer(*a)[0], self.remat_policy, lp, lsl, x, i)
                continue
            x, new = layer(lp, lsl, x, i)
            if cache is not None:
                for k in names:
                    store(cache[k], i, cache[k][i], new[k])
        return x

    def _write_full(self, cache, i: int, S: int, kv) -> None:
        """Layer ``i``'s rows of a fresh sequence into ``cache[..][i, :, :S]``
        (quantised under ``kv_quant``); on a time shard of slots [o, o + n),
        the rows of those positions only."""
        if self.cfg.mla is not None:
            names, rows = ("latent", "krope"), kv
        elif self.kv_quant:
            (kq, ks), (vq, vs) = map(quantize_kv_rows, kv)
            names, rows = ("k", "v", "k_scale", "v_scale"), (kq, vq, ks, vs)
        else:
            names, rows = ("k", "v"), kv
        for name, row in zip(names, rows):
            shard = self._cache_slots(cache, name)[1]
            if shard is None:
                cache[name][i, :, :S] = row
            elif S > shard[0]:
                o, n = shard
                m = min(S - o, n)
                cache[name][i, :, :m] = row[:, o:o + m]

    def _cache_slots(self, cache, name: str):
        """(T, shard) of the cache leaf ``name``: its whole number of slots,
        and this rank's time shard of them (first slot, slots) where
        ``tp.cache_specs`` shards its time axis (else None)."""
        n = cache[name].shape[2]
        shard = None if self.tp is None else self.tp.time_shard(name, n)
        return (n if shard is None else n * self.tp.size), shard

    def _holds_every_kv_head(self, cache) -> bool:
        """Under ``tp``, whether this rank's GQA cache holds every kv head
        (a time shard, or a replicated cache), so that a prefill hands it
        every kv head's rows."""
        return (self.tp is not None and self.cfg.mla is None
                and cache["k"].shape[3] == self.cfg.num_kv_heads)

    def _run_full(self, params, tokens, lora, adapter_ids, cache=None,
                  extra_embeds=None, mrope_positions=None):
        """Embed ``tokens`` (B, S) and run every layer over the fresh
        sequence (positions 0 .. S-1); with ``cache``, layer i's rows go
        into its first S positions. Returns the final hidden states (B, S,
        d) and the summed MoE aux loss (0 without MoE)."""
        cfg, dev = self.cfg, self.device
        tokens = torch.as_tensor(tokens).to(dev, torch.int64, non_blocking=True)
        B, S = tokens.shape
        x = self._embed(params, tokens, extra_embeds)
        ids = None
        if adapter_ids is not None:
            ids = torch.as_tensor(adapter_ids).to(dev, torch.int32, non_blocking=True)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if cfg.rwkv is not None:  # every layer from a zero state
            return self._rwkv_layers(params, x, lora, ids), aux
        if cfg.rglru is not None:
            return self._hybrid_full(params, x, lora, ids), aux
        rope = step_rope(cfg, torch.arange(S, device=dev), mrope_positions)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        lps = layer_views(params["layers"], cfg.num_layers)
        lsls = layer_views(lora or None, cfg.num_layers)
        whole_kv = cache is not None and self._holds_every_kv_head(cache)
        for i in range(cfg.num_layers):
            lp, lsl = lps[i], lsls[i]
            if remat:
                x, a = remat_call(self._layer_train, self.remat_policy, lp, lsl, x,
                                  rope, ids)
                aux = aux + a
                continue
            x, a, kv = self._layer_full(lp, lsl, x, rope, ids, whole_kv)
            if a is not None:
                aux = aux + a
            if cache is not None:
                self._write_full(cache, i, S, kv)
        return x, aux

    def _layer_train(self, lp, lora_slice, x, rope, adapter_ids):
        """One layer of ``forward`` under remat: (x, aux), the cache rows
        dropped so nothing of them is kept."""
        x, a, _ = self._layer_full(lp, lora_slice, x, rope, adapter_ids)
        return x, (torch.zeros((), dtype=torch.float32, device=x.device)
                   if a is None else a)

    def _layer_cached(self, lp, lora_slice, lcache, x, step, adapter_ids):
        """One layer against its cache ``lcache`` (layer i of every array)."""
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        kw = dict(lora=lora_slice, adapter_ids=adapter_ids,
                  lora_scale=self.lora_scale, tp=self.tp)
        if cfg.mla is not None:
            x = x + mla_cached(lp["mixer"], h, step, lcache["latent"],
                               lcache["krope"], cfg, **kw)
        else:
            x = x + gqa_cached(lp["mixer"], h, step, lcache["k"], lcache["v"], cfg,
                               cache_k_scale=lcache.get("k_scale"),
                               cache_v_scale=lcache.get("v_scale"), **kw)
        out, _ = self._ffn(lp, rms_norm(x, lp["norm2"], cfg.norm_eps))
        return x + out

    # ================================================================ train
    def forward(self, params, tokens, *, lora=None, adapter_ids=None,
                extra_embeds=None, mrope_positions=None):
        """Full causal forward over ``tokens`` (B, S); returns
        ``(logits (B, S, vocab), aux)`` with ``aux`` the MoE auxiliary loss
        summed over the layers (0 for a dense FFN). Under ``tp`` the params
        are this rank's shards and the logits whole."""
        if self.tp is not None:
            params, lora = self.tp.prepare(params, lora, self.cfg)
        x, aux = self._run_full(params, tokens, lora, adapter_ids,
                                extra_embeds=extra_embeds,
                                mrope_positions=mrope_positions)
        return self._unembed(params, x), aux

    # ============================================================== prefill
    def prefill(self, params, tokens, max_len: int, *, lora=None,
                adapter_ids=None, extra_embeds=None, mrope_positions=None, cache=None):
        """Fresh full prefill of ``tokens`` (B, S) into a new cache of
        ``max_len`` positions: returns (last-token logits (B, 1, vocab),
        cache) with ``cache["len"]`` S in every row. ``cache``: a zero
        cache to fill instead of a new one (under ``tp``, this rank's
        shards of one)."""
        B, S = torch.as_tensor(tokens).shape
        if S > max_len:
            raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
        if cache is None:
            cache = self.init_cache(B, max_len)
        if self.tp is not None:
            params, lora = self.tp.prepare(params, lora, self.cfg)
        if self.recurrent:  # the reference's hybrid: extend from a zero state
            return self._extend(params, cache, tokens, torch.zeros((B,), dtype=torch.int32),
                                lora=lora, adapter_ids=adapter_ids,
                                extra_embeds=extra_embeds)
        x, _ = self._run_full(params, tokens, lora, adapter_ids, cache=cache,
                              extra_embeds=extra_embeds,
                              mrope_positions=mrope_positions)
        cache["len"] = torch.full((B,), S, dtype=torch.int32)  # host side
        return self._unembed(params, x[:, -1:, :]), cache

    # ====================================================== extend / decode
    def extend(self, params, cache, tokens, start, *, lora=None,
               adapter_ids=None, extra_embeds=None, mrope_positions=None,
               all_logits=False, true_lens=None, keep_rows=None,
               logit_positions=None):
        """Write ``tokens`` (B, S) at per-row offsets ``start`` and return
        logits for the chunk (chunked prefill / decode are S>1 / S=1).

        As in the reference: ``true_lens`` (B,) makes the batch row-masked
        (row i's first ``true_lens[i]`` tokens are real, the rest pad and are
        neither written nor counted in ``len``). Two additions, both
        host-side values: ``keep_rows`` (B,) bool restricts writes and the
        ``len`` update to those rows (the reference writes every row and
        lets the engine keep some), and ``logit_positions`` (B, P) gathers
        the hidden states at those positions BEFORE the unembedding, so a
        caller that needs each row's last real position does not build the
        (B, S, vocab) logits. Without either, logits are for the last
        position, or every position with ``all_logits``."""
        if self.tp is not None:
            params, lora = self.tp.prepare(params, lora, self.cfg)
        return self._extend(params, cache, tokens, start, lora=lora,
                            adapter_ids=adapter_ids, extra_embeds=extra_embeds,
                            mrope_positions=mrope_positions, all_logits=all_logits,
                            true_lens=true_lens, keep_rows=keep_rows,
                            logit_positions=logit_positions)

    def _extend(self, params, cache, tokens, start, *, lora=None, adapter_ids=None,
                extra_embeds=None, mrope_positions=None, all_logits=False,
                true_lens=None, keep_rows=None, logit_positions=None):
        """``extend`` on params (and LoRA) ready for the forward: under
        ``tp``, prepared."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(tokens)
        B, S = tokens.shape
        x = self._embed(params, tokens.to(dev, torch.int64, non_blocking=True),
                        extra_embeds)
        ids = None
        if adapter_ids is not None:
            ids = torch.as_tensor(adapter_ids).to(dev, torch.int32, non_blocking=True)
        lora = lora or {}
        if self.recurrent:
            x = self._recurrent_cached(params, cache, x, start, lora, ids,
                                       true_lens=true_lens, keep_rows=keep_rows)
        else:
            T, shard = self._cache_slots(cache, "latent" if cfg.mla is not None else "k")
            step = cached_step(start, S, T, dev, cfg, true_lens=true_lens,
                               keep_rows=keep_rows, mrope_positions=mrope_positions,
                               shard=shard)
            arrays = {k: v for k, v in cache.items() if k != "len"}
            L = cfg.num_layers
            for i, (lp, lsl) in enumerate(zip(layer_views(params["layers"], L),
                                              layer_views(lora or None, L))):
                x = self._layer_cached(lp, lsl, {k: v[i] for k, v in arrays.items()},
                                       x, step, ids)
        n_real = (torch.full((B,), S) if true_lens is None
                  else torch.as_tensor(true_lens).to("cpu", torch.int64))
        new_len = torch.as_tensor(start).to("cpu", torch.int64) + n_real
        if keep_rows is not None:
            keep = torch.as_tensor(keep_rows).to("cpu", torch.bool)
            new_len = torch.where(keep, new_len, cache["len"].long())
        cache["len"] = new_len.to(torch.int32)
        if logit_positions is not None:
            pos = torch.as_tensor(logit_positions).to(dev, torch.int64)
            x = x[torch.arange(B, device=dev)[:, None], pos]
        elif not all_logits:
            x = x[:, -1:, :]
        return self._unembed(params, x), cache

    def decode(self, params, cache, tokens, *, lora=None, adapter_ids=None,
               mrope_positions=None):
        """One-token decode step: ``tokens`` (B, 1) at the offsets
        ``cache["len"]``."""
        return self.extend(params, cache, tokens, cache["len"], lora=lora,
                           adapter_ids=adapter_ids,
                           mrope_positions=mrope_positions)
