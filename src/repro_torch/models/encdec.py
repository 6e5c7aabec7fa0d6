"""Encoder–decoder LM, the seamless-m4t backbone (PyTorch counterpart of
``repro.models.encdec``).

The modality frontend is a stub, as in the reference: ``encode`` takes
precomputed frame embeddings (B, S_src, d_model). The encoder is
bidirectional attention with RoPE through the plain :func:`sdpa`
(``flash_prefill`` is causal only). The decoder is a causal GQA
transformer with cross-attention: its self-attention goes through the
port's ``gqa_full`` (``flash_prefill``) in ``forward`` and ``gqa_cached``
(``ragged_extend``, or ``paged_attention`` for one token a row where a
page size divides the cache) in ``prefill``/``extend``/``decode``, as the
reference routes them; the cross-attention is the plain :func:`sdpa`, its
K/V computed once at prefill and kept in the cache as "ck"/"cv". Only the
decoder's self-attention projections take LoRA, through ``fused_sgmv``.

Parameters keep the reference's tree, layer-stacked: {"embed", "encoder"
{"attn", "ffn", "norm1", "norm2"}, "enc_norm", "decoder" {"attn",
"cross" {"wq", "wk", "wv", "wo"}, "ffn", "norm1", "norm_c", "norm2"},
"final_norm", "lm_head"}. The cache is {"k", "v" (L, B, T, Hkv, D), "ck",
"cv" (L, B, S_src, Hkv, D), "len"} with "len" on the host; ``extend``
writes it in place, as ``LM.extend`` does.

Under tensor parallelism (``tp``) the serving steps run on this rank's
shards of the params and of the cache, as ``tp.cache_specs`` places it:
the cross K/V are seeded in their placement (this rank's kv heads, or its
slice of the source positions where the model axis does not divide the kv
heads), and the cross-attention attends them heads-sharded, or every head
over the rank's source positions with the partials merged over the model
axis (``TensorParallel.merge``).

``remat`` (the reference's field, which its scan leaves unused) recomputes
each decoder layer of ``forward`` in the backward pass, and
``remat_policy`` picks what is kept, as in ``LM``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (cached_step, gqa_cached, gqa_full, init_gqa, sdpa, sdpa_lse,
                        step_rope)
from .common import dense_init, embed_init, init_rms, rms_norm, rope_tables, rotate
from .ffn import dense_ffn, init_dense_ffn
from .transformer import layer_views, remat_call


def _init_cross(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype,
                device) -> dict:
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, n_layers
    return {
        "wq": dense_init(gen, (L, d, cfg.num_heads * hd), dtype, device),
        "wk": dense_init(gen, (L, d, cfg.num_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, (L, d, cfg.num_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, (L, cfg.num_heads * hd, d), dtype, device),
    }


def _cross_kv(p, enc_out, cfg: ModelConfig):
    """One decoder layer's cross-attention K and V (B, S_src, Hkv, D)."""
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ p["wk"]).reshape(B, T, cfg.num_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(B, T, cfg.num_kv_heads, hd)
    return k, v


def _cross_attend(p, x, ck, cv, cfg: ModelConfig):
    """Cross-attention of x (B, S, d) over every encoder position."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    mask = torch.ones((B, S, ck.shape[1]), dtype=torch.bool, device=x.device)
    return sdpa(q, ck, cv, mask).reshape(B, S, -1) @ p["wo"]


def _plain(x, w, name=None):
    return x @ w


def _cross_kv_tp(p, enc_out, cfg: ModelConfig, tp, ck_local):
    """One decoder layer's cross K and V in the placement of ``ck_local``
    (this rank's (B, S_src', Hkv', D) leaf): its kv heads, or its slice of
    the source positions of every kv head, or all of it."""
    B, T, _ = enc_out.shape
    hd, Hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    heads = tp.heads(cfg)
    split = ck_local.shape[2] != Hkv
    part = (heads[2] * hd, heads[3] * hd) if split else None
    k, v = (tp.column(_plain, enc_out, p[w], Hkv * hd, part).reshape(B, T, -1, hd)
            for w in ("wk", "wv"))
    n = ck_local.shape[1]
    if n != T:  # a time shard: this rank's source positions
        k, v = k[:, tp.index * n:(tp.index + 1) * n], v[:, tp.index * n:(tp.index + 1) * n]
    return k, v


def _cross_attend_tp(p, x, ck, cv, cfg: ModelConfig, tp, time_sharded: bool):
    """Cross-attention of x (B, S, d) over this rank's cross cache: its kv
    heads by its query heads; or every kv head of its source positions (or
    of all of them) by every query head, a time shard's partials merged
    over the model axis, this rank's heads kept for ``wo``'s row shard."""
    B, S, _ = x.shape
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    heads = tp.heads(cfg)
    whole = ck.shape[2] == cfg.num_kv_heads
    part = None if whole or heads is None else (heads[0] * hd, heads[1] * hd)
    q = tp.column(_plain, x, p["wq"], H * hd, part).reshape(B, S, -1, hd)
    mask = torch.ones((B, S, ck.shape[1]), dtype=torch.bool, device=x.device)
    if time_sharded:
        out = tp.merge(*sdpa_lse(q, ck, cv, mask))
    else:
        out = sdpa(q, ck, cv, mask)
    if whole:
        out = tp.own_heads(out, cfg)
    return tp.out_proj(_plain, out.reshape(B, S, -1), p["wo"], cfg)


def _attend_tp(p, x, kv_x, cfg: ModelConfig, tp, rope=None):
    """Bidirectional attention of x (B, S, d) over kv_x (B, T, d), or over
    itself where ``kv_x`` is None, on this rank's heads (``tp.qkv``): q and
    k rotated by ``rope`` where given (the encoder's self-attention;
    cross-attention has none), the o projection completed over the model
    axis."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    (q, k, v), (hq, hk) = tp.qkv(_plain, p, x, cfg, kv_x=kv_x)
    q, k = q.reshape(B, S, hq, hd), k.reshape(B, -1, hk, hd)
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    mask = torch.ones((B, S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = sdpa(q, k, v.reshape(B, -1, hk, hd), mask).reshape(B, S, -1)
    return tp.out_proj(_plain, out, p["wo"], cfg)


@dataclasses.dataclass
class EncDecLM:
    cfg: ModelConfig
    dtype: torch.dtype = torch.bfloat16  # the reference's default
    device: torch.device | str | None = None  # None: the card, raising without one
    remat: bool = False  # recompute each decoder layer of forward in the backward
    remat_policy: str = "full"  # or "dots": keep the matrix products
    # tensor parallelism over a mesh's model axis (``forward`` on local
    # shards): a distributed.tensor_parallel.TensorParallel
    tp: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------ init
    def init_params(self, gen: torch.Generator) -> dict:
        """Random weights drawn from ``gen`` and placed on the model's
        device (see ``LM.init_params``)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        n_enc, n_dec, d = cfg.encoder_layers, cfg.num_layers, cfg.d_model

        def norms(L, *names):
            return {n: torch.zeros((L, d), dtype=dt, device=dev) for n in names}

        return {
            "encoder": {"attn": init_gqa(gen, cfg, n_enc, dt, dev),
                        "ffn": init_dense_ffn(gen, n_enc, d, cfg.d_ff, dt, dev),
                        **norms(n_enc, "norm1", "norm2")},
            "decoder": {"attn": init_gqa(gen, cfg, n_dec, dt, dev),
                        "cross": _init_cross(gen, cfg, n_dec, dt, dev),
                        "ffn": init_dense_ffn(gen, n_dec, d, cfg.d_ff, dt, dev),
                        **norms(n_dec, "norm1", "norm_c", "norm2")},
            "embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
            "lm_head": dense_init(gen, (d, cfg.vocab_size), dt, dev),
            "enc_norm": init_rms(d, dt, dev),
            "final_norm": init_rms(d, dt, dev),
        }

    # ------------------------------------------------------------------ LoRA
    def lora_dims(self) -> dict[str, tuple[int, int]]:
        """The decoder's self-attention q/k/v/o (every one of them, whatever
        ``cfg.lora.targets`` says, as in the reference)."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        return {
            "q": (d, cfg.num_heads * hd),
            "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd),
            "o": (cfg.num_heads * hd, d),
        }

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

    # ---------------------------------------------------------------- encode
    def encode(self, params, frames) -> torch.Tensor:
        """frames (B, S_src, d_model), the frontend's embeddings -> the
        normed encoder output (B, S_src, d_model)."""
        cfg, dev = self.cfg, self.device
        x = torch.as_tensor(frames).to(dev, self.dtype)
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        rope = rope_tables(torch.arange(S, device=dev), hd, cfg.rope_theta)
        mask = torch.ones((1, S, S), dtype=torch.bool, device=dev)  # bidirectional
        for lp in layer_views(params["encoder"], cfg.encoder_layers):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if self.tp is not None:
                x = x + _attend_tp(lp["attn"], h, None, cfg, self.tp, rope)
            else:
                q = (h @ lp["attn"]["wq"]).reshape(B, S, cfg.num_heads, hd)
                k = (h @ lp["attn"]["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
                v = (h @ lp["attn"]["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
                o = sdpa(rotate(q, *rope), rotate(k, *rope), v, mask)
                x = x + o.reshape(B, S, -1) @ lp["attn"]["wo"]
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + dense_ffn(lp["ffn"], h2, cfg.activation)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _ids(self, adapter_ids):
        if adapter_ids is None:
            return None
        return torch.as_tensor(adapter_ids).to(self.device, torch.int32,
                                               non_blocking=True)

    def _embed(self, params, tokens):
        tokens = torch.as_tensor(tokens).to(self.device, torch.int64, non_blocking=True)
        if self.tp is not None:
            return self.tp.embed(params["embed"], tokens, self.cfg.vocab_size).to(self.dtype)
        return params["embed"][tokens].to(self.dtype)

    def _unembed(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.tp is not None:
            return self.tp.logits(x, params["lm_head"], self.cfg.vocab_size,
                                  transposed=False)
        return x @ params["lm_head"]

    # ----------------------------------------------------------------- train
    def forward(self, params, frames, tokens, *, lora=None, adapter_ids=None):
        """Teacher-forced decode over the whole target ``tokens`` (B, S):
        returns (logits (B, S, vocab), aux = 0). Under ``tp`` the params
        are this rank's shards, every attention (the encoder's, the
        decoder's self- and cross-attention) runs on the rank's heads, and
        the logits are whole."""
        cfg, dev = self.cfg, self.device
        if self.tp is not None:
            params, lora = self.tp.prepare(params, lora, cfg)
        enc_out = self.encode(params, frames)
        x = self._embed(params, tokens)
        S = x.shape[1]
        rope = step_rope(cfg, torch.arange(S, device=dev))
        ids = self._ids(adapter_ids)

        def layer(lp, lsl, x, enc_out):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            mixed, _ = gqa_full(lp["attn"], h, rope, cfg, lora=lsl, adapter_ids=ids,
                                lora_scale=self.lora_scale, tp=self.tp)
            x = x + mixed
            hc = rms_norm(x, lp["norm_c"], cfg.norm_eps)
            if self.tp is not None:
                x = x + _attend_tp(lp["cross"], hc, enc_out, cfg, self.tp)
            else:
                x = x + _cross_attend(lp["cross"], hc,
                                      *_cross_kv(lp["cross"], enc_out, cfg), cfg)
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            return x + dense_ffn(lp["ffn"], h2, cfg.activation)

        remat = self.remat and torch.is_grad_enabled()
        for lp, lsl in zip(layer_views(params["decoder"], cfg.num_layers),
                           layer_views(lora or None, cfg.num_layers)):
            x = (remat_call(layer, self.remat_policy, lp, lsl, x, enc_out) if remat
                 else layer(lp, lsl, x, enc_out))
        return self._unembed(params, x), torch.zeros((), dtype=torch.float32, device=dev)

    # ---------------------------------------------------------------- caches
    def init_cache(self, batch: int, max_len: int, src_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        hd, L, Hkv = cfg.resolved_head_dim, cfg.num_layers, cfg.num_kv_heads

        def zeros(T):
            return torch.zeros((L, batch, T, Hkv, hd), dtype=self.dtype, device=dev)

        return {"k": zeros(max_len), "v": zeros(max_len), "ck": zeros(src_len),
                "cv": zeros(src_len),
                "len": torch.zeros((batch,), dtype=torch.int32)}  # host side

    def prefill(self, params, frames, tokens, max_len: int, *, lora=None,
                adapter_ids=None, cache=None):
        """Encode, seed the cross K/V, then prefill the target prefix
        ``tokens`` (B, S) into a cache of ``max_len`` positions: returns
        (last-token logits (B, 1, vocab), cache). ``cache``: a zero cache
        to fill instead of a new one (under ``tp``, this rank's shards of
        one)."""
        tp = self.tp
        if tp is not None:
            params, lora = tp.prepare(params, lora, self.cfg)
        enc_out = self.encode(params, frames)
        B, S = torch.as_tensor(tokens).shape
        if S > max_len:
            raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
        if cache is None:
            cache = self.init_cache(B, max_len, enc_out.shape[1])
        for i, lp in enumerate(layer_views(params["decoder"]["cross"],
                                           self.cfg.num_layers)):
            if tp is None:
                ck, cv = _cross_kv(lp, enc_out, self.cfg)
            else:
                ck, cv = _cross_kv_tp(lp, enc_out, self.cfg, tp, cache["ck"][i])
            cache["ck"][i] = ck
            cache["cv"][i] = cv
        return self._extend(params, cache, tokens, torch.zeros((B,), dtype=torch.int32),
                            lora=lora, adapter_ids=adapter_ids)

    def extend(self, params, cache, tokens, start, *, lora=None, adapter_ids=None):
        """Write ``tokens`` (B, S) at per-row offsets ``start`` (host-side)
        and return the last position's logits (B, 1, vocab) and the cache,
        updated in place with ``len`` = start + S."""
        if self.tp is not None:
            params, lora = self.tp.prepare(params, lora, self.cfg)
        return self._extend(params, cache, tokens, start, lora=lora,
                            adapter_ids=adapter_ids)

    def _extend(self, params, cache, tokens, start, *, lora=None, adapter_ids=None):
        """``extend`` on params (and LoRA) ready for the forward: under
        ``tp``, prepared."""
        cfg, dev, tp = self.cfg, self.device, self.tp
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        T, shard = cache["k"].shape[2], None
        cross_sharded = False
        if tp is not None:
            shard = tp.time_shard("k", T)
            T = T if shard is None else T * tp.size
            cross_sharded = tp.time_shard("ck", cache["ck"].shape[2]) is not None
        step = cached_step(start, S, T, dev, cfg, shard=shard)
        ids = self._ids(adapter_ids)
        L = cfg.num_layers
        for i, (lp, lsl) in enumerate(zip(layer_views(params["decoder"], L),
                                          layer_views(lora or None, L))):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            x = x + gqa_cached(lp["attn"], h, step, cache["k"][i], cache["v"][i], cfg,
                               lora=lsl, adapter_ids=ids, lora_scale=self.lora_scale,
                               tp=tp)
            hc = rms_norm(x, lp["norm_c"], cfg.norm_eps)
            if tp is None:
                x = x + _cross_attend(lp["cross"], hc, cache["ck"][i], cache["cv"][i], cfg)
            else:
                x = x + _cross_attend_tp(lp["cross"], hc, cache["ck"][i], cache["cv"][i],
                                         cfg, tp, cross_sharded)
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + dense_ffn(lp["ffn"], h2, cfg.activation)
        start_h = torch.as_tensor(start).to("cpu", torch.int64)
        cache["len"] = (start_h + S).to(torch.int32)
        return self._unembed(params, x[:, -1:, :]), cache

    def decode(self, params, cache, tokens, *, lora=None, adapter_ids=None):
        """One-token decode step: ``tokens`` (B, 1) at ``cache["len"]``."""
        return self.extend(params, cache, tokens, cache["len"], lora=lora,
                           adapter_ids=adapter_ids)
