"""Dense decoder-only LM (PyTorch counterpart of the dense branch of
``repro.models.transformer.LM``).

Parameters keep the reference's pytree layout as nested dicts of tensors,
with the layers stacked on a leading axis, so :mod:`repro_torch.bridge`
maps one onto the other leaf by leaf:

  {"embed", "final_norm", ["lm_head"],
   "layers": {"norm1", "norm2",
              "mixer": {"wq", "wk", "wv", "wo", ["q_norm", "k_norm"]},
              "ffn": {"w_gate", "w_up", "w_down"}}}

Public surface (functions of the params, as in the reference):
  init_params(gen)                          -> params
  init_lora(gen, n_slots)                   -> stacked multi-LoRA params
  init_cache(batch, max_len)                -> dense decode cache
  extend(params, cache, tokens, start, ...) -> (logits, cache)
(``decode`` is ``extend`` at ``cache["len"]`` with one token per row.)

``extend`` updates the cache in place and returns it: only the real tokens
of kept rows are written, and ``len`` advances only for kept rows.
``cache["len"]`` is a host-side (CPU) int32 tensor, so planning a step never
waits on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import cached_step, check_supported, gqa_cached, init_gqa
from .common import dense_init, embed_init, init_rms, rms_norm
from .ffn import dense_ffn, init_dense_ffn


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked dict / tuple tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(layer_slice(v, i) for v in tree)
    return tree[i]


@dataclasses.dataclass
class LM:
    cfg: ModelConfig
    dtype: torch.dtype = torch.float32
    device: torch.device | str | None = None  # None: the card, raising without one

    def __post_init__(self):
        check_supported(self.cfg)
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
        params["layers"] = {
            "norm1": torch.zeros((L, cfg.d_model), dtype=dt, device=dev),
            "norm2": torch.zeros((L, cfg.d_model), dtype=dt, device=dev),
            "mixer": init_gqa(gen, cfg, L, dt, dev),
            "ffn": init_dense_ffn(gen, L, cfg.d_model, cfg.d_ff, dt, dev),
        }
        return params

    # ------------------------------------------------------------------ LoRA
    def lora_dims(self) -> dict[str, tuple[int, int]]:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
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
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "len": torch.zeros((batch,), dtype=torch.int32),  # host side
        }

    # ------------------------------------------------------------ embeddings
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.dtype)

    def _unembed(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["lm_head"]

    # ---------------------------------------------------------- layer bodies
    def _layer_cached(self, lp, lora_slice, cache_k, cache_v, x, step,
                      adapter_ids):
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + gqa_cached(lp["mixer"], h, step, cache_k, cache_v, cfg,
                           lora=lora_slice, adapter_ids=adapter_ids,
                           lora_scale=self.lora_scale)
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + dense_ffn(lp["ffn"], h2, cfg.activation)

    # ====================================================== extend / decode
    def extend(self, params, cache, tokens, start, *, lora=None,
               adapter_ids=None, all_logits=False, true_lens=None,
               keep_rows=None, logit_positions=None):
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
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(tokens)
        B, S = tokens.shape
        T = cache["k"].shape[2]
        step = cached_step(start, S, T, dev, cfg, true_lens=true_lens,
                           keep_rows=keep_rows)
        x = self._embed(params, tokens.to(dev, torch.int64, non_blocking=True))
        ids = None
        if adapter_ids is not None:
            ids = torch.as_tensor(adapter_ids).to(dev, torch.int32, non_blocking=True)
        lora = lora or {}
        for i in range(cfg.num_layers):
            x = self._layer_cached(layer_slice(params["layers"], i),
                                   layer_slice(lora, i) if lora else None,
                                   cache["k"][i], cache["v"][i], x, step, ids)
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

