"""Model facade (PyTorch counterpart of ``repro.models.model``): every
layout the reference builds — the decoder LM (dense GQA, MLA, MoE, RWKV-6
and the RG-LRU hybrid, with int8 KV as an option) and the encoder-decoder
LM — and their static-batch prefill and decode steps; training steps are
ROADMAP Queue 1 item 5."""

from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from .encdec import EncDecLM
from .transformer import LM


def build_model(cfg: ModelConfig, dtype=torch.float32, device=None,
                kv_quant: bool = False) -> LM | EncDecLM:
    """The model for ``cfg`` on ``device`` (default: the card, raising
    without one): ``EncDecLM`` for an encoder-decoder config, else the
    decoder ``LM``, with an int8 KV cache under ``kv_quant``."""
    if cfg.is_encdec:
        return EncDecLM(cfg, dtype=dtype, device=device)
    return LM(cfg, dtype=dtype, device=device, kv_quant=bool(kv_quant))


def make_prefill_step(model: LM | EncDecLM) -> Callable:
    """prefill_step(params, lora, batch) -> (last-token logits, cache): a
    fresh prefill of ``batch["tokens"]`` (B, S) into a cache of exactly S
    positions, with ``batch.get("adapter_ids")`` (B,), and the batch's
    ``extra_embeds`` and ``mrope_positions`` where it has them; an
    encoder-decoder model first encodes ``batch["frames"]``."""
    if model.cfg.is_encdec:
        def prefill_step(params, lora, batch):
            return model.prefill(params, batch["frames"], batch["tokens"],
                                 max_len=batch["tokens"].shape[1], lora=lora,
                                 adapter_ids=batch.get("adapter_ids"))

        return prefill_step

    def prefill_step(params, lora, batch):
        return model.prefill(params, batch["tokens"],
                             max_len=batch["tokens"].shape[1], lora=lora,
                             adapter_ids=batch.get("adapter_ids"),
                             extra_embeds=batch.get("extra_embeds"),
                             mrope_positions=batch.get("mrope_positions"))

    return prefill_step


def make_decode_step(model: LM | EncDecLM) -> Callable:
    """decode_step(params, lora, cache, batch) -> (next tokens (B,) int32,
    cache): one greedy token per row against the cache, which is updated in
    place."""

    def decode_step(params, lora, cache, batch):
        logits, cache = model.decode(params, cache, batch["tokens"], lora=lora,
                                     adapter_ids=batch.get("adapter_ids"))
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return decode_step
