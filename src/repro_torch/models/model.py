"""Model facade (PyTorch counterpart of ``repro.models.model``): the
decoder LM (dense GQA, MLA and MoE, with int8 KV as an option) and its
static-batch prefill and decode steps; training steps are ROADMAP Queue 1
item 5, the recurrent and encoder-decoder layouts items 3 and 4."""

from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from .transformer import LM


def build_model(cfg: ModelConfig, dtype=torch.float32, device=None,
                kv_quant: bool = False) -> LM:
    """The decoder LM for ``cfg`` on ``device`` (default: the card, raising
    without one), with an int8 KV cache under ``kv_quant``; the recurrent
    and encoder-decoder families raise ``NotImplementedError`` naming their
    ROADMAP item."""
    return LM(cfg, dtype=dtype, device=device, kv_quant=bool(kv_quant))


def make_prefill_step(model: LM) -> Callable:
    """prefill_step(params, lora, batch) -> (last-token logits, cache): a
    fresh prefill of ``batch["tokens"]`` (B, S) into a cache of exactly S
    positions, with ``batch.get("adapter_ids")`` (B,), and the batch's
    ``extra_embeds`` and ``mrope_positions`` where it has them."""

    def prefill_step(params, lora, batch):
        return model.prefill(params, batch["tokens"],
                             max_len=batch["tokens"].shape[1], lora=lora,
                             adapter_ids=batch.get("adapter_ids"),
                             extra_embeds=batch.get("extra_embeds"),
                             mrope_positions=batch.get("mrope_positions"))

    return prefill_step


def make_decode_step(model: LM) -> Callable:
    """decode_step(params, lora, cache, batch) -> (next tokens (B,) int32,
    cache): one greedy token per row against the cache, which is updated in
    place."""

    def decode_step(params, lora, cache, batch):
        logits, cache = model.decode(params, cache, batch["tokens"], lora=lora,
                                     adapter_ids=batch.get("adapter_ids"))
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return decode_step
