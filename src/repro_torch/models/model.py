"""Model facade (PyTorch counterpart of ``repro.models.model``): every
layout the reference builds — the decoder LM (dense GQA, MLA, MoE, RWKV-6
and the RG-LRU hybrid, with int8 KV as an option) and the encoder-decoder
LM — and their step functions: the train step (full-parameter or
LoRA-only, AdamW), and the static-batch prefill and decode steps.

The train step is the reference's: loss = cross-entropy + moe_aux_weight
· the MoE auxiliary loss, gradients clipped to a global norm, AdamW with
decoupled weight decay, metrics the cross-entropy and the norm before
clipping. Gradients come from ``torch.autograd``: on the card through the
kernels' autograd Functions (``fused_sgmv`` with ``lora_grad``,
``flash_prefill`` with ``flash_prefill_bwd``), on the CPU through their
plain backward versions. PyTorch runs eagerly: the step is a plain
function, nothing is jitted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..optim import OptState, adamw_init, adamw_update, clip_by_global_norm
from ..tree import leaves, unflatten
from .encdec import EncDecLM
from .transformer import LM


def build_model(cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                kv_quant: bool = False, remat: bool = False, q_chunk: int = 0,
                remat_policy: str = "full") -> LM | EncDecLM:
    """The model for ``cfg`` on ``device`` (default: the card, raising
    without one), in ``dtype`` (bfloat16 by default, as the reference's
    ``build_model``): ``EncDecLM`` for an encoder-decoder config, else the
    decoder ``LM``, with an int8 KV cache under ``kv_quant``. ``remat``,
    ``remat_policy`` and ``q_chunk`` are the reference's training knobs
    (see ``LM``; the encoder-decoder takes the first two)."""
    if cfg.is_encdec:
        return EncDecLM(cfg, dtype=dtype, device=device, remat=remat,
                        remat_policy=remat_policy)
    return LM(cfg, dtype=dtype, device=device, kv_quant=bool(kv_quant), remat=remat,
              q_chunk=q_chunk, remat_policy=remat_policy)


def cross_entropy(logits: torch.Tensor, labels, ignore: int = -1,
                  count=None) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not ``ignore``
    (0 without any); ``count`` replaces the number of those positions in
    the mean (a data-parallel shard divides by the whole batch's count).
    The reference writes it as logsumexp minus a one-hot contraction so
    that GSPMD keeps the vocab sharded; on one card a gather gives the same
    value."""
    labels = torch.as_tensor(labels).to(logits.device, torch.int64)
    valid = labels != ignore
    safe = torch.where(valid, labels, 0)
    x = logits.float()
    nll = torch.logsumexp(x, dim=-1) - torch.gather(x, -1, safe[..., None])[..., 0]
    n = valid.sum() if count is None else count
    return torch.where(valid, nll, 0.0).sum() / n.clamp_min(1)


def forward_logits(model: LM | EncDecLM, params, lora, batch: dict):
    """(logits, MoE aux loss) of a train batch (see ``make_train_step``)."""
    if model.cfg.is_encdec:
        return model.forward(params, batch["frames"], batch["tokens"], lora=lora,
                             adapter_ids=batch.get("adapter_ids"))
    return model.forward(params, batch["tokens"], lora=lora,
                         adapter_ids=batch.get("adapter_ids"),
                         extra_embeds=batch.get("extra_embeds"),
                         mrope_positions=batch.get("mrope_positions"))


def value_and_grads(tree, fn):
    """``fn(tree)`` with the leaves of ``tree`` made differentiable, and
    the gradients of its first output, one a leaf in walking order (zeros
    for a leaf it does not reach)."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in leaves(tree)]
        out = fn(unflatten(tree, live))
        grads = torch.autograd.grad(out[0], live, allow_unused=True)
    return out, [torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]


@dataclasses.dataclass
class TrainState:
    params: Any
    lora: Any
    opt: OptState
    step: torch.Tensor  # () int32, on the host


# the reference's train-step settings: make_train_step's defaults, and the
# sharded step's constants
WEIGHT_DECAY, CLIP_NORM, MOE_AUX_WEIGHT = 0.1, 1.0, 0.01


def make_train_step(model: LM | EncDecLM, *, lr: float = 3e-4,
                    weight_decay: float = WEIGHT_DECAY, clip_norm: float = CLIP_NORM,
                    moe_aux_weight: float = MOE_AUX_WEIGHT,
                    train_lora_only: bool = False) -> Callable:
    """train_step(state, batch) -> (new state, {"loss", "grad_norm"}).

    ``batch``: {"tokens" (B, S) int, "labels" (B, S) int, "adapter_ids"
    (B,) int, and "frames" (B, S_src, d) for an encoder-decoder model,
    "extra_embeds" / "mrope_positions" where the config takes them}. The
    trainable tree is {"params", "lora"}, or {"lora"} alone under
    ``train_lora_only``, when the base weights are frozen: they do not
    require grad, so no gradient of them is formed (``fused_sgmv`` skips
    dW). The new state holds new tensors; the old one is left as it was."""

    def loss_fn(tree, state, batch):
        params = state.params if train_lora_only else tree["params"]
        logits, aux = forward_logits(model, params, tree["lora"], batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce + moe_aux_weight * aux, ce

    def train_step(state: TrainState, batch: dict):
        trainable = ({"lora": state.lora} if train_lora_only
                     else {"params": state.params, "lora": state.lora})
        (_, ce), grads = value_and_grads(trainable, lambda tr: loss_fn(tr, state, batch))
        grads, gnorm = clip_by_global_norm(unflatten(trainable, grads), clip_norm)
        new, opt = adamw_update(grads, state.opt, trainable, lr,
                                weight_decay=weight_decay)
        new_state = TrainState(params=new.get("params", state.params),
                               lora=new.get("lora", state.lora), opt=opt,
                               step=state.step + 1)
        return new_state, {"loss": ce.detach(), "grad_norm": gnorm}

    return train_step


def make_train_state(model: LM | EncDecLM, gen: torch.Generator,
                     n_lora_slots: int = 0, train_lora_only: bool = False) -> TrainState:
    """Weights from ``gen`` (``init_params``, then ``init_lora`` of
    ``n_lora_slots`` slots where > 0), zero AdamW moments for the trainable
    tree, step 0."""
    params = model.init_params(gen)
    lora = model.init_lora(gen, n_lora_slots) if n_lora_slots else None
    opt = adamw_init({"lora": lora} if train_lora_only
                     else {"params": params, "lora": lora})
    return TrainState(params=params, lora=lora, opt=opt,
                      step=torch.zeros((), dtype=torch.int32))


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
