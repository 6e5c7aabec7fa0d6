"""Shape-and-dtype stand-ins for every (arch × shape) dry-run cell
(PyTorch counterpart of ``repro.launch.specs``).

No allocation: the params / LoRA / train state / cache trees are built by
the model's own init functions under ``FakeTensorMode`` (the counterpart of
``jax.eval_shape``) and handed out as tensors on ``torch.device("meta")``;
batches are meta tensors made directly. Modality frontends are stubs, as
in the reference: seamless gets precomputed frame embeddings, qwen2-vl
patch-embedding ``extra_embeds`` plus M-RoPE position ids.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import build_model, make_train_state
from ..tree import leaves, unflatten

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape: ShapeConfig, n_lora: int = 8) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("decode", "long_decode"):
        batch = {"tokens": _meta((B, 1), torch.int32),
                 "adapter_ids": _meta((B,), torch.int32)}
        if cfg.mrope_sections is not None:
            batch["mrope_positions"] = _meta((3, B, 1), torch.int32)
        return batch
    batch = {"tokens": _meta((B, S), torch.int32), "adapter_ids": _meta((B,), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.is_encdec:
        batch["frames"] = _meta((B, S // 4, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision":
        batch["extra_embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        batch["mrope_positions"] = _meta((3, B, S), torch.int32)
    return batch


def _on_meta(fn):
    """``fn()``'s tree of tensors, traced without allocating, as meta
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        tree = fn()
    return unflatten(tree, [_meta(t.shape, t.dtype) for t in leaves(tree)])


def model_state_specs(cfg: ModelConfig, shape: ShapeConfig, n_lora: int = 8) -> dict:
    """Meta trees of the cell: {"model", "train_state"} for a train cell,
    else {"model", "params", "lora"} and, for decode, "cache"."""
    model = build_model(cfg, dtype=torch.bfloat16, device=META,
                        remat=(shape.kind == "train"))
    gen = torch.Generator().manual_seed(0)
    out: dict = {"model": model}
    if shape.kind == "train":
        out["train_state"] = _on_meta(lambda: make_train_state(model, gen, n_lora))
        return out
    out["params"] = _on_meta(lambda: model.init_params(gen))
    out["lora"] = _on_meta(lambda: model.init_lora(gen, n_lora))
    if shape.kind in ("decode", "long_decode"):
        B, S = shape.global_batch, shape.seq_len
        if cfg.is_encdec:
            out["cache"] = _on_meta(lambda: model.init_cache(B, S, src_len=max(1, S // 4)))
        else:
            out["cache"] = _on_meta(lambda: model.init_cache(B, S))
    return out


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
