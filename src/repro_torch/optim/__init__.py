"""Optimizer substrate (PyTorch counterpart of ``repro.optim``): AdamW with
f32 moments, global-norm clipping, a cosine schedule and the LoRA-only
mask for adapter fine-tuning, on trees of tensors.

``models.make_train_step`` runs ``clip_by_global_norm`` and
``adamw_update`` without a mask: for LoRA-only training it hands them the
adapters' subtree alone, as the reference's step does, so the frozen base
carries no moments. ``mask=``, ``lora_only_mask``, ``apply_updates`` and
``cosine_schedule`` complete the reference's optimizer API for a caller
that keeps one state over the whole tree or schedules its rate; nothing in
the port calls them, and ``tests/test_torch_train.py`` holds them to the
reference."""

from .adamw import (
    OptState,
    adamw_init,
    adamw_update,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    lora_only_mask,
)

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "apply_updates",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "lora_only_mask",
]
