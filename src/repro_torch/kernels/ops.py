"""Public wrappers for the hand-written kernels, and their launch counts.

Dispatch is by device: a tensor on the CPU takes the kernel's plain
PyTorch version (``kernels/ref.py``); a CUDA tensor launches the kernel,
built at first use by ``kernels/build.py``, or raises. Nothing falls back.

``fused_sgmv`` and ``flash_prefill``, the kernels of the training path,
are differentiable on either device: an autograd Function whose backward is
a hand-written kernel on the card (``lora_grad``, ``flash_prefill_bwd``,
counted as their own launches) and the plain backward
(``ref.fused_sgmv_bwd_ref``, ``ref.flash_prefill_bwd_ref``) on the CPU. The
serving-only kernels (``sgmv``, ``ragged_extend``, ``paged_attention``,
``flash_prefill_ragged``) have no backward: on the card, a call under
autograd with an input that requires grad raises ``NotImplementedError``.
"""

from __future__ import annotations

from . import build, ref
from .flash_prefill import (flash_prefill, flash_prefill_bwd, flash_prefill_fwd,
                            flash_prefill_ragged)
from .paged_attention import paged_attention
from .ragged_extend import ragged_extend
from .sgmv import fused_sgmv, fused_sgmv_bwd, lora_grad, sgmv


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: build.launches[name] for name in build.KERNELS}


def path_launch_counts() -> dict[str, dict[str, int]]:
    """Launches of each tile loop of the kernels that have more than one
    (``build.PATHS``: bf16 ``flash_prefill``, ``flash_prefill_ragged`` and
    ``ragged_extend`` on ``wgmma`` or ``mma``; ``fused_sgmv`` on ``wgmma``
    (bf16), ``mma``, ``skinny`` or ``cluster`` (bf16); ``paged_attention``
    on ``split`` (bf16)
    or ``chunk``) since the last :func:`reset_launch_counts`."""
    return {name: {path: build.path_launches[name, path] for path in paths}
            for name, paths in build.PATHS.items()}


def reset_launch_counts() -> None:
    build.launches.clear()
    build.path_launches.clear()


__all__ = [
    "flash_prefill",
    "flash_prefill_bwd",
    "flash_prefill_fwd",
    "flash_prefill_ragged",
    "fused_sgmv",
    "fused_sgmv_bwd",
    "launch_counts",
    "lora_grad",
    "paged_attention",
    "path_launch_counts",
    "ragged_extend",
    "ref",
    "reset_launch_counts",
    "sgmv",
]
