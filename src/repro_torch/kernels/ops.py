"""Public wrappers for the hand-written kernels, and their launch counts.

Dispatch is by device: a tensor on the CPU takes the kernel's plain
PyTorch version (``kernels/ref.py``); a CUDA tensor launches the kernel,
built at first use by ``kernels/build.py``, or raises. Nothing falls back.
"""

from __future__ import annotations

from . import build, ref
from .paged_attention import paged_attention
from .ragged_extend import ragged_extend
from .sgmv import fused_sgmv


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: build.launches[name] for name in build.KERNELS}


def reset_launch_counts() -> None:
    build.launches.clear()


__all__ = [
    "fused_sgmv",
    "launch_counts",
    "paged_attention",
    "ragged_extend",
    "ref",
    "reset_launch_counts",
]
