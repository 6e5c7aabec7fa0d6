"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their plain
PyTorch versions; see ``kernels/ops.py``."""

from . import ref
from .ops import (
    fused_sgmv,
    launch_counts,
    paged_attention,
    ragged_extend,
    reset_launch_counts,
)

__all__ = [
    "fused_sgmv",
    "launch_counts",
    "paged_attention",
    "ragged_extend",
    "ref",
    "reset_launch_counts",
]
