"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their plain
PyTorch versions; see ``kernels/ops.py``. ``counting`` holds the
reference's analytic traffic counters, the port's tiles, each kernel's
least work and its bound on the H100."""

from . import counting, ref
from .ops import (
    flash_prefill,
    flash_prefill_bwd,
    flash_prefill_fwd,
    flash_prefill_ragged,
    fused_sgmv,
    fused_sgmv_bwd,
    launch_counts,
    lora_grad,
    paged_attention,
    ragged_extend,
    reset_launch_counts,
    sgmv,
)

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
    "ragged_extend",
    "ref",
    "reset_launch_counts",
    "sgmv",
    "counting",
]
