"""The simulator's hardware model for the card the port runs on.

:func:`h100_spec` builds an :class:`~repro_torch.sim.hardware.NPUSpec` for
one NVIDIA H100, so that ``ServingSimulator`` can price a trace the way
the port would serve it there. Every field names its origin. The card is
the one ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
printed as :data:`CARD`; the measured numbers are the ones
``python3 chip_smoke.py`` printed on it in one run (its ``link`` phase, 2b,
and its ``h100_spec`` line, which prints a run's values beside these).

- Peak rates: the bf16 dense tensor-core rate and the memory rate that
  ``kernels.counting`` holds for the kernels' bounds.
- The host link: the rate and fixed cost of the port's own swap path,
  ``PagedKVPool.swap_in`` (pinned host blocks, ``non_blocking`` copies),
  fitted as ``t = latency + bytes / rate`` over swaps of 1, 8 and 64 KV
  blocks of the engine's qwen3-0.6b f32 layout, in a process that has not
  pinned host memory before, as an engine starts. The same run measured
  ``swap_out`` at 49.83 GB/s and 20.3 µs, and ``AdapterStore.load`` at
  53.39 GB/s and 331.8 µs (the host's enqueue of its 8 strided copies).
- ``prefill_mfu`` and ``decode_overhead`` describe the port as it was
  measured (llama-7b in bf16 on the static path), not the card's limit:
  a faster port moves them.

The engine does not read this spec: its swap-cost model keeps the
reference's defaults (``core/cost_model.py``), as the reference's engine
does.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig
from ..kernels.counting import BF16_FLOPS, HBM_BYTES_PER_S
from .hardware import DeployedModel, NPUSpec

# nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# torch.cuda.get_device_properties(0).total_memory on CARD
HBM_BYTES = 85_017_493_504
# the host's MemTotal on CARD's machine (chip_smoke.host_mem_total)
HOST_BYTES = 108_447_924_224
# PagedKVPool.swap_in, host -> device: the fit over 1, 8 and 64 blocks
# (0.0953, 0.5993 and 4.7647 ms a call)
SWAP_IN_BYTES_PER_S = 49.448380458049324e9
SWAP_IN_LATENCY_S = 13.777126158986297e-6
# llama-7b bf16, 2 x 512 prompt tokens prefilled in 0.06299 s (chip_smoke
# phase 9): 2·active_params·tokens / (s · BF16_FLOPS)
PREFILL_MFU = 0.22152894192533207
# the same run's 34.37 ms a decode step (B = 2, ~1088 tokens of context)
# less the simulator's own time for it, 4.19 ms: the host's share. Its
# three further windows of 8 steps gave 27.6, 32.3 and 25.6 ms; two other
# runs on the same card type 41.0 and 31.2 (windows 29.9 to 44.4)
DECODE_OVERHEAD_S = 0.03018110778104613


def h100_spec() -> NPUSpec:
    """One H100 as :data:`CARD` measured it. A multi-card deployment
    needs the collective latency, which is not measured here (0)."""
    return NPUSpec(
        flops_fp16=BF16_FLOPS,
        hbm_bytes=HBM_BYTES,
        hbm_bw=HBM_BYTES_PER_S,
        pcie_bw=SWAP_IN_BYTES_PER_S,
        pcie_latency=SWAP_IN_LATENCY_S,
        host_bytes=HOST_BYTES,
        prefill_mfu=PREFILL_MFU,
        decode_overhead=DECODE_OVERHEAD_S,
        tp_collective_latency=0.0,
        dtype_bytes=2,  # bf16, the port's default (models.build_model)
    )


def measured_prefill_mfu(cfg: ModelConfig, tokens: int, seconds: float) -> float:
    """The port's prefill efficiency: 2·active_params·tokens over the
    seconds at the bf16 peak."""
    return 2.0 * cfg.active_params() * tokens / (seconds * BF16_FLOPS)


def measured_decode_overhead(cfg: ModelConfig, batch: int, ctx_tokens: int,
                             seconds_per_step: float, spec: NPUSpec | None = None) -> float:
    """A measured decode step's seconds less the simulator's own time for
    it with no overhead (``DeployedModel.decode_time`` on ``spec``)."""
    npu = dataclasses.replace(spec or h100_spec(), decode_overhead=0.0)
    return seconds_per_step - DeployedModel(cfg, 1, npu).decode_time(batch, ctx_tokens)
