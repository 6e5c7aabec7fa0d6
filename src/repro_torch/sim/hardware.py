"""Accelerator timing model for the discrete-event simulator.

Constants follow the paper's platform (Table 1): NPU with 256 TFLOPS fp16 /
64 GB HBM per card, PCIe 4.0 ×16 host link, Arm host with 256 GB. The same
dataclass can be pointed at TPU v5e (197 TFLOP/s bf16, 16 GB, 819 GB/s) for
the roofline cross-checks.

Timing formulas (standard serving roofline):
  prefill:  t = max(2·N_active·T / (F·mfu),  attn flops)  — compute-bound
  decode:   t = max(weight+KV bytes / HBM_bw, 2·N_active·B / F) + overhead
Multi-card tensor parallelism divides FLOPs/bandwidth by ``cards`` and adds
a per-layer collective latency.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig


@dataclasses.dataclass
class NPUSpec:
    flops_fp16: float = 256e12  # per card
    hbm_bytes: int = 64 * 1024**3  # per card
    hbm_bw: float = 1.6e12  # per card
    # effective host<->device copy bandwidth. Raw PCIe4 x16 is ~26 GB/s but
    # the paper's Fig. 12 cold-start magnitudes (~230 ms for ~0.3 GB KV
    # prefixes) imply ~2 GB/s effective (unpinned torch.Tensor copies); we
    # calibrate to that so breakdowns are comparable (EXPERIMENTS.md §Fig12).
    pcie_bw: float = 2e9
    pcie_latency: float = 10e-6
    host_bytes: int = 256 * 1024**3
    prefill_mfu: float = 0.55
    decode_overhead: float = 0.004  # scheduler+dispatch per iteration (s)
    tp_collective_latency: float = 15e-6  # per layer per iteration
    dtype_bytes: int = 2


@dataclasses.dataclass
class DeployedModel:
    cfg: ModelConfig
    cards: int = 1
    npu: NPUSpec = dataclasses.field(default_factory=NPUSpec)

    @property
    def param_bytes(self) -> int:
        return self.cfg.num_params() * self.npu.dtype_bytes

    @property
    def active_param_bytes(self) -> int:
        return self.cfg.active_params() * self.npu.dtype_bytes

    @property
    def kv_bytes_per_token(self) -> int:
        return self.cfg.kv_bytes_per_token(self.npu.dtype_bytes)

    @property
    def is_recurrent(self) -> bool:
        return self.cfg.rwkv is not None or self.cfg.rglru is not None

    @property
    def state_snapshot_bytes(self) -> int:
        """Bytes of one full-model recurrent-state snapshot (0 for attention
        archs) at the deployment dtype — the STATE-node payload size."""
        if not self.is_recurrent:
            return 0
        from ..kvcache.state_cache import state_floats

        return state_floats(self.cfg) * self.npu.dtype_bytes

    def hbm_pool_bytes(self, activation_reserve: float = 0.1) -> int:
        """HBM available for the unified LoRA+KV pool after weights."""
        total = self.npu.hbm_bytes * self.cards
        reserve = int(total * activation_reserve)
        pool = total - self.param_bytes - reserve
        if pool <= 0:
            raise ValueError(
                f"{self.cfg.name} does not fit on {self.cards} card(s)"
            )
        return pool

    # ----------------------------------------------------------------- time
    def prefill_time(self, new_tokens: int, ctx_tokens: int) -> float:
        """Compute time to prefill ``new_tokens`` given ``ctx_tokens`` of
        already-cached context (attention still spans the full context)."""
        if new_tokens <= 0:
            return 0.0
        n = self.cfg.active_params()
        flops = 2.0 * n * new_tokens
        # causal attention over the full context
        d = self.cfg.d_model
        flops += 4.0 * d * new_tokens * (ctx_tokens + new_tokens / 2)
        f = self.npu.flops_fp16 * self.cards * self.npu.prefill_mfu
        t = flops / f
        t += self.cfg.num_layers * self.npu.tp_collective_latency * (self.cards > 1)
        return t

    def decode_time(self, batch: int, total_ctx_tokens: int) -> float:
        """One decode iteration for ``batch`` sequences with a combined
        context of ``total_ctx_tokens`` tokens."""
        if batch <= 0:
            return 0.0
        bw = self.npu.hbm_bw * self.cards
        f = self.npu.flops_fp16 * self.cards
        mem = (self.active_param_bytes + total_ctx_tokens * self.kv_bytes_per_token) / bw
        comp = 2.0 * self.cfg.active_params() * batch / f
        t = max(mem, comp) + self.npu.decode_overhead
        t += self.cfg.num_layers * self.npu.tp_collective_latency * (self.cards > 1)
        return t

    def transfer_time(self, nbytes: int) -> float:
        return self.npu.pcie_latency + nbytes / self.npu.pcie_bw
