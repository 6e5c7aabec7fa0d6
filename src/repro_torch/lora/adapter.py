"""LoRA adapter store: host-resident adapter weights + device slot table
(PyTorch counterpart of ``repro.lora.adapter``).

The device keeps ``max_slots`` stacked slots in the layout the model's
multi-LoRA batching reads: A (L, slots, d_in, r), B (L, slots, r, d_out).
The FASTLIBRA cache manager decides which adapters are resident; this store
performs the physical host->device loads (slot writes, ``non_blocking`` from
pinned memory when the device is CUDA) and keeps the adapter->slot map the
scheduler uses to build ``adapter_ids``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class AdapterWeights:
    """One adapter's host-side weights per target: {t: (A, B)} CPU tensors."""

    adapter_id: str
    rank: int
    weights: dict[str, tuple[torch.Tensor, torch.Tensor]]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() + b.numel() * b.element_size()
                   for a, b in self.weights.values())


class AdapterStore:
    def __init__(self, model, max_slots: int):
        self.model = model
        self.max_slots = max_slots
        self.device = model.device
        self._pin = self.device.type == "cuda"
        # device slot table (zeros = identity / no-op adapter)
        L, r = model.cfg.num_layers, model.cfg.lora.rank
        self.slots = {
            t: (torch.zeros((L, max_slots, din, r), device=self.device),
                torch.zeros((L, max_slots, r, dout), device=self.device))
            for t, (din, dout) in model.lora_dims().items()
        }
        self._host: dict[str, AdapterWeights] = {}
        self._slot_of: dict[str, int] = {}
        self._free_slots = list(range(max_slots - 1, -1, -1))

    # ----------------------------------------------------------------- host
    def register(self, adapter_id: str, *, weights=None,
                 generator: Optional[torch.Generator] = None,
                 scale: float = 0.01) -> AdapterWeights:
        """Put an adapter's weights in host memory: ``weights`` {target:
        (A (L, d_in, r), B (L, r, d_out))} as given (numpy or tensors), or
        drawn from ``generator``: A as the model's ``init_lora`` draws it,
        B normal times ``scale`` (non-zero, so the delta is live)."""
        if adapter_id in self._host:
            return self._host[adapter_id]
        if (weights is None) == (generator is None):
            raise ValueError("register needs exactly one of weights= or generator=")
        if weights is None:
            lora = self.model.init_lora(generator, 1)
            weights = {}
            for t, (a, b) in lora.items():
                bmat = torch.randn(b[:, 0].shape, generator=generator,
                                   device=generator.device) * scale
                weights[t] = (a[:, 0], bmat)
        host = {}
        for t, (a, b) in weights.items():
            pair = []
            for m in (a, b):
                m = torch.as_tensor(m).to("cpu", torch.float32).contiguous()
                pair.append(m.pin_memory() if self._pin else m)
            host[t] = tuple(pair)
        aw = AdapterWeights(adapter_id, self.model.cfg.lora.rank, host)
        self._host[adapter_id] = aw
        return aw

    def host_bytes(self, adapter_id: str) -> int:
        return self._host[adapter_id].nbytes

    # --------------------------------------------------------------- device
    def slot_of(self, adapter_id: str) -> Optional[int]:
        return self._slot_of.get(adapter_id)

    def load(self, adapter_id: str) -> int:
        """Ensure the adapter occupies a device slot; returns the slot."""
        if adapter_id in self._slot_of:
            return self._slot_of[adapter_id]
        if not self._free_slots:
            raise RuntimeError(
                "no free adapter slots — evict via CacheManager first"
            )
        slot = self._free_slots.pop()
        aw = self._host[adapter_id]
        for t, (a, b) in aw.weights.items():
            A, B = self.slots[t]
            A[:, slot].copy_(a, non_blocking=True)
            B[:, slot].copy_(b, non_blocking=True)
        self._slot_of[adapter_id] = slot
        return slot

    def unload(self, adapter_id: str) -> None:
        slot = self._slot_of.pop(adapter_id, None)
        if slot is None:
            return
        for _, B in self.slots.values():
            B[:, slot].zero_()
        self._free_slots.append(slot)

    @property
    def resident(self) -> list[str]:
        return list(self._slot_of)
