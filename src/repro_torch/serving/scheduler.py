"""Mixed prefill+decode step scheduling (Sarathi-style) under a token budget.

The engine's alternate mode runs one bucketed-prefill call and one decode
call per step: decode tokens wait for the prefill dispatch and vice versa,
and the prefill chunk size is a static knob (``EngineConfig.prefill_chunk``).
This module provides the two pieces that collapse a step into ONE mixed
batch:

* :func:`plan_step` — packs every active decode slot (1 token each) plus
  prefill chunk slices into a single per-step token budget, FCFS over the
  prefill rows with ``prefill_chunk`` surviving as the per-row ceiling;
* :class:`TokenBudgetController` — makes the budget *dynamic*: an EMA of
  measured step latency is servo'd against ``target_step_ms``, shrinking the
  prefill share when steps run long (decode TPOT stays bounded under load)
  and growing it back when there is headroom (prefill throughput / TTFT).

The planner is pure and jit-free; the resulting batch still pads to the
existing power-of-two buckets (serving/prefill.py) so the jit cache stays
bounded no matter what budgets the controller picks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class StepPlan:
    """One engine step's mixed batch: who contributes which tokens."""

    decode_slots: tuple[int, ...]  # slots generating 1 token each
    prefill_chunks: dict[int, int]  # slot -> suffix tokens fed this step
    budget: int  # token budget the plan was packed against

    @property
    def tokens(self) -> int:
        """Real tokens in the mixed batch (the unified batch-size signal)."""
        return len(self.decode_slots) + sum(self.prefill_chunks.values())

    @property
    def max_chunk(self) -> int:
        return max(self.prefill_chunks.values(), default=0)


def plan_step(
    decode_slots: Sequence[int],
    prefill_rows: Sequence[tuple[int, int]],  # (slot, suffix tokens left)
    *,
    budget: int,
    chunk_ceiling: int,
    fast_slots: frozenset[int] = frozenset(),
) -> StepPlan:
    """Pack one mixed step: decode slots first (1 token each, never dropped),
    then prefill rows — taken in the caller's order; the engine passes them
    oldest-admission-first so leftover budget favors the longest-waiting
    request — split the remaining budget EVENLY, waterfilling any leftover
    up to the per-row ``chunk_ceiling``.

    Even split (not Sarathi's pure FCFS fill) because the batched call's
    cost is shape-driven — (B, bucket) with bucket padding — so starving
    trailing rows saves nothing on the call while serializing their TTFT;
    coalescing every row into the same call is the whole point of the
    bucketed subsystem. The budget still bounds step latency: it caps the
    total real tokens and thereby the bucket the batch pads to.

    Interactive fast lane: rows whose slot is in ``fast_slots`` (the engine
    passes its interactive-tier requests) are served FIRST and greedily — up
    to ``chunk_ceiling`` each, in row order — before the remaining budget is
    split evenly over the slow rows. Their TTFT then scales with their own
    prompt length, not with however many batch-tier prefills happen to be in
    flight. With ``fast_slots`` empty the plan is exactly the legacy one.

    Progress guarantee: if any prefill row is pending, the first one receives
    at least 1 token even when decode alone exhausts the budget — a saturated
    decode batch must not livelock admission (TTFT would diverge).
    """
    if chunk_ceiling < 1:
        raise ValueError("chunk_ceiling must be >= 1")
    decode_slots = tuple(decode_slots)
    rows = [(slot, left) for slot, left in prefill_rows if left > 0]
    chunks: dict[int, int] = {}
    if rows:
        remaining = max(budget - len(decode_slots), 0)
        fast = [(s, l) for s, l in rows if s in fast_slots]
        slow = [(s, l) for s, l in rows if s not in fast_slots]
        for slot, left in fast:  # fast lane: greedy fill, row order
            take = min(left, chunk_ceiling, remaining)
            if take > 0:
                chunks[slot] = take
                remaining -= take
        if slow:
            share = min(chunk_ceiling, remaining // len(slow))
            if share == 0:
                # fewer budget tokens than rows: 1 token each while they last
                for slot, _ in slow[:remaining]:
                    chunks[slot] = 1
            else:
                for slot, left in slow:
                    take = min(left, share)
                    chunks[slot] = take
                    remaining -= take
                for slot, left in slow:  # waterfill leftover in row order
                    if remaining <= 0:
                        break
                    extra = min(left, chunk_ceiling) - chunks[slot]
                    if extra > 0:
                        extra = min(extra, remaining)
                        chunks[slot] += extra
                        remaining -= extra
        if not chunks:
            # never zero rows — the progress guarantee
            chunks[rows[0][0]] = 1
    return StepPlan(decode_slots=decode_slots, prefill_chunks=chunks,
                    budget=budget)


@dataclasses.dataclass
class TokenBudgetController:
    """Latency-servo for the per-step token budget (multiplicative AIMD).

    ``observe(step_ms)`` feeds the measured wall time of each engine step
    into an EMA; when ``target_step_ms > 0`` the budget shrinks by
    ``shrink`` whenever the EMA overshoots the target and grows by ``grow``
    when it sits below ``headroom * target`` (the dead band between the two
    prevents ping-pong). ``target_step_ms <= 0`` disables adaptation and the
    budget pins to ``max_budget`` — the static-budget ablation.
    """

    max_budget: int
    target_step_ms: float = 0.0
    min_budget: int = 1
    ema_alpha: float = 0.25
    grow: float = 1.25
    shrink: float = 0.7
    headroom: float = 0.8

    ema_ms: float = dataclasses.field(default=0.0, init=False)
    steps: int = dataclasses.field(default=0, init=False)
    _budget: float = dataclasses.field(default=0.0, init=False)

    def __post_init__(self) -> None:
        if self.max_budget < 1:
            raise ValueError("max_budget must be >= 1")
        self.min_budget = max(1, min(self.min_budget, self.max_budget))
        self._budget = float(self.max_budget)

    @property
    def budget(self) -> int:
        return int(round(self._budget))

    def reset(self) -> None:
        """Forget the latency EMA and re-pin the budget to ``max_budget`` —
        benchmark warm-up boundaries call this via ``engine.reset_metrics``
        so steady-state measurements start from the controller's init
        state."""
        self.ema_ms = 0.0
        self.steps = 0
        self._budget = float(self.max_budget)

    def observe(self, step_ms: float) -> None:
        self.steps += 1
        if self.steps == 1:
            self.ema_ms = step_ms
        else:
            a = self.ema_alpha
            self.ema_ms = a * step_ms + (1.0 - a) * self.ema_ms
        if self.target_step_ms <= 0:
            return
        if self.ema_ms > self.target_step_ms:
            self._budget = max(float(self.min_budget),
                               self._budget * self.shrink)
        elif self.ema_ms < self.headroom * self.target_step_ms:
            self._budget = min(float(self.max_budget),
                               max(self._budget * self.grow,
                                   self._budget + 1.0))
