"""Request model + per-request latency accounting.

Arrival-time semantics: ``submit_time`` is ``None`` until the request is
handed to the engine, at which point :meth:`ServingEngine.submit` stamps the
engine clock — UNLESS the caller pre-set it (trace replay with backdated
arrivals). All queue/TTFT metrics and the deadline-aware admission order are
measured against this value, so a replayed trace carries its true arrival
pattern instead of the wall time the replay loop happened to call submit().

SLO tiers: ``priority`` orders admission strictly (higher first — e.g.
interactive=1 vs batch=0); ``deadline`` is an absolute engine-clock time the
first token should land by. Within a priority tier the engine admits by
least deadline slack (deadline − now − estimated TTFT from the cost model),
then FCFS. A higher-priority request that cannot be admitted may PREEMPT a
strictly-lower-priority running victim: the victim's computed KV (or
recurrent-state snapshot) is folded into the two-tier cache pool — demoted
to host by the swapper under pressure, not discarded — and the victim
requeues. On resume it matches its own swapped prefix and continues
token-identically; generated tokens survive in ``carried`` and
``output_tokens`` presents the full carried+generated stream.

Abort semantics: :meth:`ServingEngine.abort` (and the ``run()`` drain on
step exhaustion) moves a request to ``Phase.ABORTED`` after releasing every
resource it held — pins, running blocks, slot, staged state. An aborted
request keeps whatever tokens it produced but is never counted as finished.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"  # admitted, prefix gathered, suffix not yet started
    PREFILLING = "prefilling"  # chunked batch prefill in flight
    DECODE = "decode"
    FINISHED = "finished"
    ABORTED = "aborted"  # released by the engine's abort/drain path


# SLO tier conventions (any int works; higher = more latency-sensitive)
PRIORITY_BATCH = 0
PRIORITY_INTERACTIVE = 1


@dataclasses.dataclass
class Request:
    request_id: str
    adapter_id: str
    prompt: tuple[int, ...]
    max_new_tokens: int
    # None until submit(); pre-set by trace replay to carry true arrivals
    # (submit() honors a caller-provided value instead of clobbering it)
    submit_time: Optional[float] = None
    # SLO tier: admission is ordered by (priority desc, deadline slack asc,
    # submit_time); preemption only ever evicts a STRICTLY lower priority
    priority: int = PRIORITY_BATCH
    # absolute engine-clock first-token deadline (None = no deadline)
    deadline: Optional[float] = None
    # filled during serving
    phase: Phase = Phase.WAITING
    generated: list[int] = dataclasses.field(default_factory=list)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # cold-start breakdown (paper Fig. 12)
    lora_coldstart: float = 0.0
    kv_coldstart: float = 0.0
    matched_tokens: int = 0
    hbm_hit_tokens: int = 0
    # cross-adapter prefix sharing: leading prompt tokens that are
    # adapter-independent (e.g. a product system prompt). The engine computes
    # them with the adapter INACTIVE (base-model rows) so their KV is
    # bit-identical across adapters and cacheable on the shared trunk. 0 =
    # whole prompt is adapter-specific (legacy behavior).
    shared_prefix_len: int = 0
    # engine bookkeeping
    slot: int = -1
    lookup: object = None
    pinned: list = dataclasses.field(default_factory=list)
    # chunked-prefill bookkeeping: absolute position of the next suffix
    # token to prefill, and how many batched chunks this request rode in
    prefill_pos: int = 0
    prefill_chunks: int = 0
    # recurrent-state snapshot bookkeeping: the prefix boundary to capture a
    # snapshot at (len(prompt)-1 so an identical repeat can resume and still
    # recompute its last token for logits; -1 = no capture), and the
    # captured flat state staged until commit folds it into the pool
    state_capture_at: int = -1
    staged_state: object = None
    # preemption bookkeeping: tokens generated before a preemption are folded
    # into the (growing) prompt so the resume lookup matches the victim's own
    # committed KV/state — they live on in ``carried`` and the resume decode
    # continues token-identically from where preemption cut it off
    carried: list[int] = dataclasses.field(default_factory=list)
    preempt_count: int = 0
    # highest absolute prompt position this request had already computed
    # before a preemption folded it back to WAITING: prefill work below
    # this boundary is classified as ``recompute`` in the TTFT attribution
    # (0 for a never-preempted request — all prefill is fresh compute)
    recompute_boundary: int = 0
    # TTFT attribution (repro_torch.obs): an EXACT additive partition of
    # [submit_time, first_token_time] into the categories of
    # ``obs.ATTRIB_CATEGORIES``. The engine advances ``attrib_cursor`` at
    # every charge point (queue end, per swap op, per prefill dispatch, ...)
    # so sum(attribution.values()) == ttft by construction. Accounting is
    # host-float cheap and always on (like lora/kv_coldstart); span/event
    # emission is what the tracer gates.
    attribution: dict[str, float] = dataclasses.field(default_factory=dict)
    attrib_cursor: Optional[float] = None
    # estimate_ttft sampled at first admission when tracing is armed, for
    # the predicted-vs-actual calibration series
    ttft_predicted: Optional[float] = None

    # -- TTFT attribution charging (called by the engine) -------------------

    def charge(self, category: str, t: float) -> None:
        """Attribute [attrib_cursor, t) to ``category`` and advance the
        cursor. No-op before submit or after the first token closed the
        window (a resumed decode-phase victim charges nothing)."""
        if self.attrib_cursor is None or self.first_token_time is not None:
            return
        dt = t - self.attrib_cursor
        if dt > 0:
            self.attribution[category] = self.attribution.get(category, 0.0) + dt
            self.attrib_cursor = t

    def charge_prefill(self, t: float, tokens: int, hist_tokens: int) -> None:
        """Split [attrib_cursor, t) between ``recompute`` (the share of this
        dispatch's tokens that rebuild already-seen history, i.e. positions
        below len(prompt)-1 lost to eviction/preemption) and ``compute``."""
        if self.attrib_cursor is None or self.first_token_time is not None:
            return
        dt = t - self.attrib_cursor
        if dt > 0:
            frac = min(max(hist_tokens, 0), tokens) / tokens if tokens > 0 else 0.0
            rec = dt * frac
            if rec > 0:
                self.attribution["recompute"] = self.attribution.get("recompute", 0.0) + rec
            self.attribution["compute"] = self.attribution.get("compute", 0.0) + (dt - rec)
            self.attrib_cursor = t

    def ttft_attribution(self) -> Optional[dict[str, float]]:
        """The additive breakdown, or None before the first token."""
        if self.ttft is None:
            return None
        return dict(self.attribution)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None or self.submit_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = max(1, len(self.carried) + len(self.generated) - 1)
        return (self.finish_time - self.first_token_time) / n

    @property
    def queue_time(self) -> Optional[float]:
        if self.admit_time is None or self.submit_time is None:
            return None
        return self.admit_time - self.submit_time

    @property
    def full_tokens(self) -> tuple[int, ...]:
        return self.prompt + tuple(self.generated)

    @property
    def output_tokens(self) -> tuple[int, ...]:
        """The complete generated stream: tokens produced before any
        preemption (folded into the prompt, kept in ``carried``) plus the
        current ``generated`` tail. Equals ``tuple(generated)`` for a request
        that was never preempted."""
        return tuple(self.carried) + tuple(self.generated)
