"""Tracer core: ring-buffered host-side events + Chrome trace export.

Design contract (see package docstring and README §Observability):

* **Host scalars only.** Callers pass plain Python floats/ints/strings.
  The tracer never imports jax/numpy and never forces a device sync, so
  instrumentation inside engine hot paths stays clean under the
  ``host-sync`` lint rule.
* **Timestamp-agnostic.** Callers supply timestamps from their own
  monotonic clock (the engine's ``_now()`` engine-relative seconds, the
  simulator's virtual clock). The tracer only converts to microseconds at
  export time, so engine and sim traces share one timeline convention.
* **No-op fast path.** :data:`NULL_TRACER` is a singleton whose
  ``enabled`` is ``False``; every call site guards with
  ``if tracer.enabled:`` so the disabled cost is one attribute read.
* **Bounded memory.** Events live in a ``collections.deque(maxlen=...)``
  ring buffer; overflow drops the oldest events and bumps
  ``dropped_events`` rather than growing without bound.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Event vocabulary — shared by serving/engine.py and sim/simulator.py so the
# two timelines can be diffed event-for-event.
# ---------------------------------------------------------------------------

# Request lifecycle (queue + per-slot tracks).
EV_SUBMIT = "req.submit"
EV_QUEUE = "req.queue"
EV_ADMIT = "req.admit"
EV_PREFILL_CHUNK = "prefill.chunk"
EV_DECODE_STEP = "decode.step"
EV_PREEMPT = "req.preempt"
EV_RESUME = "req.resume"
EV_FINISH = "req.finish"
EV_ABORT = "req.abort"
EV_STEP = "engine.step"
EV_TTFT_ATTRIBUTION = "req.ttft_attribution"
EV_CALIBRATION = "req.ttft_calibration"

# Cache-decision audit log (cache + swapper tracks). "evict" records a
# *decision* (victim, score, competing candidates); swap_out/drop/swap_in
# record the resulting node movement with its cost-model score.
EV_CACHE_ADMIT = "cache.admit"
EV_CACHE_EVICT = "cache.evict"
EV_CACHE_SWAP_IN = "cache.swap_in"
EV_CACHE_SWAP_OUT = "cache.swap_out"
EV_CACHE_DROP = "cache.drop"
EV_CACHE_PREFETCH = "cache.prefetch"
EV_CACHE_COMMIT = "cache.commit"
EV_CACHE_PREEMPT = "cache.preempt"
EV_CACHE_LOAD = "cache.load_new"

# Track (Perfetto thread) names.
TRACK_QUEUE = "queue"
TRACK_ENGINE = "engine"
TRACK_SWAPPER = "swapper"
TRACK_CACHE = "cache"

# TTFT attribution categories (exact additive partition of
# [submit_time, first_token_time]; see serving/request.py).
ATTRIB_CATEGORIES = (
    "queue",
    "lora_load",
    "swap_in",
    "recompute",
    "compute",
    "stall",
    "other",
)

_PH_SPAN = "X"
_PH_INSTANT = "i"
_PH_COUNTER = "C"


def slot_track(slot: int) -> str:
    """Track name for decode slot ``slot`` (one Perfetto row per slot)."""
    return f"slot{slot}"


def trace_env_enabled() -> bool:
    """True when tracing is armed process-wide via ``REPRO_TRACE=1``."""
    return os.environ.get("REPRO_TRACE", "0") == "1"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded event. ``ts``/``dur`` are caller-clock seconds."""

    phase: str  # "X" span | "i" instant | "C" counter sample
    name: str
    track: str
    ts: float
    dur: float = 0.0
    args: Optional[Dict[str, Any]] = None


class Tracer:
    """Ring-buffered span/instant/counter recorder with Chrome export."""

    enabled = True

    def __init__(self, capacity: int = 200_000):
        self.events: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped_events = 0
        # Aggregate registries, independent of the ring buffer (never
        # dropped): monotonically increasing counts and last-value gauges.
        self.counts: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}

    # -- recording ----------------------------------------------------------

    def _push(self, ev: TraceEvent) -> None:
        if len(self.events) == self.capacity:
            self.dropped_events += 1
        self.events.append(ev)

    def span(self, track: str, name: str, t0: float, t1: float, **args: Any) -> None:
        """Record a complete span [t0, t1] on ``track``."""
        self._push(TraceEvent(_PH_SPAN, name, track, t0, max(0.0, t1 - t0), args or None))

    def instant(self, track: str, name: str, t: float, **args: Any) -> None:
        """Record a point event at ``t`` on ``track``."""
        self._push(TraceEvent(_PH_INSTANT, name, track, t, 0.0, args or None))

    def counter(self, name: str, t: float, **series: float) -> None:
        """Record a counter sample (one Perfetto counter track per name)."""
        self._push(TraceEvent(_PH_COUNTER, name, name, t, 0.0, dict(series)))

    def audit(self, name: str, t: float, **fields: Any) -> None:
        """Record a cache-decision audit event (instant on the cache track)."""
        self.count(name)
        self._push(TraceEvent(_PH_INSTANT, name, TRACK_CACHE, t, 0.0, fields or None))

    def count(self, name: str, n: int = 1) -> None:
        """Bump an aggregate counter (registry, not the ring buffer)."""
        self.counts[name] = self.counts.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        """Set an aggregate gauge to its latest value."""
        self.gauges[name] = value

    def clear(self) -> None:
        self.events.clear()
        self.dropped_events = 0
        self.counts.clear()
        self.gauges.clear()

    # -- queries ------------------------------------------------------------

    def named(self, name: str) -> List[TraceEvent]:
        """All buffered events with the given name, in record order."""
        return [ev for ev in self.events if ev.name == name]

    # -- export -------------------------------------------------------------

    def export_chrome(self) -> Dict[str, Any]:
        """Render the buffer as a Chrome trace-event JSON object.

        Loads directly in Perfetto / chrome://tracing: one pid (0) with one
        named thread per track, timestamps in microseconds.
        """
        pid = 0
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = []

        def tid(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = len(tids)
                tids[track] = t
                out.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": t,
                        "args": {"name": track},
                    }
                )
            return t

        for ev in self.events:
            rec: Dict[str, Any] = {
                "name": ev.name,
                "ph": ev.phase,
                "pid": pid,
                "tid": tid(ev.track),
                "ts": ev.ts * 1e6,
            }
            if ev.phase == _PH_SPAN:
                rec["dur"] = ev.dur * 1e6
            elif ev.phase == _PH_INSTANT:
                rec["s"] = "t"  # thread-scoped instant
            if ev.args:
                rec["args"] = ev.args
            out.append(rec)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.obs libra-trace",
                "droppedEvents": self.dropped_events,
                "counts": dict(self.counts),
                "gauges": dict(self.gauges),
            },
        }

    def dump(self, path: str) -> None:
        """Write the Chrome trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)


class NullTracer(Tracer):
    """Disabled tracer: every recording call is a no-op.

    Call sites additionally guard with ``if tracer.enabled:`` so the
    disabled cost is one attribute read and no argument evaluation.
    """

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def _push(self, ev: TraceEvent) -> None:  # pragma: no cover - guarded out
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass


NULL_TRACER = NullTracer()
