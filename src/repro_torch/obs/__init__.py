"""libra-trace: span-based engine tracing + cache-decision audit log.

A zero-dependency (stdlib-only) observability layer for the serving stack:

* :class:`Tracer` — monotonic-clock spans, instants and counter series in a
  ring-buffered host-side event log, plus named counter/gauge registries.
  Every recorded value is a plain Python scalar: the tracer never touches a
  device array, so instrumented hot paths stay clean under the ``host-sync``
  libra-lint rule and armed tracing adds no device round trips.
* :data:`NULL_TRACER` — the module-level no-op fast path. With tracing
  disabled every instrumentation site is one attribute read
  (``tracer.enabled`` is ``False``) and the serving hot loop is unchanged —
  the CI overhead gate pins compile counts and token streams identical.
* Arming: ``REPRO_TRACE=1`` (same env-override pattern as
  ``REPRO_SCHEDULE_MODE``) or ``EngineConfig(trace=True)`` /
  ``SimConfig(trace=True)`` per engine.
* Export: :meth:`Tracer.export_chrome` emits Chrome trace-event JSON that
  loads directly in Perfetto (one track per decode slot, the admission
  queue, the swapper, and the cache audit log); ``python -m
  repro_torch.obs.report trace.json`` summarizes a dumped trace (top evicted
  nodes, TTFT attribution table, span histograms, estimate_ttft
  calibration).

The event vocabulary (``EV_*`` / ``TRACK_*``) is shared by the JAX engine
and the discrete-event simulator so engine-vs-sim timelines diff cleanly.
See README.md §Observability.
"""

from .tracer import (
    ATTRIB_CATEGORIES,
    EV_ABORT,
    EV_ADMIT,
    EV_CACHE_ADMIT,
    EV_CACHE_COMMIT,
    EV_CACHE_DROP,
    EV_CACHE_EVICT,
    EV_CACHE_LOAD,
    EV_CACHE_PREEMPT,
    EV_CACHE_PREFETCH,
    EV_CACHE_SWAP_IN,
    EV_CACHE_SWAP_OUT,
    EV_CALIBRATION,
    EV_DECODE_STEP,
    EV_FINISH,
    EV_PREEMPT,
    EV_PREFILL_CHUNK,
    EV_QUEUE,
    EV_RESUME,
    EV_STEP,
    EV_SUBMIT,
    EV_TTFT_ATTRIBUTION,
    NULL_TRACER,
    TRACK_CACHE,
    TRACK_ENGINE,
    TRACK_QUEUE,
    TRACK_SWAPPER,
    NullTracer,
    Tracer,
    slot_track,
    trace_env_enabled,
)

__all__ = [
    "ATTRIB_CATEGORIES",
    "EV_ABORT",
    "EV_ADMIT",
    "EV_CACHE_ADMIT",
    "EV_CACHE_COMMIT",
    "EV_CACHE_DROP",
    "EV_CACHE_EVICT",
    "EV_CACHE_LOAD",
    "EV_CACHE_PREEMPT",
    "EV_CACHE_PREFETCH",
    "EV_CACHE_SWAP_IN",
    "EV_CACHE_SWAP_OUT",
    "EV_CALIBRATION",
    "EV_DECODE_STEP",
    "EV_FINISH",
    "EV_PREEMPT",
    "EV_PREFILL_CHUNK",
    "EV_QUEUE",
    "EV_RESUME",
    "EV_STEP",
    "EV_SUBMIT",
    "EV_TTFT_ATTRIBUTION",
    "NULL_TRACER",
    "NullTracer",
    "TRACK_CACHE",
    "TRACK_ENGINE",
    "TRACK_QUEUE",
    "TRACK_SWAPPER",
    "Tracer",
    "slot_track",
    "trace_env_enabled",
]
