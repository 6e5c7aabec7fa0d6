"""Serving metrics aggregation (TTFT / TPOT / throughput / breakdowns)."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Iterable

from .request import Request


@dataclasses.dataclass
class ServingReport:
    n_finished: int
    avg_ttft: float
    p99_ttft: float
    avg_tpot: float
    avg_queue: float
    avg_lora_coldstart: float
    avg_kv_coldstart: float
    throughput_qps: float
    kv_hit_rate: float
    lora_hit_rate: float
    invalid_kv_fraction: float
    hbm_utilization: float
    # prefill subsystem (serving/prefill.py)
    p99_queue: float = 0.0
    avg_prefill_batch: float = 0.0  # requests coalesced per batched prefill
    prefill_compiles: int = 0  # distinct lowered prefill shapes (≤ #buckets)
    # step scheduler (serving/scheduler.py)
    p99_tpot: float = 0.0  # decode-latency tail the mixed budget bounds
    avg_step_ms: float = 0.0  # mean measured engine-step wall time
    ema_step_ms: float = 0.0  # TokenBudgetController's latency EMA
    budget_utilization: float = 0.0  # mixed-batch tokens / step budget
    # recurrent-state prefix cache (kvcache/state_cache.py): token-weighted
    # snapshot hit rate, symmetric with kv_hit_rate for KV layouts
    state_hit_rate: float = 0.0
    # request-lifecycle accounting: a run() that exhausts max_steps drains
    # its leftovers through the abort path and reports them here instead of
    # silently pretending the trace completed
    n_aborted: int = 0  # aborted (drained or explicit abort()) requests
    n_unfinished: int = 0  # still WAITING/in-flight when the report was cut
    n_preempted: int = 0  # preemption events (a victim can count twice)
    # libra-trace TTFT attribution (repro_torch.obs): mean per-request seconds the
    # first token spent recomputing evicted/preempted prefix work, and mean
    # dispatch stall — both additive slices of TTFT (always measured; the
    # tracer only gates event emission)
    avg_recompute: float = 0.0
    avg_stall: float = 0.0
    # estimate_ttft calibration over requests that had a prediction sampled
    # at admission (tracing armed): mean |predicted − actual| and signed bias
    ttft_pred_mae: float = 0.0
    ttft_pred_bias: float = 0.0

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _p(vals, q):
    if not vals:
        return 0.0
    vals = sorted(vals)
    idx = min(len(vals) - 1, int(q * len(vals)))
    return vals[idx]


def summarize(
    finished: Iterable[Request],
    wall_time: float,
    *,
    kv_hit_rate: float = 0.0,
    lora_hit_rate: float = 0.0,
    invalid_kv_fraction: float = 0.0,
    hbm_utilization: float = 0.0,
    avg_prefill_batch: float = 0.0,
    prefill_compiles: int = 0,
    avg_step_ms: float = 0.0,
    ema_step_ms: float = 0.0,
    budget_utilization: float = 0.0,
    state_hit_rate: float = 0.0,
    n_aborted: int = 0,
    n_unfinished: int = 0,
    n_preempted: int = 0,
) -> ServingReport:
    reqs = [r for r in finished if r.ttft is not None]
    ttfts = [r.ttft for r in reqs]
    tpots = [r.tpot for r in reqs if r.tpot is not None]
    queues = [r.queue_time for r in reqs if r.queue_time is not None]
    pred_errs = [
        r.ttft_predicted - r.ttft
        for r in reqs
        if getattr(r, "ttft_predicted", None) is not None
    ]
    return ServingReport(
        n_finished=len(reqs),
        avg_ttft=statistics.fmean(ttfts) if ttfts else 0.0,
        p99_ttft=_p(ttfts, 0.99),
        avg_tpot=statistics.fmean(tpots) if tpots else 0.0,
        avg_queue=statistics.fmean(queues) if queues else 0.0,
        avg_lora_coldstart=statistics.fmean([r.lora_coldstart for r in reqs]) if reqs else 0.0,
        avg_kv_coldstart=statistics.fmean([r.kv_coldstart for r in reqs]) if reqs else 0.0,
        throughput_qps=len(reqs) / wall_time if wall_time > 0 else 0.0,
        kv_hit_rate=kv_hit_rate,
        lora_hit_rate=lora_hit_rate,
        invalid_kv_fraction=invalid_kv_fraction,
        hbm_utilization=hbm_utilization,
        p99_queue=_p(queues, 0.99),
        avg_prefill_batch=avg_prefill_batch,
        prefill_compiles=prefill_compiles,
        p99_tpot=_p(tpots, 0.99),
        avg_step_ms=avg_step_ms,
        ema_step_ms=ema_step_ms,
        budget_utilization=budget_utilization,
        state_hit_rate=state_hit_rate,
        n_aborted=n_aborted,
        n_unfinished=n_unfinished,
        n_preempted=n_preempted,
        avg_recompute=statistics.fmean(
            [getattr(r, "attribution", {}).get("recompute", 0.0)
             for r in reqs]) if reqs else 0.0,
        avg_stall=statistics.fmean(
            [getattr(r, "attribution", {}).get("stall", 0.0)
             for r in reqs]) if reqs else 0.0,
        ttft_pred_mae=statistics.fmean(
            [abs(e) for e in pred_errs]) if pred_errs else 0.0,
        ttft_pred_bias=statistics.fmean(pred_errs) if pred_errs else 0.0,
    )
