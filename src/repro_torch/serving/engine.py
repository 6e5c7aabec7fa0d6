"""PyTorch multi-LoRA serving engine with FASTLIBRA cache management
(counterpart of ``repro.serving.engine``: the dense GQA, MLA, MoE, RWKV-6
and RG-LRU hybrid layouts).

Continuous-batching engine that executes prefill/decode in PyTorch on the
card (CUDA kernels for the LoRA projections and attention) or, when the
caller asks for ``device="cpu"``, with the kernels' plain versions. The
FASTLIBRA :class:`~repro_torch.core.CacheManager` (the reference's own
code) is the single source of truth for device block allocation; this
engine is its data plane:

* matched prefix nodes → ``PagedKVPool.gather`` into the dense running cache,
* newly computed suffixes → ``PagedKVPool.scatter`` into pool blocks at
  commit (paper: "new KVs are retained in HBM directly"),
* recurrent layouts (RWKV / RG-LRU): the prefix cache is the state-snapshot
  subsystem instead — a matched STATE node seeds the slot's recurrent state
  row via ``StateCache.load``/``unflatten_state`` so prefill covers only the
  un-snapshotted suffix, and prefill captures the state at ``len(prompt)-1``
  (chunks are clamped to land on the boundary) for ``commit_state`` to fold
  into the same unified pool,
* swap ops from the performance-driven swapper → physical host↔device copies
  (``PagedKVPool.swap_in/out``) and adapter slot loads (:class:`AdapterStore`),
* dependency-tree bookkeeping (lookup → admit → pin → commit → unpin).

The decode step is one ``model.extend`` over a fixed-slot dense cache;
adapters batch through ``fused_sgmv`` via per-row ``adapter_ids``. Prefill
runs through the bucketed batch subsystem in :mod:`repro_torch.serving.
prefill`; the exact-shape eager path survives as ``prefill_mode="eager"``.

Where the reference computes a new cache and keeps some rows of it, this
engine writes in place: ``extend`` writes only the rows it keeps
(``keep_rows``) and advances ``len`` only there, so a catch-up decode never
touches a prefilling row's KV or state. The KV pool holds the model's
cache rows: K and V per head, or for MLA the latent and the rope key as
one pseudo-head per token with no V, as in the reference. A recurrent
layout has no KV pool (``kv_pool`` is None) and a ``StateCache`` in its
place. The encoder-decoder layout is not served, as in the reference.

With ``schedule_mode="mixed"`` each engine step is ONE row-masked batched
``extend``: active decode slots ride as 1-token rows next to prefill chunk
rows, packed under a per-step token budget that a latency-servoing
:class:`~repro_torch.serving.scheduler.TokenBudgetController` adapts (Sarathi-
style continuous chunked prefill). ``schedule_mode="alternate"`` keeps the
one-prefill-call-then-one-decode-call step as the ablation pin.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..core import NodeKind, Residency, SwapKind, make_fastlibra
from ..device import resolve_device
from ..obs import (
    ATTRIB_CATEGORIES,
    EV_ABORT,
    EV_ADMIT,
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
    TRACK_ENGINE,
    TRACK_QUEUE,
    TRACK_SWAPPER,
    Tracer,
    slot_track,
    trace_env_enabled,
)
from ..kvcache import (
    KVPoolSpec,
    PagedKVPool,
    StateCache,
    StateSpec,
    flat_state_elems,
    flatten_state,
    unflatten_state,
)
from ..lora import AdapterStore
from ..models import build_model
from .metrics import ServingReport, summarize
from .prefill import BatchPrefill, assemble_batch, make_buckets
from .request import PRIORITY_BATCH, Phase, Request
from .scheduler import TokenBudgetController, plan_step


def _default_schedule_mode() -> str:
    # "mixed" is the engine default (the ROADMAP burn-in criterion was met:
    # the CI sweep is stable and now runs blocking); "alternate" survives as
    # the ablation pin. The env override lets CI pin either mode without
    # touching every test's EngineConfig construction.
    return os.environ.get("REPRO_SCHEDULE_MODE", "mixed")


def kv_pool_spec(model_cfg, block_size: int) -> KVPoolSpec:
    """The KV pool's layout for ``model_cfg``: K and V per head, or for MLA
    the compressed latent and the rope key as ONE pseudo-head per token
    (what ``_read_dense``/``_write_dense`` move) with no V, not the
    expanded num_kv_heads × head_dim layout."""
    if model_cfg.mla is not None:
        m = model_cfg.mla
        kv_heads, head_dim = 1, m.kv_lora_rank + m.qk_rope_head_dim
    else:
        kv_heads, head_dim = model_cfg.num_kv_heads, model_cfg.resolved_head_dim
    return KVPoolSpec(num_layers=model_cfg.num_layers, block_size=block_size,
                      kv_heads=kv_heads, head_dim=head_dim, dtype=torch.float32,
                      use_v=model_cfg.mla is None)


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs.

    Scheduling (serving/scheduler.py):

    * ``schedule_mode`` — ``"mixed"`` composes each engine step as ONE
      batched ``extend``: every active decode slot contributes 1 token and
      prefill-phase rows fill the remaining per-step token budget with chunk
      slices (Sarathi-style continuous chunked prefill). ``"alternate"``
      keeps the PR-2 behavior — one bucketed-prefill call then one decode
      call per step — as the ablation pin.
    * ``step_token_budget`` — upper bound on real tokens per mixed step
      (decode tokens + prefill chunk tokens). The scheduling knob that
      replaces the static ``prefill_chunk``, which survives only as the
      per-row chunk ceiling (and keeps ring-window models safe).
    * ``target_step_ms`` — when > 0, a :class:`TokenBudgetController`
      servos the budget against an EMA of measured step wall time so decode
      TPOT stays bounded under prefill load; <= 0 pins the budget static.

    Prefill (serving/prefill.py): ``prefill_mode="bucketed"`` is the
    coalesced, length-bucketed chunked path; ``"eager"`` is the exact-shape
    per-request seed path kept as the correctness pin.

    There is no ``kernel_backend``: the device decides (CUDA kernels on the
    card, their plain versions on the CPU).
    """

    hbm_bytes: int = 64 << 20  # CPU-test scale; 64 GB on the paper's NPU
    host_bytes: int = 256 << 20
    block_size: int = 16
    max_batch_slots: int = 8
    max_seq_len: int = 256
    variant: str = "fastlibra"  # fastlibra|wom|wos|wol|vllm|slora
    eos_token: int = -1  # -1: run to max_new_tokens
    clock: Callable[[], float] = time.monotonic
    # ---- prefill subsystem (serving/prefill.py)
    # "bucketed": coalesced, length-bucketed, jit-cached chunked prefill;
    # "eager": the exact-shape per-request path (correctness pin / ablation)
    prefill_mode: str = "bucketed"
    prefill_chunk: int = 64  # max suffix tokens fed per engine step & row
    prefill_min_bucket: int = 8  # smallest pad-to bucket (powers of two up)
    # ---- step scheduler (serving/scheduler.py)
    schedule_mode: str = dataclasses.field(
        default_factory=_default_schedule_mode)  # "mixed" | "alternate"
    step_token_budget: int = 128  # max real tokens per mixed step
    target_step_ms: float = 0.0  # >0: budget servos to this step latency
    # ---- cross-adapter prefix sharing (core/dependency_tree.py trunk).
    # Requests declaring shared_prefix_len > 0 run that span with the
    # adapter INACTIVE (base-model rows) either way; this knob only decides
    # whether the resulting KV is cached once on the shared trunk (True) or
    # per adapter (False — the differential baseline).
    share_prefix_kv: bool = True
    # ---- libra-trace observability (repro_torch.obs; README.md §Observability).
    # True arms the span/audit tracer for this engine; the default follows
    # REPRO_TRACE=1 (same env-override pattern as REPRO_SCHEDULE_MODE).
    # Disabled tracing uses the module no-op singleton: zero events, same
    # compile counts and token streams (the CI overhead gate pins this).
    trace: bool = dataclasses.field(default_factory=trace_env_enabled)
    trace_capacity: int = 200_000  # ring-buffer size before oldest-drop


class ServingEngine:
    def __init__(self, model_cfg, config: EngineConfig, *, params=None,
                 seed: int = 0, device=None):
        """``params``: the model's weights (e.g. bridged from the reference
        by :mod:`repro_torch.bridge`), moved to ``device``; without them the
        weights are drawn from a CPU ``torch.Generator`` seeded with
        ``seed``, so one seed gives the same weights on every device.
        ``device`` defaults to the card and raises without one."""
        if config.schedule_mode not in ("mixed", "alternate"):
            # step() branches on == "mixed" with a bare else: a typo (or a
            # bad REPRO_SCHEDULE_MODE) must not silently run alternate mode
            raise ValueError(
                f"schedule_mode must be 'mixed' or 'alternate', "
                f"got {config.schedule_mode!r}")
        self.device = resolve_device(device)
        self.cfg = config
        self.model_cfg = model_cfg
        if model_cfg.is_encdec:
            raise NotImplementedError(
                "the engine serves decoder-only layouts, as the reference's does")
        self.model = build_model(model_cfg, dtype=torch.float32, device=self.device)
        if params is None:
            params = self.model.init_params(torch.Generator().manual_seed(seed))
        else:
            from ..bridge import tensor_tree

            params = tensor_tree(params, self.device)
        self.params = params
        spec = kv_pool_spec(model_cfg, config.block_size)
        self.kv_spec = spec
        B, T = config.max_batch_slots, config.max_seq_len
        # dense running cache: fixed decode slots
        self.cache = self.model.init_cache(B, T)
        # recurrent layouts (RWKV / RG-LRU hybrid) carry fixed-size state
        # snapshots instead of a per-token dense KV: their prefix cache is
        # the state-snapshot subsystem (kvcache/state_cache.py + STATE nodes
        # in the dependency tree), sized from the actual cache row layout
        self._state_reusable = self.model.recurrent
        state_bytes = 0
        if self._state_reusable:
            self.state_spec = StateSpec(
                state_elems=flat_state_elems(self.cache),
                block_bytes=config.block_size * spec.bytes_per_token,
                dtype=torch.float32,  # engine cache dtype (widest leaf)
            )
            state_bytes = self.state_spec.snapshot_bytes
        self.tracer = (
            Tracer(capacity=config.trace_capacity) if config.trace else NULL_TRACER
        )
        self.manager, self.swapper = make_fastlibra(
            config.hbm_bytes,
            config.host_bytes,
            kv_bytes_per_token=spec.bytes_per_token,
            block_size=config.block_size,
            variant=config.variant,
            state_bytes=state_bytes,
            share_prefix_kv=config.share_prefix_kv,
            tracer=self.tracer,
        )
        pool_blocks = self.manager.kv_pool.num_hbm_blocks
        host_blocks = self.manager.kv_pool.num_host_blocks
        self.kv_pool = self.state_cache = None
        if self._state_reusable:
            # one data plane per layout: snapshots for recurrent archs (the
            # paged per-token pool would be dead weight)
            self.state_cache = StateCache(self.state_spec, pool_blocks, host_blocks,
                                          device=self.device)
        else:
            self.kv_pool = PagedKVPool(spec, pool_blocks, host_blocks,
                                       device=self.device)
        self.adapters = AdapterStore(self.model, model_cfg.lora.max_adapters)
        self._slot_req: list[Optional[Request]] = [None] * B
        self._free_slots = deque(range(B))
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self.aborted: list[Request] = []
        self._decode_calls = 0
        chunk = min(config.prefill_chunk, config.max_seq_len)
        if model_cfg.rglru is not None and model_cfg.window_size:
            # ring-indexed window caches: a padded chunk wider than the ring
            # would wrap pad slots onto the chunk's own real writes
            chunk = min(chunk, model_cfg.window_size)
        self.prefill = BatchPrefill(
            self.model, make_buckets(config.prefill_min_bucket, chunk)
        )
        self._prefill_chunk = chunk
        self.budget_ctl = TokenBudgetController(
            max_budget=max(config.step_token_budget, B + 1),
            target_step_ms=config.target_step_ms,
            min_budget=B + 1,  # a full decode batch plus 1 prefill token
        )
        self._start_time: Optional[float] = None
        self._epoch = 0.0  # wall baseline for reports; reset_metrics moves it
        # unified mixed-batch token counts (5 s window) — the ONE batch-size
        # signal the swapper/cost model observes (Eq. 3's BS)
        self._batch_tokens: deque[tuple[float, int]] = deque()
        self._step_count = 0
        self._step_ms_sum = 0.0
        self._budget_used = 0
        self._budget_avail = 0

    def reset_metrics(self) -> None:
        """Forget per-request and per-step accounting while keeping
        adapters and FASTLIBRA cache state warm. Benchmarks call this after
        a warm-up trace so one-time costs (kernel builds, allocator growth)
        don't pollute the steady-state TTFT/TPOT comparison."""
        from .prefill import PrefillStats

        self.finished.clear()
        self.aborted.clear()
        self.prefill.stats = PrefillStats()
        self._step_count = 0
        self._step_ms_sum = 0.0
        self._budget_used = 0
        self._budget_avail = 0
        self._batch_tokens.clear()
        self.budget_ctl.reset()
        # wall-clock baseline for throughput_qps and fresh hit-rate
        # counters — without these, post-reset reports span the warm-up
        self._epoch = self._now()
        self.manager.stats = type(self.manager.stats)()

    def compile_counts(self) -> dict[str, int]:
        """Distinct step shapes per entry point, the reference's compile
        probe read eagerly: prefill counts the buckets dispatched (bounded
        by the bucket count), decode is 1 once the S=1 step has run."""
        return {
            "prefill": self.prefill.compile_count,
            "decode": int(self._decode_calls > 0),
        }

    # ----------------------------------------------------------------- LoRA
    def register_adapter(self, adapter_id: str, weights=None) -> None:
        """Register an adapter's host weights: ``weights`` {target: (A, B)}
        as given, or drawn from a generator seeded by the adapter id's
        CRC-32 (stable across processes, unlike ``hash``)."""
        gen = None
        if weights is None:
            gen = torch.Generator().manual_seed(zlib.crc32(adapter_id.encode()))
        aw = self.adapters.register(adapter_id, weights=weights, generator=gen)
        self.manager.register_lora(adapter_id, aw.nbytes, now=self._now())

    # ------------------------------------------------------------- requests
    def submit(self, request: Request) -> None:
        """Queue a request. A caller-provided ``submit_time`` (trace replay
        with backdated arrivals) is honored; only an unset one is stamped
        with the engine clock — queue/TTFT metrics and the deadline-aware
        admission order all measure against this value."""
        if request.submit_time is None:
            request.submit_time = self._now()
        if request.attrib_cursor is None:
            # TTFT attribution window opens at arrival (request.py)
            request.attrib_cursor = request.submit_time
        if self.tracer.enabled:
            self.tracer.instant(
                TRACK_QUEUE, EV_SUBMIT, request.submit_time,
                rid=request.request_id, adapter=request.adapter_id,
                prompt_tokens=len(request.prompt), priority=request.priority)
        self.waiting.append(request)

    def abort(self, request: Request) -> None:
        """Release everything ``request`` holds — admission pins, running
        blocks, decode slot, staged state — and move it to ``Phase.ABORTED``.
        Safe in any phase; FINISHED/ABORTED requests are left untouched. The
        request keeps whatever tokens it produced but never counts as
        finished; ``run()`` drains leftover in-flight requests through this
        path when its step budget runs out."""
        if request.phase in (Phase.FINISHED, Phase.ABORTED):
            return
        if self.tracer.enabled:
            self.tracer.instant(
                TRACK_QUEUE, EV_ABORT, self._now(),
                rid=request.request_id, phase=request.phase.value)
        if request.phase is Phase.WAITING:
            try:
                self.waiting.remove(request)
            except ValueError:
                pass
        else:
            self.manager.abort_running(request.request_id)
            self.manager.unpin(request.pinned)
            request.pinned = []
            self._execute_swaps(self.manager.drain_ops())
            if request.slot >= 0:
                self._slot_req[request.slot] = None
                self._free_slots.append(request.slot)
                request.slot = -1
            request.staged_state = None
        request.phase = Phase.ABORTED
        request.finish_time = self._now()
        self.aborted.append(request)

    def now(self) -> float:
        """Current engine-clock reading — the time base for ``submit_time``
        backdating and absolute ``deadline`` values."""
        return self._now()

    def export_trace(self, path: str) -> None:
        """Dump the tracer's buffer as Chrome trace-event JSON (loads in
        Perfetto; see repro_torch.obs). A disabled tracer dumps an empty trace."""
        self.tracer.dump(path)

    def _now(self) -> float:
        if self._start_time is None:
            self._start_time = self.cfg.clock()
        return self.cfg.clock() - self._start_time

    # ------------------------------------------------------------ main loop
    def run(self, max_steps: int = 10_000) -> ServingReport:
        """Drive until all submitted requests finish (or step budget).

        Step-budget exhaustion with work still pending is not silent: every
        in-flight request is drained through :meth:`abort` (releasing its
        pins, running blocks, and slot — leaked resources would poison any
        later run on the same engine) and the report carries ``n_unfinished``
        (submitted but not finished at the cut) and ``n_aborted`` instead of
        pretending the trace completed. WAITING requests hold no resources
        and stay queued for a later ``run()``."""
        steps = 0
        while (self.waiting or any(self._slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        unfinished = (len(self.waiting)
                      + sum(1 for r in self._slot_req if r is not None))
        if unfinished:
            for r in list(self._slot_req):
                if r is not None:
                    self.abort(r)
        wall = self._now() - self._epoch
        return summarize(
            self.finished,
            wall,
            n_aborted=len(self.aborted),
            n_unfinished=unfinished,
            n_preempted=self.manager.stats.preemptions,
            kv_hit_rate=self.manager.stats.kv_hit_rate(),
            state_hit_rate=self.manager.stats.state_hit_rate(),
            lora_hit_rate=self.manager.stats.lora_hit_rate(),
            invalid_kv_fraction=self.manager.invalid_kv_fraction(),
            hbm_utilization=self.manager.hbm_usage(),
            avg_prefill_batch=self.prefill.stats.mean_batch,
            prefill_compiles=self.prefill.compile_count,
            avg_step_ms=self._step_ms_sum / max(1, self._step_count),
            ema_step_ms=self.budget_ctl.ema_ms,
            budget_utilization=(self._budget_used / self._budget_avail
                                if self._budget_avail else 0.0),
        )

    def step(self) -> None:
        now = self._now()
        if self.swapper.due(now):
            self._observe_batch_size(now)
            self.swapper.tick(now)
            self._execute_swaps(self.manager.drain_ops())
        self._admit_waiting()
        t0 = time.perf_counter()
        if self.cfg.schedule_mode == "mixed":
            tokens, planned, budget = self._mixed_step()
        else:
            tokens = self._prefill_once() + self._decode_once()
            planned = budget = 0
        if tokens == 0:
            return  # idle step: nothing dispatched, nothing to observe
        step_ms = (time.perf_counter() - t0) * 1e3
        self.budget_ctl.observe(step_ms)
        self._step_count += 1
        self._step_ms_sum += step_ms
        if budget > 0:
            # utilization counts only tokens packed UNDER the budget —
            # catch-up decode tokens ride outside the plan
            self._budget_used += planned
            self._budget_avail += budget
        t_end = self._now()
        if self.tracer.enabled:
            self.tracer.span(
                TRACK_ENGINE, EV_STEP, now, t_end,
                tokens=tokens, planned=planned, budget=budget,
                step_ms=step_ms)
            self.tracer.counter("queue_depth", t_end,
                                waiting=float(len(self.waiting)))
            self.tracer.counter("hbm_usage", t_end,
                                frac=float(self.manager.hbm_usage()))
        self._batch_tokens.append((t_end, tokens))

    def _mixed_step(self) -> tuple[int, int, int]:
        """One Sarathi-style step: decode slots + budgeted prefill chunks in
        a single row-masked ``extend``.
        Returns (real tokens, budget-planned tokens, budget)."""
        # priority tier first, then admission order, not slot order: under a
        # binding budget the planner's waterfill favors earlier rows, so
        # within a tier the oldest prefill must come first or slot reuse
        # could starve it
        prefill_rows = sorted(
            (r for r in self._slot_req
             if r is not None and r.phase is Phase.PREFILLING),
            key=lambda r: (-r.priority, r.admit_time))
        decode_rows = [r for r in self._slot_req
                       if r is not None and r.phase is Phase.DECODE]
        if not prefill_rows and not decode_rows:
            return 0, 0, 0
        budget = self.budget_ctl.budget
        # interactive fast lane: above-batch-tier rows prefill greedily (up
        # to the chunk ceiling) before the leftover budget splits evenly, so
        # an interactive TTFT scales with its own prompt, not the number of
        # batch prefills in flight
        fast = frozenset(r.slot for r in prefill_rows
                         if r.priority > PRIORITY_BATCH)
        plan = plan_step(
            [r.slot for r in decode_rows],
            [(r.slot, len(r.prompt) - r.prefill_pos) for r in prefill_rows],
            budget=budget, chunk_ceiling=self._prefill_chunk,
            fast_slots=fast)
        if not plan.prefill_chunks:
            # pure-decode step: reuse the dedicated S=1 jit instead of
            # padding every decode token to the smallest prefill bucket
            n = self._decode_once()
            return n, n, budget
        by_slot = {r.slot: r for r in prefill_rows}
        chunks = dict(plan.prefill_chunks)
        clipped = self._clamp_state_chunks(chunks, by_slot)
        clipped += self._clamp_shared_chunks(chunks, by_slot)
        transitioned = self._run_chunks(by_slot, chunks, decode_rows)
        # catch-up decode: rows that completed prefill THIS step get their
        # second token from one S=1 dispatch, matching the per-request step
        # cadence of alternate mode (whose separate decode call picks fresh
        # rows up in the same step) — without it every request pays one
        # extra engine step at the prefill→decode transition
        catchup = self._decode_once(transitioned) if transitioned else 0
        tokens = plan.tokens - clipped
        return tokens + catchup, tokens, budget

    def _clamp_state_chunks(self, chunks: dict[int, int],
                            by_slot: dict[int, Request]) -> int:
        """Recurrent layouts: a chunk may not stride across a row's snapshot
        boundary — the state must be observable at exactly
        ``state_capture_at`` for :meth:`_run_chunks` to capture it (the
        recurrence is destructive; an intermediate state cannot be recovered
        later). Shrinks chunks in place; returns the clipped token count."""
        if not self._state_reusable:
            return 0
        clipped = 0
        for s, c in list(chunks.items()):
            r = by_slot[s]
            q = r.state_capture_at
            if r.staged_state is None and r.prefill_pos < q < r.prefill_pos + c:
                chunks[s] = q - r.prefill_pos
                clipped += c - chunks[s]
        return clipped

    def _shared_bound(self, req: Request) -> int:
        """Absolute prompt position where ``req``'s declared adapter-
        independent span ends (0 = none)."""
        return min(max(req.shared_prefix_len, 0), len(req.prompt))

    def _clamp_shared_chunks(self, chunks: dict[int, int],
                             by_slot: dict[int, Request]) -> int:
        """A chunk may not straddle a row's shared-prefix boundary: the SGMV
        adapter id is per ROW per dispatch, so base-model tokens (inside the
        declared shared span) and adapter tokens cannot share one chunk.
        Shrinks chunks in place; returns the clipped token count."""
        clipped = 0
        for s, c in list(chunks.items()):
            r = by_slot[s]
            b = self._shared_bound(r)
            if r.prefill_pos < b < r.prefill_pos + c:
                chunks[s] = b - r.prefill_pos
                clipped += c - chunks[s]
        return clipped

    def _run_chunks(self, by_slot: dict[int, Request],
                    chunks: dict[int, int],
                    decode_rows: list[Request]) -> list[Request]:
        """Assemble and dispatch ONE row-masked batch: per-slot prefill
        chunk slices plus (mixed mode) decode rider rows, then advance
        request state. Shared by the alternate and mixed schedulers so the
        transition bookkeeping cannot diverge between the two modes.
        Returns the rows that completed prefill and entered DECODE."""
        t_dispatch = self._now()
        bucket = self.prefill.bucket_for(max(chunks.values()))
        tokens, true_lens, row_mask = assemble_batch(
            self.cfg.max_batch_slots, bucket,
            {s: by_slot[s].prompt[by_slot[s].prefill_pos:
                                  by_slot[s].prefill_pos + c]
             for s, c in chunks.items()},
            {r.slot: r.generated[-1] for r in decode_rows})
        chunk_mask = np.zeros((self.cfg.max_batch_slots,), bool)
        for s in chunks:
            chunk_mask[s] = True
        ids = self._adapter_ids()
        # tokens/true_lens/row_mask/len stay host-side: BatchPrefill does its
        # stats math on them, and extend plans its cache writes from them
        # without a device round trip
        last_logits, self.cache = self.prefill(
            self.params, self.adapters.slots, self.cache,
            tokens, self.cache["len"],
            true_lens, row_mask, ids,
            stat_mask=chunk_mask,
        )
        # sampled tokens must reach Python for generation/finish
        # bookkeeping: ONE batched transfer per step is the right shape
        # libra: ignore[host-sync]
        toks = torch.argmax(last_logits, dim=-1).cpu().numpy()
        t_done = self._now()  # post-transfer: the dispatch actually finished
        for r in decode_rows:
            if self.tracer.enabled:
                self.tracer.span(slot_track(r.slot), EV_DECODE_STEP,
                                 t_dispatch, t_done, rid=r.request_id)
            r.generated.append(int(toks[r.slot]))
            self._maybe_finish(r)
        transitioned = []
        for s, c in chunks.items():
            r = by_slot[s]
            # TTFT attribution: [cursor, dispatch) was scheduler wait, the
            # dispatch itself splits recompute/compute by this chunk's share
            # of previously-computed history (preemption/eviction rebuild)
            r.charge("stall", t_dispatch)
            r.charge_prefill(
                t_done, c,
                max(0, min(r.prefill_pos + c, r.recompute_boundary)
                    - r.prefill_pos))
            if self.tracer.enabled:
                self.tracer.span(slot_track(s), EV_PREFILL_CHUNK,
                                 t_dispatch, t_done, rid=r.request_id,
                                 pos=r.prefill_pos, tokens=c)
            r.prefill_pos += c
            r.prefill_chunks += 1
            if (self._state_reusable and r.staged_state is None
                    and r.prefill_pos == r.state_capture_at):
                # the row's recurrence now sits exactly at the snapshot
                # boundary (chunks were clamped to land here): capture the
                # flat state, staged until commit folds it into the pool
                r.staged_state = self._flatten_row(s)
            if r.prefill_pos >= len(r.prompt):
                r.phase = Phase.DECODE
                r.generated.append(int(toks[r.slot]))
                if r.first_token_time is None:
                    # a resumed preemption victim keeps its TRUE first-token
                    # time from before the preemption
                    t_ft = self._now()
                    r.charge("compute", t_ft)  # closes the TTFT partition
                    r.first_token_time = t_ft
                self._maybe_finish(r)
                if r.phase is Phase.DECODE:
                    transitioned.append(r)
        return transitioned

    # ---------------------------------------------------------------- admit
    def _admission_rank(self, req: Request, now: float):
        """Admission sort key: priority tier first (higher = earlier), then
        least deadline slack — ``deadline − now − estimated TTFT``, the TTFT
        priced by the cost model's read-only probe (prefix recompute +
        host-KV/state transfer + adapter cold-start), so a request whose
        cached prefix makes it cheap to serve jumps ahead of one that must
        recompute everything — then FCFS on arrival. Requests without a
        deadline rank after deadline-bearing peers of their tier in plain
        arrival order, so a legacy trace (no tiers, no deadlines) admits in
        exactly the old FCFS order."""
        if req.deadline is None:
            slack = float("inf")
        else:
            est = self.manager.estimate_ttft(
                req.adapter_id, req.prompt[:-1],
                shared_prefix_len=req.shared_prefix_len)
            slack = req.deadline - now - est
        sub = req.submit_time if req.submit_time is not None else now
        return (-req.priority, slack, sub, req.request_id)

    def _admit_waiting(self) -> None:
        """Admit waiting requests in cost-ranked order; a request that
        outranks running work may preempt. One admission (or preemption) per
        pass — each changes pool state, so the queue re-ranks in between.
        The head of the *ranked* order gates the queue (no leapfrogging a
        blocked higher-ranked request with the resources it is waiting on);
        when it cannot start and no preemption applies, admission stalls
        until the next step, exactly like the old FCFS head-of-line break."""
        while self.waiting:
            now = self._now()
            head = sorted(self.waiting,
                          key=lambda r: self._admission_rank(r, now))[0]
            if self._free_slots and self._try_admit(head, now):
                continue
            if self._preempt_for(head, now):
                continue
            break

    def _try_admit(self, req: Request, now: float) -> bool:
        """lookup → admit/pin → allocate → slot → begin prefill; False (with
        pins rolled back) when HBM or running-block space is exhausted."""
        # match against prompt[:-1]: the last token is always recomputed
        # so prefill yields logits for it (vLLM semantics). Recurrent
        # layouts match state-snapshot boundaries instead of per-token KV
        # — the resumable prefix is the deepest payload snapshot.
        history = req.prompt[:-1]
        if self.tracer.enabled and req.ttft_predicted is None:
            # calibration series: sample the admission cost model's TTFT
            # estimate ONCE (first admission, pre-lookup so the probe sees
            # the same tree state the ranking did) for predicted-vs-actual
            req.ttft_predicted = self.manager.estimate_ttft(
                req.adapter_id, history,
                shared_prefix_len=req.shared_prefix_len)
        if self._state_reusable:
            lk = self.manager.lookup_state(req.adapter_id, history, now)
            matched = lk.state_tokens
        else:
            lk = self.manager.lookup(
                req.adapter_id, history, now,
                shared_prefix_len=req.shared_prefix_len)
            matched = lk.match.matched_tokens
        adm = self.manager.admit(lk, now)
        if adm.queued:
            self._execute_swaps(self.manager.drain_ops())
            return False  # HBM saturated; retry next step
        if self._state_reusable:
            # recurrent running memory is ONE fixed-size state row, not
            # per-token KV: reserve a single snapshot's blocks as the
            # admission throttle. Per-token phantom blocks would evict
            # real snapshots from the same pool to back bytes that the
            # architecture never allocates.
            total_new = self.manager.config.state_blocks * self.cfg.block_size
        else:
            total_new = len(req.prompt) - matched + req.max_new_tokens
        blocks = self.manager.allocate_running(req.request_id, total_new, now)
        if blocks is None:
            self.manager.unpin(adm.pinned)
            self._execute_swaps(self.manager.drain_ops())
            return False
        t0 = self._now()
        qstart = req.attrib_cursor  # queue-wait start (arrival or requeue)
        req.charge("queue", t0)
        # drained ops include demand evictions that freed this query's
        # blocks — execute them before touching the pool physically
        self._execute_swaps(self.manager.drain_ops(), req=req)
        self.waiting.remove(req)
        req.lookup = lk
        req.pinned = adm.pinned
        req.matched_tokens = matched
        req.hbm_hit_tokens = lk.hbm_hit_tokens
        req.admit_time = t0
        req.slot = self._free_slots.popleft()
        self._slot_req[req.slot] = req
        if self.tracer.enabled:
            if qstart is not None:
                self.tracer.span(TRACK_QUEUE, EV_QUEUE, qstart, t0,
                                 rid=req.request_id)
            self.tracer.instant(
                slot_track(req.slot),
                EV_RESUME if req.preempt_count else EV_ADMIT, t0,
                rid=req.request_id, adapter=req.adapter_id,
                matched=matched, hbm_hit=lk.hbm_hit_tokens)
        self._begin_prefill(req)
        return True

    def _preempt_for(self, req: Request, now: float) -> bool:
        """Preempt ONE running victim of strictly lower priority so ``req``
        can start. Victim choice is deterministic: lowest tier first, then
        no-deadline before farthest deadline, then youngest admission (least
        sunk work lost), then request id. Returns False (no preemption) when
        nothing running ranks strictly below ``req`` — equal-priority work
        is never preempted, so batch-only traffic keeps the old semantics
        and the admit/preempt loop terminates (every preemption removes a
        strictly-lower-priority row)."""
        victims = [r for r in self._slot_req
                   if r is not None and r.priority < req.priority
                   and r.phase in (Phase.PREFILLING, Phase.DECODE)]
        if not victims:
            return False
        victim = min(victims, key=lambda r: (
            r.priority,
            -(r.deadline if r.deadline is not None else float("inf")),
            -(r.admit_time if r.admit_time is not None else 0.0),
            r.request_id,
        ))
        self._preempt(victim, now)
        return True

    def _preempt(self, victim: Request, now: float) -> None:
        """Swap a running victim out through the two-tier pool and requeue
        it for token-identical resume.

        Unlike discard-preemption, the victim's computed work survives: its
        block-aligned computed KV is scattered into its running blocks and
        folded into the dependency tree via :meth:`CacheManager.
        preempt_running` (recurrent layouts fold a state snapshot captured at
        the current recurrence position instead) — ordinary evictable nodes
        the performance-driven swapper demotes to host under pressure. The
        tokens it generated fold into the prompt (kept in ``carried``), so
        the resume lookup matches the demoted prefix exactly: a decode-phase
        victim re-prefills just ONE token (the pending decode input) from
        its swapped KV/state and continues the identical output stream.
        """
        slot = victim.slot
        folded = len(victim.generated)
        # attribution: time since the last charge was spent running/waiting
        # in the slot; the preemption work itself lands in "other" below.
        # Also remember how far this request had computed — the resume
        # prefill below that boundary is "recompute", not fresh compute.
        victim.charge("stall", now)
        computed_upto = (len(victim.prompt) + folded - 1
                         if victim.phase is Phase.DECODE
                         else victim.prefill_pos)
        if self.tracer.enabled:
            self.tracer.instant(slot_track(slot), EV_PREEMPT, now,
                                rid=victim.request_id,
                                phase=victim.phase.value, folded=folded)
        if self._state_reusable:
            self._preempt_state(victim, now)
        else:
            m = victim.lookup.match
            prefix_len = m.matched_tokens
            if victim.phase is Phase.DECODE:
                # cache covers full_tokens[:-1]; generated[-1] is the
                # pending decode input, not yet attended — not committable
                computed = victim.prompt + tuple(victim.generated[:-1])
            else:
                computed = victim.prompt[: victim.prefill_pos]
            bs = self.cfg.block_size
            cache_tokens = ((len(computed) - prefix_len) // bs) * bs
            if cache_tokens > 0 and self.manager.config.reuse_history_kv:
                blocks = self.manager.running_blocks(victim.request_id)
                keep = blocks[: cache_tokens // bs]
                k, v = self._read_dense(
                    slot, prefix_len, prefix_len + cache_tokens)
                self.kv_pool.scatter(keep, k, v)
            self.manager.preempt_running(
                victim.request_id, victim.lookup, computed, now)
            self.manager.unpin(victim.pinned)
            self._execute_swaps(self.manager.drain_ops())
        # requeue: generated tokens fold into the prompt so the resume
        # lookup matches the demoted KV/state; they live on in `carried`
        # and max_new_tokens shrinks by the same count
        if folded:
            victim.prompt = victim.prompt + tuple(victim.generated)
            victim.carried.extend(victim.generated)
            victim.generated = []
            victim.max_new_tokens -= folded
        victim.lookup = None
        victim.pinned = []
        victim.matched_tokens = 0
        victim.hbm_hit_tokens = 0
        victim.prefill_pos = 0
        victim.state_capture_at = -1
        victim.phase = Phase.WAITING
        victim.preempt_count += 1
        victim.recompute_boundary = max(victim.recompute_boundary,
                                        computed_upto)
        victim.charge("other", self._now())  # swap-out/fold bookkeeping
        self._slot_req[slot] = None
        self._free_slots.append(slot)
        victim.slot = -1
        self.waiting.append(victim)

    def _preempt_state(self, victim: Request, now: float) -> None:
        """Recurrent layouts: fold the victim's state into the pool as a
        snapshot. The resumable boundary is wherever the recurrence actually
        sits: full_tokens[:-1] for a decode row (captured NOW — the
        recurrence is destructive), or the already-staged capture boundary
        mid-prefill; an uncrossed boundary has no snapshot and the victim
        re-prefills from its admission-time match."""
        if victim.phase is Phase.DECODE:
            snap = self._flatten_row(victim.slot)
            snap_at = len(victim.prompt) + len(victim.generated) - 1
        elif victim.staged_state is not None:
            snap, snap_at = victim.staged_state, victim.state_capture_at
        else:
            snap, snap_at = None, -1
        self.manager.preempt_running(victim.request_id, None, (), now)
        self.manager.unpin(victim.pinned)
        if snap is not None:
            prefix = (victim.prompt + tuple(victim.generated))[:snap_at]
            self._fold_snapshot(victim.adapter_id, prefix, snap, now)
        victim.staged_state = None

    def _fold_snapshot(self, adapter_id: str, prefix, snap: torch.Tensor,
                       now: float) -> None:
        """Fold one flattened state row into the pool as the STATE node of
        ``prefix`` (none where the pool has no room for it)."""
        node = self.manager.commit_state(adapter_id, prefix, now)
        # demand evictions that freed the snapshot's blocks must hit the
        # data plane BEFORE the store overwrites those rows
        self._execute_swaps(self.manager.drain_ops())
        if node is not None:
            self.state_cache.store(node.hbm_blocks, snap)

    def _begin_prefill(self, req: Request) -> None:
        """Gather the matched prefix into the slot's dense cache rows and
        stage the suffix for prefill. In bucketed mode the suffix is consumed
        chunk-by-chunk by :meth:`_prefill_once` (coalesced across requests);
        eager mode runs the whole suffix immediately at its exact shape."""
        slot = req.slot
        if self._state_reusable:
            prefix_len = self._seed_state_row(req)
        else:
            m = req.lookup.match
            prefix_len = m.matched_tokens
            # load matched prefix KV from pool blocks into the dense cache
            if prefix_len > 0:
                block_ids = [b for n in m.kv_nodes for b in n.hbm_blocks]
                k, v = self.kv_pool.gather(block_ids)
                self._write_dense(slot, 0, k, v)
        # ensure adapter slot present — unless the request starts inside its
        # shared span: base-model rows need no slot, so a shared-prefix hit
        # lets prefill begin while the adapter is still cold (_adapter_ids
        # lazily reloads once the row crosses the fork boundary)
        if prefix_len >= self._shared_bound(req):
            aid = self.adapters.slot_of(req.adapter_id)
            if aid is None:
                req.charge("other", self._now())
                aid = self.adapters.load(req.adapter_id)
                req.charge("lora_load", self._now())
        self._set_len(slot, prefix_len)
        req.prefill_pos = prefix_len
        req.charge("other", self._now())  # prefix gather/seed bookkeeping
        if self.cfg.prefill_mode == "eager":
            self._prefill_eager(req)
        else:
            req.phase = Phase.PREFILLING

    def _seed_state_row(self, req: Request) -> int:
        """Recurrent layouts: reset the slot's carried state (the dense row
        still holds the previous occupant's recurrence) and, on a snapshot
        hit, seed it from the pool so prefill covers only the un-snapshotted
        suffix. Also decides the capture boundary: ``len(prompt) - 1``, so an
        identical repeat matches the snapshot against ``prompt[:-1]`` and
        still recomputes its last token for first-token logits. Returns the
        resume boundary (0 = cold prefix)."""
        n_elems = self.state_spec.state_elems
        prefix_len = 0
        snode = req.lookup.state_node
        if (snode is not None and snode.tier is Residency.HBM
                and snode.hbm_blocks):
            # seeding writes every snapshot leaf of the row, so it doubles
            # as the reset of the previous occupant's carried state
            flat = self.state_cache.load(snode.hbm_blocks, n_elems)
            prefix_len = req.lookup.state_tokens
        else:
            flat = torch.zeros((n_elems,), dtype=self.state_spec.dtype,
                               device=self.device)
        unflatten_state(self.cache, req.slot, flat)
        req.matched_tokens = prefix_len
        q = len(req.prompt) - 1
        req.state_capture_at = q if q > prefix_len else -1
        return prefix_len

    def _flatten_row(self, slot: int) -> torch.Tensor:
        """The slot's state snapshot (a new device tensor)."""
        return flatten_state(self.cache, slot, dtype=self.state_spec.dtype)

    def _prefill_eager(self, req: Request) -> None:
        """Seed path: exact-shape ``model.extend`` over the full suffix. Kept
        as the correctness pin and ablation baseline for the bucketed
        subsystem. The suffix runs as spans split at the snapshot boundary
        of a recurrent layout, capturing the state in between (the
        recurrence is destructive), and at the shared-prefix boundary."""
        slot = req.slot
        pos0 = req.prefill_pos
        t_entry = self._now()
        # span cut points: the snapshot boundary (recurrent layouts) and the
        # shared-prefix boundary (base-model rows cannot share a dispatch
        # with adapter rows — the SGMV id is per row per call)
        cuts = set()
        q = req.state_capture_at
        if (self._state_reusable and req.staged_state is None
                and req.prefill_pos < q):
            cuts.add(q)
        sb = self._shared_bound(req)
        if req.prefill_pos < sb < len(req.prompt):
            cuts.add(sb)
        points = [req.prefill_pos] + sorted(cuts) + [len(req.prompt)]
        spans = list(zip(points, points[1:]))
        logits = None
        keep = np.zeros((self.cfg.max_batch_slots,), bool)
        keep[slot] = True
        for lo, hi in spans:
            suffix = np.asarray(req.prompt[lo:hi], np.int32)[None, :]
            ids = self._adapter_ids(base_rows=(slot,) if hi <= sb else ())
            # only this slot's row is written and advances its len
            logits, self.cache = self.model.extend(
                self.params, self.cache, self._pad_rows(suffix, slot),
                self.cache["len"], lora=self.adapters.slots, adapter_ids=ids,
                keep_rows=keep,
            )
            if hi == q and req.staged_state is None:
                req.staged_state = self._flatten_row(slot)
        req.prefill_pos = len(req.prompt)
        req.phase = Phase.DECODE
        # first sampled token must reach Python (eager fallback path,
        # one scalar transfer per admitted request)
        # libra: ignore[host-sync]
        tok = int(torch.argmax(logits[slot, -1]).cpu())
        req.generated.append(tok)
        t_done = self._now()
        if req.first_token_time is None:
            # attribution: the whole eager suffix dispatched in one go —
            # split by its previously-computed share, then close the window
            req.charge_prefill(
                t_done, len(req.prompt) - pos0,
                max(0, min(len(req.prompt), req.recompute_boundary) - pos0))
            req.first_token_time = t_done
        if self.tracer.enabled:
            self.tracer.span(slot_track(slot), EV_PREFILL_CHUNK,
                             t_entry, t_done, rid=req.request_id, pos=pos0,
                             tokens=len(req.prompt) - pos0, eager=True)
        self._maybe_finish(req)

    def _prefill_once(self) -> int:
        """One coalesced, bucketed prefill chunk for every PREFILLING row.

        All rows admitted (or still mid-prompt) this step share a single
        ``extend`` padded to the smallest bucket covering the largest
        pending chunk; per-row ``adapter_ids`` batch heterogeneous LoRAs via
        SGMV. Long prompts advance ``prefill_chunk`` tokens per step and
        yield to :meth:`_decode_once` in between (chunked prefill).
        Returns the number of real suffix tokens processed."""
        rows = [r for r in self._slot_req
                if r is not None and r.phase is Phase.PREFILLING]
        if not rows:
            return 0
        chunks = {r.slot: min(len(r.prompt) - r.prefill_pos, self._prefill_chunk)
                  for r in rows}
        self._clamp_state_chunks(chunks, {r.slot: r for r in rows})
        self._clamp_shared_chunks(chunks, {r.slot: r for r in rows})
        self._run_chunks({r.slot: r for r in rows}, chunks, [])
        return sum(chunks.values())

    def _pad_rows(self, row_tokens: np.ndarray, slot: int) -> np.ndarray:
        """Broadcast a single request's tokens into a full-slot batch."""
        out = np.zeros((self.cfg.max_batch_slots, row_tokens.shape[1]), np.int32)
        out[slot] = row_tokens[0]
        return out

    # --------------------------------------------------------------- decode
    def _decode_once(self, rows: Optional[list[Request]] = None) -> int:
        """One-token decode for every DECODE row (or just ``rows``);
        returns the number of tokens generated."""
        active = (rows if rows is not None else
                  [r for r in self._slot_req
                   if r is not None and r.phase is Phase.DECODE])
        if not active:
            return 0
        t0 = self._now()
        B = self.cfg.max_batch_slots
        tokens = np.zeros((B, 1), np.int32)
        for r in active:
            tokens[r.slot, 0] = r.generated[-1]
        keep = np.zeros((B,), bool)
        for r in active:
            keep[r.slot] = True
        ids = self._adapter_ids()
        # S=1 without a token mask: the paged decode route. Only the active
        # rows are written and advance len (a catch-up decode must not touch
        # a prefilling row; an idle row may sit at len == max_seq_len)
        logits, self.cache = self.model.extend(
            self.params, self.cache, tokens, self.cache["len"],
            lora=self.adapters.slots, adapter_ids=ids, keep_rows=keep,
        )
        self._decode_calls += 1
        # sampled tokens must reach Python for generation/finish
        # bookkeeping: ONE batched transfer per step is the right shape
        # libra: ignore[host-sync]
        toks = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        if self.tracer.enabled:
            t1 = self._now()
            for r in active:
                self.tracer.span(slot_track(r.slot), EV_DECODE_STEP,
                                 t0, t1, rid=r.request_id)
        for r in active:
            r.generated.append(int(toks[r.slot]))
            self._maybe_finish(r)
        return len(active)

    def _maybe_finish(self, req: Request) -> None:
        done = len(req.generated) >= req.max_new_tokens
        if self.cfg.eos_token >= 0 and req.generated[-1] == self.cfg.eos_token:
            done = True
        if not done:
            return
        now = self._now()
        req.finish_time = now
        req.phase = Phase.FINISHED
        self._commit(req, now)
        self._slot_req[req.slot] = None
        self._free_slots.append(req.slot)
        self.finished.append(req)
        if self.tracer.enabled:
            self.tracer.instant(slot_track(req.slot), EV_FINISH, now,
                                rid=req.request_id,
                                tokens=len(req.output_tokens))
            att = req.ttft_attribution()
            if att is not None:
                self.tracer.instant(
                    TRACK_QUEUE, EV_TTFT_ATTRIBUTION, now,
                    rid=req.request_id, ttft=req.ttft,
                    **{c: att.get(c, 0.0) for c in ATTRIB_CATEGORIES})
            if req.ttft_predicted is not None and req.ttft is not None:
                self.tracer.instant(
                    TRACK_QUEUE, EV_CALIBRATION, now, rid=req.request_id,
                    predicted=req.ttft_predicted, actual=req.ttft)

    def _commit(self, req: Request, now: float) -> None:
        """Scatter the request's new KV into its running blocks and fold them
        into the dependency tree."""
        if self._state_reusable:
            # recurrent state is not per-token pool KV: release the running
            # blocks and fold the staged boundary snapshot (if any) into the
            # unified pool as a STATE node instead
            self.manager.abort_running(req.request_id)
            if req.staged_state is not None:
                self._fold_snapshot(req.adapter_id, req.prompt[: req.state_capture_at],
                                    req.staged_state, now)
                req.staged_state = None
            self.manager.unpin(req.pinned)
            return
        m = req.lookup.match
        prefix = m.matched_tokens
        full = req.full_tokens
        bs = self.cfg.block_size
        suffix_total = len(full) - prefix
        cache_tokens = (suffix_total // bs) * bs
        if cache_tokens > 0 and self.manager.config.reuse_history_kv:
            blocks = self.manager.running_blocks(req.request_id)
            keep = blocks[: cache_tokens // bs]
            k, v = self._read_dense(req.slot, prefix, prefix + cache_tokens)
            self.kv_pool.scatter(keep, k, v)
        self.manager.commit(req.request_id, req.lookup, full, now)
        self.manager.unpin(req.pinned)

    # ------------------------------------------------------------ swaps
    def _execute_swaps(self, ops, req: Optional[Request] = None) -> None:
        for op in ops:
            t0 = self._now()
            if op.node_kind is NodeKind.LORA:
                if op.kind is SwapKind.SWAP_IN:
                    self.adapters.load(op.lora_id)
                elif op.kind in (SwapKind.SWAP_OUT, SwapKind.DROP):
                    self.adapters.unload(op.lora_id)
            elif op.node_kind is NodeKind.STATE:
                # whole-snapshot moves through the two-tier StateCache
                if op.kind is SwapKind.SWAP_IN:
                    self.state_cache.swap_in(op.src_blocks, op.dst_blocks)
                elif op.kind is SwapKind.SWAP_OUT:
                    self.state_cache.swap_out(op.src_blocks, op.dst_blocks)
                # DROP: nothing physical to do
            elif op.kind is not SwapKind.DROP and self.kv_pool is None:
                raise RuntimeError(
                    f"a KV swap ({op.kind.value}, node {op.node_id}) on a "
                    f"recurrent layout, which has no KV pool")
            else:
                if op.kind is SwapKind.SWAP_IN:
                    self.kv_pool.swap_in(op.src_blocks, op.dst_blocks)
                elif op.kind is SwapKind.SWAP_OUT:
                    self.kv_pool.swap_out(op.src_blocks, op.dst_blocks)
                # DROP: nothing physical to do
            t1 = self._now()
            if req is not None:
                # cold-start accounting (paper Fig. 12): swap-ins only
                if op.kind is SwapKind.SWAP_IN:
                    if op.node_kind is NodeKind.LORA:
                        req.lora_coldstart += t1 - t0
                    else:
                        req.kv_coldstart += t1 - t0
                # TTFT attribution: every op on an admission's critical
                # path is charged — demand evictions that freed this
                # request's blocks ride the swap_in bucket
                lora_in = (op.node_kind is NodeKind.LORA
                           and op.kind is SwapKind.SWAP_IN)
                req.charge("lora_load" if lora_in else "swap_in", t1)
            if self.tracer.enabled:
                self.tracer.span(
                    TRACK_SWAPPER, "swap." + op.kind.value, t0, t1,
                    kind=op.node_kind.name, lora=op.lora_id,
                    bytes=op.nbytes, node=op.node_id)

    # ------------------------------------------------------------- helpers
    def _adapter_ids(self, base_rows: tuple[int, ...] = ()) -> np.ndarray:
        """Per-row adapter slots for the SGMV path.

        A request whose adapter was evicted mid-flight must NOT silently run
        through slot 0 (someone else's LoRA): reload it, charging the
        cold-start to the request. Raises if no slot can be freed.

        Rows still prefilling inside their declared shared span — and any
        slot in ``base_rows`` (the eager path's explicit per-span override) —
        get id -1: the LoRA delta is masked to zero (base-model row), so the
        span's KV is adapter-independent AND the dispatch needs no adapter
        slot at all (a prefill can start from a shared-prefix hit while its
        adapter is still cold; the reload is deferred to the first span past
        the boundary)."""
        ids = np.zeros((self.cfg.max_batch_slots,), np.int32)
        for r in self._slot_req:
            if r is not None:
                if r.slot in base_rows or (
                        r.phase is Phase.PREFILLING
                        and r.prefill_pos < self._shared_bound(r)):
                    ids[r.slot] = -1
                    continue
                s = self.adapters.slot_of(r.adapter_id)
                if s is None:
                    s = self._reload_adapter(r)
                ids[r.slot] = s
        return ids

    def _reload_adapter(self, req: Request) -> int:
        """Reload ``req``'s evicted adapter, evicting an idle resident one
        (not referenced by any active request) if all slots are taken."""
        t0 = self._now()
        try:
            s = self.adapters.load(req.adapter_id)
        except RuntimeError:
            active = {r.adapter_id for r in self._slot_req if r is not None}
            victim = next(
                (a for a in self.adapters.resident if a not in active), None)
            if victim is None:
                raise  # every slot pinned by an in-flight request
            self.adapters.unload(victim)
            s = self.adapters.load(req.adapter_id)
        req.lora_coldstart += self._now() - t0
        req.charge("lora_load", self._now())
        return s

    def _set_len(self, slot: int, value: int) -> None:
        self.cache["len"][slot] = value

    def _write_dense(self, slot: int, start: int, k, v) -> None:
        """Place gathered prefix KV (L, T, H, D) into the dense cache rows;
        for MLA, k is (latent ‖ k_rope) as one pseudo-head and v is None."""
        T = k.shape[1]
        if self.model_cfg.mla is not None:
            r = self.model_cfg.mla.kv_lora_rank
            self.cache["latent"][:, slot, start:start + T] = k[..., 0, :r]
            self.cache["krope"][:, slot, start:start + T] = k[..., 0, r:]
            return
        self.cache["k"][:, slot, start:start + T] = k
        self.cache["v"][:, slot, start:start + T] = v

    def _read_dense(self, slot: int, start: int, end: int):
        """Read dense cache rows back as (L, T, H, D) for pool scatter (for
        MLA: (latent ‖ k_rope) (L, T, 1, kv_lora + rope) and None)."""
        if self.model_cfg.mla is not None:
            k = torch.cat([self.cache["latent"][:, slot, start:end],
                           self.cache["krope"][:, slot, start:end]], dim=-1)
            return k[:, :, None, :], None
        return (self.cache["k"][:, slot, start:end],
                self.cache["v"][:, slot, start:end])

    def _observe_batch_size(self, now: float) -> None:
        """Report the unified mixed-batch token load to the swapper.

        The signal is the per-step REAL token count of the (mixed or
        alternate) batch — decode rows contribute 1 token, prefill rows
        their chunk slice — averaged over the last 5 s. Before the mixed
        scheduler the swapper saw decode-slot occupancy only, blind to the
        prefill share of the batch (Eq. 3's BS under-counted under load)."""
        while self._batch_tokens and self._batch_tokens[0][0] < now - 5.0:
            self._batch_tokens.popleft()
        # an empty window means the engine has been idle for 5 s: observe 0
        # so the demand signal decays instead of freezing at the last busy
        # value (idle steps append nothing to the deque)
        avg = (sum(b for _, b in self._batch_tokens) / len(self._batch_tokens)
               if self._batch_tokens else 0.0)
        self.swapper.observe_batch_size(avg)
