"""Discrete-event multi-LoRA serving simulator.

Drives the *real* FASTLIBRA control plane (``repro_torch.core`` — the identical
code the JAX engine uses) with a virtual clock and the paper's NPU timing
model, so the paper's figures can be reproduced at Llama-7B/13B/34B scale on
a CPU container. The simulation is iteration-driven (like real continuous-
batching engines): each loop admits ready queries, runs one prefill+decode
iteration whose duration comes from :class:`DeployedModel`, and advances
virtual time.

Async swap modelling: host↔HBM transfers queue on full-duplex PCIe channels;
control-plane state flips instantly (the manager's view) but a query whose
required LoRA / KV nodes are still in flight cannot start prefill until its
``ready_time`` — this is exactly the cold-start component of TTFT the paper
measures (Fig. 12 breakdown).

Straggler mitigation (beyond-paper): if an inbound transfer would delay a
query past ``straggler_timeout``, the simulator falls back to recomputing
the prefix (hedged recompute) and counts the mitigation.
"""

from __future__ import annotations

import dataclasses
import heapq
import statistics
from collections import deque
from typing import Optional

from ..core import CacheManager, CacheSwapper, NodeKind, SwapKind, make_fastlibra
from ..core.cost_model import HardwareModel
from ..data.traces import SimQuery
from ..obs import (
    ATTRIB_CATEGORIES,
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
    Tracer,
    trace_env_enabled,
)
from .hardware import DeployedModel


@dataclasses.dataclass
class SimConfig:
    variant: str = "fastlibra"
    max_batch: int = 32
    block_size: int = 32
    lora_rank_choices: tuple[int, ...] = (32, 64)
    activation_reserve: float = 0.10
    straggler_p: float = 0.0  # probability a transfer is 10x slow
    straggler_timeout: float = 1.0
    sample_period: float = 5.0  # timeline sampling
    # step scheduling (mirrors EngineConfig.schedule_mode):
    # "alternate" — a ready prefill runs its whole suffix in one iteration
    #               (decode rides the same iteration but pays the full
    #               prefill latency: TPOT spikes under prefill load);
    # "mixed"     — Sarathi-style: decode tokens take 1 budget token each,
    #               prefill suffixes advance chunk-by-chunk with whatever
    #               budget remains, so iteration time stays bounded.
    schedule_mode: str = "alternate"
    step_token_budget: int = 512  # per-iteration token budget (mixed mode)
    # cross-adapter prefix sharing: cache declared adapter-independent spans
    # once on the shared trunk (False = per-adapter baseline)
    share_prefix_kv: bool = True
    # libra-trace parity: arm the same Tracer/event vocabulary the engine
    # uses (also armed by REPRO_TRACE=1, like EngineConfig.trace)
    trace: bool = dataclasses.field(default_factory=trace_env_enabled)
    trace_capacity: int = 200_000


@dataclasses.dataclass
class SimRequest:
    query: SimQuery
    ready_time: float = 0.0
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    matched_tokens: int = 0
    hbm_hit_tokens: int = 0
    lora_coldstart: float = 0.0
    kv_coldstart: float = 0.0
    queue_time: float = 0.0
    tokens_done: int = 0
    lookup: object = None
    pinned: list = dataclasses.field(default_factory=list)
    rid: str = ""
    # mixed-mode chunked prefill progress (suffix tokens already computed)
    prefill_done: int = 0
    # swap-preserving preemption: output tokens produced before a preemption
    # fold into the effective prompt (mirrors the engine's Request.carried),
    # so the resume lookup matches the victim's own demoted KV/state and
    # decode continues from token carried+1 — never recomputed divergently
    carried: int = 0
    preempt_count: int = 0
    # libra-trace TTFT attribution (mirrors serving.Request): an exact
    # additive partition of [arrival, first_token_time] on the VIRTUAL clock
    attribution: dict = dataclasses.field(default_factory=dict)
    attrib_cursor: Optional[float] = None
    ttft_predicted: Optional[float] = None

    def charge(self, category: str, t: float) -> None:
        """Attribute [attrib_cursor, t) to ``category`` and advance the
        cursor; closed once the first token lands (see Request.charge)."""
        if self.attrib_cursor is None or self.first_token_time is not None:
            return
        dt = t - self.attrib_cursor
        if dt > 0:
            self.attribution[category] = self.attribution.get(category, 0.0) + dt
            self.attrib_cursor = t

    @property
    def eff_prompt(self) -> tuple[int, ...]:
        """Prompt plus carried output tokens — what a resume prefills
        against (== query.prompt for a never-preempted request)."""
        q = self.query
        return q.full[: len(q.prompt) + self.carried]

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.query.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        return (self.finish_time - self.first_token_time) / max(
            1, self.query.output_len - 1
        )


@dataclasses.dataclass
class SimResult:
    finished: list[SimRequest]
    timeline: list[dict]
    duration: float
    manager: CacheManager
    straggler_mitigations: int = 0

    @property
    def avg_ttft(self) -> float:
        v = [r.ttft for r in self.finished if r.ttft is not None]
        return statistics.fmean(v) if v else 0.0

    @property
    def avg_tpot(self) -> float:
        v = [r.tpot for r in self.finished if r.tpot is not None]
        return statistics.fmean(v) if v else 0.0

    @property
    def avg_queue(self) -> float:
        v = [r.queue_time for r in self.finished]
        return statistics.fmean(v) if v else 0.0

    @property
    def avg_lora_coldstart(self) -> float:
        v = [r.lora_coldstart for r in self.finished]
        return statistics.fmean(v) if v else 0.0

    @property
    def avg_kv_coldstart(self) -> float:
        v = [r.kv_coldstart for r in self.finished]
        return statistics.fmean(v) if v else 0.0

    def summary(self) -> dict:
        s = self.manager.stats
        inv = [t["invalid_kv"] for t in self.timeline] or [0.0]
        hbm = [t["hbm_usage"] for t in self.timeline] or [0.0]
        return {
            "n": len(self.finished),
            "avg_ttft": self.avg_ttft,
            "avg_tpot": self.avg_tpot,
            "avg_queue": self.avg_queue,
            "avg_lora_cold": self.avg_lora_coldstart,
            "avg_kv_cold": self.avg_kv_coldstart,
            "kv_hit_rate": s.kv_hit_rate(),
            "state_hit_rate": s.state_hit_rate(),
            "lora_hit_rate": s.lora_hit_rate(),
            "avg_invalid_kv": statistics.fmean(inv),
            "avg_hbm_usage": statistics.fmean(hbm),
            "throughput": len(self.finished) / max(1e-9, self.duration),
        }


class ServingSimulator:
    def __init__(
        self,
        deployed: DeployedModel,
        trace: list[SimQuery],
        config: Optional[SimConfig] = None,
        seed: int = 0,
    ):
        import random

        self.cfg = config or SimConfig()
        self.hw = deployed
        self.trace = trace
        self.rng = random.Random(seed)
        pool_bytes = deployed.hbm_pool_bytes(self.cfg.activation_reserve)
        hw_model = HardwareModel(
            pcie_bw_bytes=deployed.npu.pcie_bw,
            pcie_latency_s=deployed.npu.pcie_latency,
            hbm_bytes=pool_bytes,
            host_bytes=deployed.npu.host_bytes,
            flops_fp16=deployed.npu.flops_fp16 * deployed.cards,
            # the recompute a retained snapshot saves, from the same roofline
            # that prices this model's prefill iterations
            prefill_s_per_token=deployed.prefill_time(1, 0),
        )
        # recurrent archs: the prefix layer is state snapshots, and TTFT is
        # snapshot-aware — a matched boundary shrinks the prefill suffix
        self._state_mode = deployed.is_recurrent
        self.tracer = (
            Tracer(capacity=self.cfg.trace_capacity)
            if self.cfg.trace else NULL_TRACER
        )
        self.manager, self.swapper = make_fastlibra(
            pool_bytes,
            deployed.npu.host_bytes,
            kv_bytes_per_token=deployed.kv_bytes_per_token,
            block_size=self.cfg.block_size,
            hardware=hw_model,
            variant=self.cfg.variant,
            state_bytes=deployed.state_snapshot_bytes,
            share_prefix_kv=self.cfg.share_prefix_kv,
            tracer=self.tracer,
        )
        # register every LoRA in the trace (host-resident at t=0)
        for lid in sorted({q.lora_id for q in trace}):
            rank = self.rng.choice(self.cfg.lora_rank_choices)
            nbytes = deployed.cfg.lora_bytes(rank, deployed.npu.dtype_bytes)
            self.manager.register_lora(lid, nbytes, now=0.0)
        # PCIe full-duplex channels: (free_at) per direction
        self._pcie_in = 0.0
        self._pcie_out = 0.0
        self._out_done = 0.0
        self._node_ready: dict[int, float] = {}
        self.straggler_mitigations = 0

    # ------------------------------------------------------------ transfers
    def _schedule_transfer(self, nbytes: int, now: float, inbound: bool) -> float:
        t = self.hw.transfer_time(nbytes)
        if self.cfg.straggler_p and self.rng.random() < self.cfg.straggler_p:
            t *= 10.0
        if inbound:
            start = max(now, self._pcie_in)
            self._pcie_in = start + t
            return self._pcie_in
        start = max(now, self._pcie_out)
        self._pcie_out = start + t
        return self._pcie_out

    def _execute_ops(self, ops, now: float) -> None:
        self._out_done = now
        for op in ops:
            if op.kind is SwapKind.SWAP_IN:
                done = self._schedule_transfer(op.nbytes, now, inbound=True)
                self._node_ready[op.node_id] = done
            elif op.kind is SwapKind.SWAP_OUT:
                self._out_done = max(
                    self._out_done,
                    self._schedule_transfer(op.nbytes, now, inbound=False),
                )

    # --------------------------------------------------------- SLO policy
    def _admission_rank(self, r: SimRequest, now: float):
        """Admission sort key (mirrors ``ServingEngine._admission_rank``):
        priority tier desc, then least deadline slack — the cost model's
        read-only TTFT estimate prices prefix recompute, host transfers,
        and adapter cold-start — then FCFS arrival, then rid."""
        q = r.query
        if q.deadline is None:
            slack = float("inf")
        else:
            est = self.manager.estimate_ttft(
                q.lora_id, r.eff_prompt[:-1],
                shared_prefix_len=q.shared_prefix_len)
            slack = q.deadline - now - est
        return (-q.priority, slack, q.arrival, r.rid)

    def _preempt(self, victim: SimRequest, now: float) -> None:
        """Swap-preserving preemption (mirrors ``ServingEngine._preempt``):
        the victim's computed prefix — everything up to its pending decode
        token — folds into the dependency tree (KV) or snapshots at that
        boundary (recurrent state), where the swapper demotes it to host
        under pressure instead of discarding it. Its produced tokens fold
        into the effective prompt (``carried``), so the resume lookup
        matches the demoted work and decode continues token-identically;
        the victim keeps its true first-token time."""
        q = victim.query
        boundary = len(q.prompt) + victim.tokens_done - 1
        if self._state_mode:
            self.manager.preempt_running(victim.rid, None, (), now)
            self.manager.commit_state(q.lora_id, q.full[:boundary], now)
        else:
            self.manager.preempt_running(
                victim.rid, victim.lookup, q.full[:boundary], now)
        self.manager.unpin(victim.pinned)
        self._execute_ops(self.manager.drain_ops(), now)
        victim.carried = victim.tokens_done
        victim.lookup = None
        victim.pinned = []
        victim.matched_tokens = 0
        victim.hbm_hit_tokens = 0
        victim.prefill_done = 0
        victim.preempt_count += 1
        if self.tracer.enabled:
            self.tracer.instant(
                TRACK_ENGINE, EV_PREEMPT, now,
                rid=victim.rid, folded=victim.tokens_done)

    def export_trace(self, path: str) -> None:
        """Dump the collected trace as Chrome trace-event JSON."""
        self.tracer.dump(path)

    # ------------------------------------------------------------ main loop
    def run(self) -> SimResult:
        cfg = self.cfg
        arrivals = [(q.arrival, i, q) for i, q in enumerate(self.trace)]
        heapq.heapify(arrivals)
        waiting: deque[SimRequest] = deque()
        pending: list[SimRequest] = []  # admitted, waiting on transfers
        running: list[SimRequest] = []
        finished: list[SimRequest] = []
        timeline: list[dict] = []
        now = 0.0
        next_sample = 0.0
        rid = 0
        # unified batch load: last iteration's real tokens (decode rows
        # contribute 1 each, prefill rows their chunk) — same signal the
        # engine feeds the swapper under the mixed scheduler
        batch_window: deque[tuple[float, int]] = deque()
        last_iter_tokens = 0

        recent_ttfts: deque[tuple[float, float]] = deque()

        def sample(now):
            while recent_ttfts and recent_ttfts[0][0] < now - cfg.sample_period:
                recent_ttfts.popleft()
            window = [v for _, v in recent_ttfts]
            bd = self.manager.hbm_breakdown()
            timeline.append({
                "t": now,
                "hbm_usage": self.manager.hbm_usage(),
                "invalid_kv": self.manager.invalid_kv_fraction(),
                "resident_loras": self.manager.tree.resident_lora_count(),
                "running": len(running),
                "waiting": len(waiting) + len(pending),
                "window_ttft": statistics.fmean(window) if window else 0.0,
                **bd,
            })

        while arrivals or waiting or pending or running:
            # pull arrivals
            while arrivals and arrivals[0][0] <= now:
                _, _, q = heapq.heappop(arrivals)
                rid += 1
                r = SimRequest(query=q, rid=f"q{rid}")
                r.attrib_cursor = q.arrival
                waiting.append(r)
                if self.tracer.enabled:
                    self.tracer.instant(
                        TRACK_QUEUE, EV_SUBMIT, q.arrival, rid=r.rid,
                        adapter=q.lora_id, prompt_tokens=len(q.prompt))
            # periodic swapper (proactive: transfers happen in the background,
            # off every query's critical path — FASTLIBRA's key advantage)
            if self.swapper.due(now):
                batch_window.append((now, last_iter_tokens))
                while batch_window and batch_window[0][0] < now - 5.0:
                    batch_window.popleft()
                if batch_window:
                    self.swapper.observe_batch_size(
                        sum(b for _, b in batch_window) / len(batch_window)
                    )
                self.swapper.tick(now)
                self._execute_ops(self.manager.drain_ops(), now)
            # admit — cost-ranked (priority tier, then least deadline slack,
            # then FCFS); a blocked higher-tier head may preempt a strictly
            # lower-priority running victim instead of waiting behind it
            while waiting:
                r = sorted(waiting,
                           key=lambda w: self._admission_rank(w, now))[0]
                q = r.query
                lk = adm = None
                blocked = len(running) + len(pending) >= cfg.max_batch
                if not blocked:
                    prompt = r.eff_prompt
                    if self.tracer.enabled and r.ttft_predicted is None:
                        # pre-lookup, so the estimate prices the cold start
                        # this admission is about to pay (calibration series)
                        r.ttft_predicted = self.manager.estimate_ttft(
                            q.lora_id, prompt[:-1],
                            shared_prefix_len=q.shared_prefix_len)
                    if self._state_mode:
                        lk = self.manager.lookup_state(
                            q.lora_id, prompt[:-1], now)
                        matched = lk.state_tokens
                    else:
                        lk = self.manager.lookup(
                            q.lora_id, prompt[:-1], now,
                            shared_prefix_len=q.shared_prefix_len)
                        matched = lk.match.matched_tokens
                    adm = self.manager.admit(lk, now)
                    if adm.queued:
                        self._execute_ops(self.manager.drain_ops(), now)
                        blocked = True
                if not blocked:
                    # lazy allocation (vLLM semantics): prefill blocks now,
                    # decode blocks one iteration at a time (stall when HBM
                    # is full). Recurrent state is O(1) per request: reserve
                    # one snapshot's blocks instead of phantom per-token KV.
                    if self._state_mode:
                        need = (self.manager.config.state_blocks
                                * self.cfg.block_size)
                    else:
                        need = len(prompt) - matched
                    blocks = self.manager.allocate_running(r.rid, need, now)
                    if blocks is None:
                        self.manager.unpin(adm.pinned)
                        self._execute_ops(self.manager.drain_ops(), now)
                        blocked = True
                if blocked:
                    victims = [v for v in running
                               if v.query.priority < q.priority]
                    if not victims:
                        break
                    victim = min(victims, key=lambda v: (
                        v.query.priority,
                        -(v.query.deadline if v.query.deadline is not None
                          else float("inf")),
                        -(v.admit_time if v.admit_time is not None else 0.0),
                        v.rid,
                    ))
                    running.remove(victim)
                    self._preempt(victim, now)
                    waiting.appendleft(victim)
                    continue
                waiting.remove(r)
                r.lookup = lk
                r.pinned = adm.pinned
                r.matched_tokens = matched
                r.hbm_hit_tokens = lk.hbm_hit_tokens
                r.admit_time = now
                r.queue_time = now - q.arrival
                qstart = r.attrib_cursor
                r.charge("queue", now)
                if self.tracer.enabled:
                    if qstart is not None and now > qstart:
                        self.tracer.span(
                            TRACK_QUEUE, EV_QUEUE, qstart, now, rid=r.rid)
                    self.tracer.instant(
                        TRACK_QUEUE,
                        EV_RESUME if r.preempt_count else EV_ADMIT, now,
                        rid=r.rid, adapter=q.lora_id, matched=matched,
                        hbm_hit=r.hbm_hit_tokens)
                # everything this admission moved — swap-ins of the needed
                # nodes AND demand-eviction swap-outs that freed its blocks —
                # is on this query's critical path (synchronous cold start)
                lora0, kv0 = r.lora_coldstart, r.kv_coldstart
                ops = self.manager.drain_ops()
                self._execute_ops(ops, now)
                ready = now
                for op in ops:
                    if op.kind is SwapKind.SWAP_IN:
                        done = self._node_ready.get(op.node_id, now)
                        if op.node_kind is NodeKind.LORA:
                            r.lora_coldstart += max(0.0, done - now)
                        else:
                            r.kv_coldstart += max(0.0, done - now)
                        ready = max(ready, done)
                    elif op.kind is SwapKind.SWAP_OUT:
                        done = self._out_done
                        r.kv_coldstart += max(0.0, done - now)
                        ready = max(ready, done)
                # also wait for matched nodes already in flight
                for n in lk.match.kv_nodes:
                    ready = max(ready, self._node_ready.get(n.node_id, now))
                if lk.match.lora_node is not None:
                    ready = max(
                        ready, self._node_ready.get(lk.match.lora_node.node_id, now)
                    )
                # straggler mitigation: recompute instead of waiting too long
                if ready - now > cfg.straggler_timeout:
                    self.straggler_mitigations += 1
                    r.matched_tokens = 0
                    r.hbm_hit_tokens = 0
                    ready = now
                if ready > now:
                    # the synchronous cold-start wait: split the wall time
                    # between lora_load and swap_in in proportion to the
                    # per-channel cold-start this admission accrued
                    dl = r.lora_coldstart - lora0
                    dk = r.kv_coldstart - kv0
                    if dl > 0:
                        frac = dl / (dl + dk) if (dl + dk) > 0 else 1.0
                        r.charge("lora_load", now + (ready - now) * frac)
                    r.charge("swap_in", ready)
                r.ready_time = ready
                r.prefill_done = 0
                pending.append(r)
            # build one iteration
            ready_prefills = [r for r in pending if r.ready_time <= now]
            if ready_prefills or running:
                t_iter = 0.0
                t_start = now
                entered: list[SimRequest] = []  # prefills completing now
                chunks: list[tuple[SimRequest, int]] = []  # (req, tokens)
                prefill_tokens = 0
                if cfg.schedule_mode == "mixed":
                    # Sarathi-style: decode tokens (1 per running request)
                    # come off the top of the budget; prefill suffixes
                    # advance chunk-by-chunk with the remainder, so one long
                    # prompt cannot blow up this iteration's duration
                    budget = max(cfg.step_token_budget - len(running), 1)
                    # interactive fast lane (mirrors plan_step fast_slots):
                    # higher tiers drain the budget first, FCFS within a tier
                    for r in sorted(ready_prefills,
                                    key=lambda r: (-r.query.priority,
                                                   r.query.arrival, r.rid)):
                        if budget <= 0:
                            break
                        left = (len(r.eff_prompt) - r.matched_tokens
                                - r.prefill_done)
                        take = min(left, budget)
                        t_iter += self.hw.prefill_time(
                            take, r.matched_tokens + r.prefill_done)
                        r.prefill_done += take
                        budget -= take
                        prefill_tokens += take
                        chunks.append((r, take))
                        if (r.prefill_done
                                >= len(r.eff_prompt) - r.matched_tokens):
                            entered.append(r)
                            pending.remove(r)
                else:
                    for r in ready_prefills:
                        pending.remove(r)
                        new = len(r.eff_prompt) - r.matched_tokens
                        t_iter += self.hw.prefill_time(new, r.matched_tokens)
                        prefill_tokens += new
                        chunks.append((r, new))
                        entered.append(r)
                ctx = sum(
                    len(r.query.prompt) + r.tokens_done for r in running
                )
                t_iter += self.hw.decode_time(len(running), ctx)
                last_iter_tokens = len(running) + prefill_tokens
                now += max(t_iter, 1e-6)
                # attribution: time a ready prefill sat past its ready_time
                # is "stall", its share of this iteration is "compute" —
                # charged before first_token_time closes the window below
                for r, take in chunks:
                    r.charge("stall", t_start)
                    r.charge("compute", now)
                if self.tracer.enabled:
                    for r, take in chunks:
                        self.tracer.span(
                            TRACK_ENGINE, EV_PREFILL_CHUNK, t_start, now,
                            rid=r.rid, tokens=take)
                    if running:
                        self.tracer.span(
                            TRACK_ENGINE, EV_DECODE_STEP, t_start, now,
                            rows=len(running))
                    self.tracer.span(
                        TRACK_ENGINE, EV_STEP, t_start, now,
                        tokens=last_iter_tokens)
                    self.tracer.counter(
                        "queue_depth", now,
                        waiting=float(len(waiting) + len(pending)))
                    self.tracer.counter(
                        "hbm_usage", now, frac=float(self.manager.hbm_usage()))
                for r in entered:
                    if r.first_token_time is None:
                        # a resumed preemption victim keeps its TRUE first-
                        # token time from before the preemption
                        r.first_token_time = now
                        recent_ttfts.append((now, r.ttft))
                    r.tokens_done = r.carried + 1
                    running.append(r)
                still = []
                any_progress = bool(entered) or prefill_tokens > 0
                stalled: list[SimRequest] = []
                for r in running:
                    if r in entered:
                        pass
                    else:
                        # decode KV growth is allocated lazily; a full pool
                        # stalls the request this iteration (TPOT grows).
                        # Recurrent decode consumes no extra memory.
                        got = ([] if self._state_mode else
                               self.manager.allocate_running(r.rid, 1, now))
                        if got is None:
                            stalled.append(r)
                            continue
                        r.tokens_done += 1
                        any_progress = True
                    if r.tokens_done >= r.query.output_len:
                        r.finish_time = now
                        if self._state_mode:
                            # fold a snapshot at the len(prompt)-1 boundary
                            # (mirrors the engine's capture point; for a
                            # resumed victim the boundary is its effective
                            # prompt's) instead of per-token KV; running
                            # blocks just release
                            self.manager.abort_running(r.rid)
                            self.manager.commit_state(
                                r.query.lora_id, r.eff_prompt[:-1], now)
                        else:
                            self.manager.commit(r.rid, r.lookup, r.query.full, now)
                        self.manager.unpin(r.pinned)
                        finished.append(r)
                        if self.tracer.enabled:
                            self.tracer.instant(
                                TRACK_ENGINE, EV_FINISH, now,
                                rid=r.rid, tokens=r.tokens_done)
                            if r.ttft is not None:
                                att = r.attribution
                                self.tracer.instant(
                                    TRACK_QUEUE, EV_TTFT_ATTRIBUTION, now,
                                    rid=r.rid, ttft=r.ttft,
                                    **{c: att.get(c, 0.0)
                                       for c in ATTRIB_CATEGORIES})
                            if (r.ttft_predicted is not None
                                    and r.ttft is not None):
                                self.tracer.instant(
                                    TRACK_QUEUE, EV_CALIBRATION, now,
                                    rid=r.rid, predicted=r.ttft_predicted,
                                    actual=r.ttft)
                    else:
                        still.append(r)
                # decode-growth evictions transfer in the background
                self._execute_ops(self.manager.drain_ops(), now)
                if stalled and not any_progress:
                    # every running request is blocked on HBM: preempt the
                    # lowest tier's youngest to unblock (rid tiebreak:
                    # simultaneous arrivals in trace bursts must preempt
                    # deterministically, not by list-build order) — swap-
                    # preserving, not vLLM recompute-preemption: its computed
                    # prefix demotes through the two-tier pool and it resumes
                    # token-identically with its first-token time intact
                    victim = max(stalled, key=lambda r: (
                        -r.query.priority, r.query.arrival, r.rid))
                    stalled.remove(victim)
                    self._preempt(victim, now)
                    waiting.appendleft(victim)
                running = still + stalled
            else:
                # idle: jump to the next event; the batch-load signal decays
                # to zero (nothing ran this iteration) instead of freezing
                # at the last busy token count
                last_iter_tokens = 0
                nxt = []
                if arrivals:
                    nxt.append(arrivals[0][0])
                if pending:
                    nxt.append(min(r.ready_time for r in pending))
                if waiting:
                    nxt.append(now + self.swapper.config.monitor_interval)
                if not nxt:
                    break
                now = max(now + 1e-6, min(nxt))
            if now >= next_sample:
                sample(now)
                next_sample = now + cfg.sample_period
        sample(now)
        return SimResult(
            finished=finished,
            timeline=timeline,
            duration=now,
            manager=self.manager,
            straggler_mitigations=self.straggler_mitigations,
        )
