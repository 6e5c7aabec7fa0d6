"""Performance-driven cache swapper (FASTLIBRA §5.3).

Every monitor interval (100 ms) the swapper reads HBM usage from the cache
manager:

* usage > upper threshold (95 %) ⇒ **busy**: swap out HBM-leaf candidates in
  *ascending* Eval order until usage drops back under the upper threshold;
* usage < lower threshold (70 %) ⇒ **idle**: prefetch host-root candidates in
  *descending* Eval order until usage reaches the lower threshold (this is
  what proactively loads all LoRAs at t≈0 in the paper's Fig. 14a).

The two-threshold hysteresis prevents ping-pong swapping. Candidates are
refreshed after every move because evicting a leaf exposes its parent and
swapping in a root exposes its children.

Straggler mitigation (beyond-paper, §DESIGN 5): if the caller reports that a
previously-issued transfer has exceeded ``straggler_timeout``, the swapper
re-issues it (hedged swap) — the manager's block accounting is idempotent for
re-issues because the node already sits in its destination tier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..obs import EV_CACHE_EVICT, EV_CACHE_PREFETCH
from .cache_manager import CacheManager, SwapOp, _audit_kind
from .dependency_tree import NodeKind


@dataclasses.dataclass
class SwapperConfig:
    monitor_interval: float = 0.1  # seconds (paper: 100 ms)
    upper_threshold: float = 0.95
    lower_threshold: float = 0.70
    max_moves_per_tick: int = 512  # safety valve
    straggler_timeout: float = 1.0
    enabled: bool = True  # baselines run demand-paging only


class CacheSwapper:
    def __init__(self, manager: CacheManager, config: Optional[SwapperConfig] = None):
        self.manager = manager
        self.config = config or SwapperConfig()
        self.last_tick = 0.0
        self._recent_batch_size = 0.0
        self.ticks = 0
        self.total_ops = 0

    def observe_batch_size(self, bs: float) -> None:
        """Engine reports the recent (last 5 s) average batch load (§5.1).

        With the mixed step scheduler this is the UNIFIED mixed-batch token
        count per step — decode rows contribute 1 token, prefill rows their
        chunk slice — one signal instead of a decode-slot count that was
        blind to the prefill share of each batch."""
        self._recent_batch_size = bs
        obs = getattr(self.manager.scorer, "observe_batch_size", None)
        if obs:
            obs(bs)

    def due(self, now: float) -> bool:
        return self.config.enabled and (
            now - self.last_tick >= self.config.monitor_interval
        )

    def tick(self, now: float) -> list[SwapOp]:
        """One monitor-interval sweep; returns the executed swap plan."""
        self.last_tick = now
        self.ticks += 1
        if not self.config.enabled:
            return []
        mgr = self.manager
        cfg = self.config
        mgr.scorer.refresh(now)
        ops: list[SwapOp] = []
        usage = mgr.hbm_usage()
        if usage > cfg.upper_threshold:
            ops.extend(self._swap_out_sweep(now))
        elif usage < cfg.lower_threshold:
            ops.extend(self._swap_in_sweep(now))
        self.total_ops += len(ops)
        mgr.sanitize_check("swapper.tick")
        return ops

    # ------------------------------------------------------------------ busy
    def _swap_out_sweep(self, now: float) -> list[SwapOp]:
        mgr, cfg = self.manager, self.config
        ops: list[SwapOp] = []
        while (
            mgr.hbm_usage() > cfg.upper_threshold
            and len(ops) < cfg.max_moves_per_tick
        ):
            cands = mgr.evict_candidates()
            if not cands:
                break
            # node_id tiebreak keeps victim choice deterministic on equal Eval
            victim = min(cands, key=lambda n: (mgr.scorer.score(n, now), n.node_id))
            if mgr.tracer.enabled:
                # audit the proactive-pressure decision: victim score + the
                # surviving candidates it beat (lowest-scored first)
                ranked = sorted(
                    ((mgr.scorer.score(n, now), n.node_id) for n in cands
                     if n is not victim))
                mgr.tracer.audit(
                    EV_CACHE_EVICT, now, node_id=victim.node_id,
                    kind=_audit_kind(victim), lora=victim.lora_id,
                    bytes=victim.size_bytes,
                    score=mgr.scorer.score(victim, now), reason="pressure",
                    beat=[[nid, sc] for sc, nid in ranked[:3]])
            ops.append(mgr._swap_out_node(victim, now))
        return ops

    # ------------------------------------------------------------------ idle
    def _swap_in_sweep(self, now: float) -> list[SwapOp]:
        mgr, cfg = self.manager, self.config
        ops: list[SwapOp] = []
        while (
            mgr.hbm_usage() < cfg.lower_threshold
            and len(ops) < cfg.max_moves_per_tick
        ):
            if mgr.config.maintain_dependencies:
                cands = mgr.tree.host_roots()
            else:
                cands = [
                    n
                    for n in mgr.tree.iter_nodes()
                    if n.tier is not None and n.tier.value == "host"
                ]
            if not cands:
                break
            # -node_id tiebreak: on equal Eval prefetch the oldest node
            # deterministically instead of whatever dict order yields first
            best = max(cands, key=lambda n: (mgr.scorer.score(n, now), -n.node_id))
            # prefetch only while it fits without evicting anything hotter
            pool = mgr._pool_for(best.kind)
            from .block_pool import Tier

            if not pool.can_allocate(Tier.HBM, best.num_blocks):
                break
            op = mgr._swap_in_node(best, now)
            if op is None:
                break
            if mgr.tracer.enabled:
                # idle-prefetch decision: chosen node + the runners-up it
                # outscored (highest-scored first)
                ranked = sorted(
                    ((mgr.scorer.score(n, now), n.node_id) for n in cands
                     if n is not best), reverse=True)
                mgr.tracer.audit(
                    EV_CACHE_PREFETCH, now, node_id=best.node_id,
                    kind=_audit_kind(best), lora=best.lora_id,
                    bytes=best.size_bytes,
                    score=mgr.scorer.score(best, now),
                    beat=[[nid, sc] for sc, nid in ranked[:3]])
            ops.append(op)
        return ops


def make_fastlibra(
    hbm_bytes: int,
    host_bytes: int,
    *,
    kv_bytes_per_token: int,
    block_size: int = 32,
    hardware=None,
    variant: str = "fastlibra",
    state_bytes: int = 0,
    sanitize: Optional[bool] = None,
    share_prefix_kv: bool = True,
    tracer=None,
) -> tuple[CacheManager, CacheSwapper]:
    """Factory for FASTLIBRA and every paper baseline/ablation.

    variants: fastlibra | fastlibra-paper | wom | wos | wol | vllm | slora
    (fastlibra-paper = literal Eq.6 ordering without the density correction)

    ``state_bytes > 0`` (recurrent archs) makes the prefix layer state
    snapshots instead of per-token KV — every variant keeps its own
    eviction/partitioning semantics over the snapshot nodes, and the
    proactive swapper moves whole snapshots through the same SwapOp plan.

    ``share_prefix_kv=False`` disables the cross-adapter shared trunk:
    declared shared spans are still base-computed but cached per adapter —
    the differential baseline for the sharing refactor.

    ``tracer`` attaches a :class:`repro_torch.obs.Tracer` so every manager and
    swapper cache decision lands in the audit log (default: no-op tracer).
    """
    from .cache_manager import ManagerConfig

    base = dict(block_size=block_size, kv_bytes_per_token=kv_bytes_per_token,
                state_bytes=state_bytes, sanitize=sanitize,
                share_prefix_kv=share_prefix_kv)
    sw = SwapperConfig()
    if variant == "fastlibra":
        cfg = ManagerConfig(**base)
    elif variant == "fastlibra-paper":
        cfg = ManagerConfig(**base, density_ordering=False)
    elif variant == "wom":  # no dependency maintenance
        cfg = ManagerConfig(**base, maintain_dependencies=False)
    elif variant == "wos":  # LRU instead of the cost model
        cfg = ManagerConfig(**base, use_cost_model=False)
    elif variant == "wol":  # no LoRA-quantity reward (Eq. 4 dropped)
        cfg = ManagerConfig(**base, lora_reward=False)
    elif variant == "vllm":  # static partition + LRU + prefix caching
        cfg = ManagerConfig(
            **base,
            maintain_dependencies=False,
            unified_pool=False,
            use_cost_model=False,
        )
        sw = SwapperConfig(enabled=False)  # demand paging only
    elif variant == "slora":  # unified pool, no history-KV reuse
        cfg = ManagerConfig(
            **base,
            maintain_dependencies=True,
            reuse_history_kv=False,
            use_cost_model=False,
        )
        sw = SwapperConfig(enabled=False)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    mgr = CacheManager(cfg, hbm_bytes, host_bytes, hardware=hardware,
                       tracer=tracer)
    return mgr, CacheSwapper(mgr, sw)
