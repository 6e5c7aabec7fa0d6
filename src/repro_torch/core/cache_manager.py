"""Dependency-aware cache manager (FASTLIBRA §4) + baseline variants.

One code path, parametrized the way the paper's ablations are:

* ``maintain_dependencies`` — True: swap-out only dependency-tree leaves /
  swap-in only host roots (validity invariant holds ⇒ zero invalid KVs).
  False (FASTLIBRA-WOM, vLLM): any unpinned HBM node may be evicted
  independently, so a LoRA can leave while its KV subtree stays (invalid KVs).
* ``unified_pool`` — True: one block pool shared by LoRAs + KVs (FASTLIBRA,
  S-LoRA). False (vLLM): static partition, ``lora_partition_ratio`` of HBM
  blocks reserved for LoRAs, the rest for KVs; the two regions cannot borrow.
* ``reuse_history_kv`` — False (S-LoRA): KV blocks are freed at query end and
  never enter the tree.
* ``scorer`` — CostModelScorer (Eq. 6) or LRUScorer; ``lora_reward=False``
  gives FASTLIBRA-WOL.
* ``state_bytes`` — > 0 turns the prefix layer into recurrent-state snapshot
  nodes (RWKV/RG-LRU): ``lookup_state`` resumes from the deepest snapshot at
  or below the prompt and ``commit_state`` captures new boundaries; the same
  unified pool, dependency/validity machinery and swapper move whole
  snapshots instead of per-token blocks.

The manager is pure control plane and time-explicit (``now`` is passed in),
so the discrete-event simulator and the real JAX engine drive the *same*
object. All pool mutations are returned as :class:`SwapOp` records for the
data plane (physical copies) or the simulator (PCIe timing).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional, Sequence

from .block_pool import BlockPool, PoolExhausted, Tier
from .cost_model import (
    CostModelScorer,
    HardwareModel,
    LRUScorer,
    admission_ttft_estimate,
)
from .dependency_tree import (
    DependencyTree,
    MatchResult,
    Node,
    NodeKind,
    Residency,
)
from .invariants import (
    PoolInvariantError,
    check_pool_invariants,
    sanitize_enabled,
)
from ..obs import (
    EV_CACHE_ADMIT,
    EV_CACHE_COMMIT,
    EV_CACHE_DROP,
    EV_CACHE_EVICT,
    EV_CACHE_LOAD,
    EV_CACHE_PREEMPT,
    EV_CACHE_SWAP_IN,
    EV_CACHE_SWAP_OUT,
    NULL_TRACER,
)


def _audit_kind(node: "Node") -> str:
    """Audit-log kind label: LoRA / KV / STATE, with the base-model trunk
    (adapter-independent KV, ``lora_id=None``) called out as shared-trunk."""
    if node.kind is NodeKind.KV and getattr(node, "is_shared", False):
        return "shared-trunk"
    return node.kind.value


def _checked(fn):
    """Run the full pool-invariant sweep after a mutating public op when the
    sanitizer is on (``REPRO_SANITIZE=1`` or ``ManagerConfig(sanitize=True)``).
    Corruption is then caught at the op that introduced it, not at whatever
    later op trips over it."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        out = fn(self, *args, **kwargs)
        if self._sanitize:
            check_pool_invariants(self, context=fn.__name__)
        return out

    return wrapper


class SwapKind(enum.Enum):
    SWAP_IN = "in"  # host -> HBM
    SWAP_OUT = "out"  # HBM -> host
    DROP = "drop"  # HBM -> gone (no host room) or host -> gone
    LOAD_NEW = "load"  # first-time LoRA registration into host


@dataclasses.dataclass
class SwapOp:
    kind: SwapKind
    node_kind: NodeKind
    lora_id: Optional[str]
    nbytes: int
    src_blocks: tuple[int, ...] = ()
    dst_blocks: tuple[int, ...] = ()
    node_id: int = -1

    @property
    def is_transfer(self) -> bool:
        return self.kind in (SwapKind.SWAP_IN, SwapKind.SWAP_OUT)


@dataclasses.dataclass
class LookupResult:
    match: MatchResult
    lora_resident: bool
    hbm_hit_tokens: int
    host_hit_tokens: int
    history_tokens: int  # reusable prefix length presented by the query
    swap_in_nodes: list[Node]  # host-resident nodes on the matched path
    # cross-adapter prefix sharing: the block-quantized adapter-independent
    # span the request declared (0 when sharing is off / undeclared) and how
    # many of those tokens the shared trunk served from HBM. ``commit`` uses
    # ``shared_prefix_len`` to classify the committed suffix into trunk
    # (lora_id=None) vs adapter-fork spans.
    shared_prefix_len: int = 0
    shared_hit_tokens: int = 0
    # recurrent-state lookups (lookup_state) only: the deepest snapshot node
    # carrying payload at or below the prompt, and the prefix boundary
    # (token count) decoding can resume from
    state_node: Optional[Node] = None
    state_tokens: int = 0


@dataclasses.dataclass
class AdmitResult:
    ops: list[SwapOp]
    pinned: list[Node]
    queued: bool = False  # True: not enough HBM even after eviction

    @property
    def swap_in_bytes(self) -> int:
        return sum(o.nbytes for o in self.ops if o.kind is SwapKind.SWAP_IN)


@dataclasses.dataclass
class ManagerConfig:
    block_size: int = 32  # tokens per KV block
    kv_bytes_per_token: int = 1 << 18  # arch-dependent; set by caller
    maintain_dependencies: bool = True
    unified_pool: bool = True
    lora_partition_ratio: float = 0.2
    reuse_history_kv: bool = True
    decay_tau: float = 60.0
    use_cost_model: bool = True
    lora_reward: bool = True
    sigmoid_tau: float = 15.0
    density_ordering: bool = True  # False = paper-literal Eval ordering
    # Recurrent-state prefix caching: > 0 enables STATE snapshot nodes of
    # this byte size (one full-model recurrent state). Snapshot boundaries
    # are arbitrary token positions — the data plane moves whole snapshots,
    # not per-token blocks — so the dependency tree runs unquantized
    # (align=1) when state caching is on.
    state_bytes: int = 0
    # Cross-adapter prefix sharing: requests may declare a leading
    # adapter-independent span (``shared_prefix_len`` — a system prompt
    # computed with the adapter inactive). Its KV is cached ONCE on a shared
    # base-model trunk under the tree root and forked per adapter below.
    # False keeps the declared span base-computed but caches it per adapter
    # (the differential baseline: identical tokens, duplicated cache).
    share_prefix_kv: bool = True
    # libra-check sanitizer: True/False forces the per-op invariant sweep on
    # or off; None defers to the REPRO_SANITIZE environment variable.
    sanitize: Optional[bool] = None

    @property
    def block_bytes(self) -> int:
        return self.block_size * self.kv_bytes_per_token

    @property
    def state_blocks(self) -> int:
        """Unified-pool blocks one state snapshot occupies."""
        return -(-self.state_bytes // self.block_bytes) if self.state_bytes else 0


@dataclasses.dataclass
class ManagerStats:
    lookups: int = 0
    lora_hbm_hits: int = 0
    kv_hbm_hit_tokens: int = 0
    kv_host_hit_tokens: int = 0
    history_tokens: int = 0
    swap_in_bytes: int = 0
    swap_out_bytes: int = 0
    swap_in_count: int = 0
    swap_out_count: int = 0
    drops: int = 0
    queue_events: int = 0
    # SLO-tier preemptions: victims whose running KV/state was folded into
    # the tree (demotable through the swapper) instead of discarded
    preemptions: int = 0
    # recurrent-state snapshot lookups (symmetric with the KV counters:
    # hit tokens are the prefix boundary a resumable snapshot covers)
    state_lookups: int = 0
    state_hits: int = 0
    state_hit_tokens: int = 0
    state_host_hit_tokens: int = 0
    # cross-adapter shared-prefix counters: declared (block-quantized)
    # adapter-independent tokens presented vs those the trunk served from HBM
    shared_history_tokens: int = 0
    shared_hbm_hit_tokens: int = 0

    def lora_hit_rate(self) -> float:
        return self.lora_hbm_hits / self.lookups if self.lookups else 0.0

    def kv_hit_rate(self) -> float:
        return (
            self.kv_hbm_hit_tokens / self.history_tokens
            if self.history_tokens
            else 0.0
        )

    def state_hit_rate(self) -> float:
        """Token-weighted snapshot hit rate (resumed / presented history)."""
        return (
            self.state_hit_tokens / self.history_tokens
            if self.history_tokens
            else 0.0
        )

    def shared_hit_rate(self) -> float:
        """Token-weighted HBM hit rate over declared shared-prefix spans."""
        return (
            self.shared_hbm_hit_tokens / self.shared_history_tokens
            if self.shared_history_tokens
            else 0.0
        )


class CacheManager:
    """Unified (or statically-partitioned) two-tier cache of LoRAs + KVs."""

    def __init__(
        self,
        config: ManagerConfig,
        hbm_bytes: int,
        host_bytes: int,
        hardware: Optional[HardwareModel] = None,
        tracer=None,
    ):
        self.config = config
        # cache-decision audit log (repro_torch.obs): every admit/evict/swap is
        # recorded with node id, kind, bytes and cost-model score when a
        # real tracer is attached; the default is the no-op singleton.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._sanitize = (
            config.sanitize if config.sanitize is not None else sanitize_enabled()
        )
        self.hw = hardware or HardwareModel()
        bb = config.block_bytes
        n_hbm = max(1, hbm_bytes // bb)
        n_host = max(1, host_bytes // bb)
        # State snapshots live at arbitrary prefix boundaries (the data plane
        # moves whole fixed-size snapshots, never per-token blocks), so the
        # tree runs unquantized when state caching is enabled.
        align = 1 if config.state_bytes else config.block_size
        self.tree = DependencyTree(align=align, decay_tau=config.decay_tau,
                                   block_tokens=config.block_size)
        if config.unified_pool:
            self.pool = BlockPool(n_hbm, n_host, bb)
            self.lora_pool = self.pool
            self.kv_pool = self.pool
        else:
            n_lora = max(1, int(n_hbm * config.lora_partition_ratio))
            # host tier is always shared (paper: main memory is one arena)
            self.lora_pool = BlockPool(n_lora, n_host, bb)
            self.kv_pool = BlockPool(n_hbm - n_lora, 0, bb)
            self.kv_pool._free[Tier.HOST] = self.lora_pool._free[Tier.HOST]
            self.kv_pool._allocated[Tier.HOST] = self.lora_pool._allocated[Tier.HOST]
            self.kv_pool.num_host_blocks = n_host
            self.pool = self.kv_pool
        if config.use_cost_model:
            self.scorer: CostModelScorer | LRUScorer = CostModelScorer(
                self.tree,
                self.hw,
                lora_reward=config.lora_reward,
                sigmoid_tau=config.sigmoid_tau,
                density_ordering=config.density_ordering,
            )
        else:
            self.scorer = LRUScorer(self.tree)
        self.stats = ManagerStats()
        # per-query running KV blocks (not yet in the tree)
        self._running: dict[str, list[int]] = {}
        self._running_tokens: dict[str, int] = {}
        # queries preempted via preempt_running and not yet readmitted: the
        # sanitizer asserts they left no running-block residue; a fresh
        # allocate_running for the same id (the resume) clears the mark
        self._preempted: set[str] = set()
        # every swap op (incl. demand evictions inside admit/allocate) is
        # recorded here; the data plane / simulator drains and executes them.
        # Demand-eviction SWAP_OUTs are on the requesting query's critical
        # path (blocks are reusable only after the transfer) — the paper's
        # central cold-start mechanism that the proactive swapper avoids.
        self._pending_ops: list[SwapOp] = []

    # ------------------------------------------------------------ block math
    def kv_blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.config.block_size)

    def _pool_for(self, kind: NodeKind) -> BlockPool:
        return self.lora_pool if kind is NodeKind.LORA else self.kv_pool

    def hbm_usage(self) -> float:
        if self.config.unified_pool:
            return self.pool.hbm_usage()
        used = (
            self.lora_pool.stats().hbm_used + self.kv_pool.stats().hbm_used
        )
        tot = self.lora_pool.num_hbm_blocks + self.kv_pool.num_hbm_blocks
        return used / tot

    # ---------------------------------------------------------------- LoRAs
    @_checked
    def register_lora(self, lora_id: str, size_bytes: int, now: float = 0.0) -> SwapOp:
        """Load a LoRA's weights into the host tier (from disk)."""
        nblocks = -(-size_bytes // self.config.block_bytes)
        blocks = self.lora_pool.allocate(Tier.HOST, nblocks)
        node = self.tree.add_lora(
            lora_id, size_bytes, nblocks, tier=Residency.HOST, now=now
        )
        node.host_blocks = blocks
        if self.tracer.enabled:
            self.tracer.audit(EV_CACHE_LOAD, now, node_id=node.node_id,
                              kind=_audit_kind(node), lora=lora_id,
                              bytes=size_bytes)
        return SwapOp(
            SwapKind.LOAD_NEW, NodeKind.LORA, lora_id, size_bytes,
            dst_blocks=tuple(blocks), node_id=node.node_id,
        )

    # ---------------------------------------------------------------- lookup
    @_checked
    def lookup(self, lora_id: str, history_tokens: Sequence[int], now: float,
               shared_prefix_len: int = 0) -> LookupResult:
        """Prefix lookup. ``shared_prefix_len`` declares how many leading
        history tokens are adapter-independent (computed with the adapter
        inactive): with ``share_prefix_kv`` on, that span is matched against
        the shared base-model trunk — hitting KV cached by *other* adapters —
        and committed there. The span is quantized down to the block size so
        trunk and fork edges stay block-aligned."""
        sq = 0
        if self.config.share_prefix_kv and shared_prefix_len > 0:
            bs = self.config.block_size
            sq = (min(shared_prefix_len, len(history_tokens)) // bs) * bs
        m = self.tree.match(lora_id, history_tokens, now, shared_len=sq)
        lora_resident = (
            m.lora_node is not None and m.lora_node.tier is Residency.HBM
        )
        swap_in: list[Node] = []
        if m.lora_node is not None and m.lora_node.tier is Residency.HOST:
            swap_in.append(m.lora_node)
        for n in m.kv_nodes:
            if n.tier is Residency.HOST:
                swap_in.append(n)
        res = LookupResult(
            match=m,
            lora_resident=lora_resident,
            hbm_hit_tokens=m.hbm_hit_tokens,
            host_hit_tokens=m.host_hit_tokens,
            history_tokens=len(history_tokens),
            swap_in_nodes=swap_in,
            shared_prefix_len=sq,
            shared_hit_tokens=m.shared_hbm_hit_tokens,
        )
        self.stats.lookups += 1
        self.stats.lora_hbm_hits += int(lora_resident)
        self.stats.kv_hbm_hit_tokens += m.hbm_hit_tokens
        self.stats.kv_host_hit_tokens += m.host_hit_tokens
        self.stats.history_tokens += len(history_tokens)
        self.stats.shared_history_tokens += sq
        self.stats.shared_hbm_hit_tokens += m.shared_hbm_hit_tokens
        return res

    @_checked
    def lookup_state(
        self, lora_id: str, history_tokens: Sequence[int], now: float
    ) -> LookupResult:
        """Recurrent-arch lookup: deepest *resumable* snapshot ≤ the prompt.

        The matched chain may contain hollow STATE interiors (radix-split
        residue carrying no snapshot) — only nodes with payload blocks are
        resume points, and a snapshot encodes the FULL prefix state at its
        boundary, so exactly one node (the deepest payload node) needs to be
        resident. ``swap_in_nodes`` still lists every host node on the path
        down to it, shallow→deep, so admit preserves the validity invariant
        (the hollow ones move zero bytes).
        """
        m = self.tree.match(lora_id, history_tokens, now)
        lora_resident = (
            m.lora_node is not None and m.lora_node.tier is Residency.HBM
        )
        snode: Optional[Node] = None
        stokens = 0
        pos = 0
        best_depth = 0
        for i, n in enumerate(m.kv_nodes):
            pos += n.num_tokens
            if n.kind is NodeKind.STATE and n.has_payload:
                snode, stokens, best_depth = n, pos, i + 1
        swap_in: list[Node] = []
        if m.lora_node is not None and m.lora_node.tier is Residency.HOST:
            swap_in.append(m.lora_node)
        for n in m.kv_nodes[:best_depth]:
            if n.tier is Residency.HOST:
                swap_in.append(n)
        hbm_hit = stokens if (snode is not None and snode.tier is Residency.HBM) else 0
        host_hit = stokens if (snode is not None and snode.tier is Residency.HOST) else 0
        res = LookupResult(
            match=m,
            lora_resident=lora_resident,
            hbm_hit_tokens=hbm_hit,
            host_hit_tokens=host_hit,
            history_tokens=len(history_tokens),
            swap_in_nodes=swap_in,
            state_node=snode,
            state_tokens=stokens,
        )
        self.stats.lookups += 1
        self.stats.lora_hbm_hits += int(lora_resident)
        self.stats.history_tokens += len(history_tokens)
        self.stats.state_lookups += 1
        self.stats.state_hits += int(snode is not None)
        self.stats.state_hit_tokens += hbm_hit
        self.stats.state_host_hit_tokens += host_hit
        return res

    # ----------------------------------------------------------------- admit
    @_checked
    def admit(self, lookup: LookupResult, now: float) -> AdmitResult:
        """Bring the query's LoRA + matched KV chain into HBM and pin them.

        Swap-ins allocate HBM blocks, evicting per the scorer on demand.
        Returns ``queued=True`` (and performs nothing) if HBM cannot hold the
        working set even after eviction — the caller re-tries later.
        """
        ops: list[SwapOp] = []
        needed = list(lookup.swap_in_nodes)
        # feasibility: everything needed must fit alongside pinned blocks
        for node in needed:
            pool = self._pool_for(node.kind)
            if node.num_blocks > pool.num_hbm_blocks:
                self.stats.queue_events += 1
                return AdmitResult(ops=[], pinned=[], queued=True)
        # Protect the query's whole working set while making room: without
        # this, swapping in a later node can evict an *earlier* node of the
        # same admission (e.g. the just-loaded LoRA to fit its own KV chain,
        # leaving an HBM child under a host parent — a validity violation the
        # state-interleave fuzz caught) or silently evict an already-resident
        # matched node whose blocks the data plane is about to gather.
        m = lookup.match
        protect = {n.node_id for n in needed}
        protect.update(n.node_id for n in m.kv_nodes)
        if m.lora_node is not None:
            protect.add(m.lora_node.node_id)
        # admit-shield integrity (sanitizer): every working-set node that is
        # HBM-resident when make-room starts must still be at admit end —
        # exactly the regression class the state-interleave fuzz caught.
        working_set = list(m.kv_nodes)
        if m.lora_node is not None:
            working_set.append(m.lora_node)
        shielded = (
            {n.node_id for n in working_set if n.tier is Residency.HBM}
            if self._sanitize
            else None
        )
        for node in needed:
            op = self._swap_in_node(node, now, protect=protect)
            if op is None:
                # roll back pins made so far; caller queues
                self.stats.queue_events += 1
                return AdmitResult(ops=[], pinned=[], queued=True)
            ops.append(op)
        # Pin the LoRA node and the *deepest* HBM-resident matched KV node
        # only: in dependency-maintained mode every ancestor is protected
        # structurally (it has an HBM child, so it is never an eviction
        # leaf), and pinning one node per path survives radix splits (the
        # original object always remains the deepest/lower half).
        pinned: list[Node] = []
        m = lookup.match
        if m.lora_node is not None and m.lora_node.tier is Residency.HBM:
            m.lora_node.ref_count += 1
            pinned.append(m.lora_node)
        deepest = next(
            (n for n in reversed(m.kv_nodes) if n.tier is Residency.HBM), None
        )
        if deepest is not None:
            deepest.ref_count += 1
            pinned.append(deepest)
        if shielded is not None:
            lost = [
                n for n in working_set + needed
                if n.node_id in shielded | {x.node_id for x in needed}
                and n.tier is not Residency.HBM
            ]
            if lost:
                raise PoolInvariantError(
                    "admit-shield: working-set node(s) evicted mid-admit: "
                    + ", ".join(
                        f"#{n.node_id}({n.kind.value}, tier={n.tier})"
                        for n in lost
                    ),
                )
        if self.tracer.enabled:
            self.tracer.audit(
                EV_CACHE_ADMIT, now,
                swapped_in=[n.node_id for n in needed],
                pinned=[n.node_id for n in pinned],
                hbm_hit_tokens=lookup.hbm_hit_tokens,
                host_hit_tokens=lookup.host_hit_tokens)
        return AdmitResult(ops=ops, pinned=pinned)

    @_checked
    def unpin(self, pinned: Sequence[Node]) -> None:
        for n in pinned:
            if n.ref_count > 0:
                n.ref_count -= 1

    # --------------------------------------------------------- running blocks
    @_checked
    def allocate_running(
        self, query_id: str, num_tokens: int, now: float
    ) -> Optional[list[int]]:
        """Allocate HBM blocks for a query's newly-computed KV (prefill suffix
        or decode growth). Returns None if HBM is exhausted even after
        eviction (query must queue / be preempted)."""
        nblocks = self.kv_blocks_for(num_tokens)
        # a resume allocation clears the preempted mark (the query is live
        # again and legitimately holds running blocks)
        self._preempted.discard(query_id)
        have = self._running.setdefault(query_id, [])
        cur_tokens = self._running_tokens.get(query_id, 0)
        need = self.kv_blocks_for(cur_tokens + num_tokens) - len(have)
        if need <= 0:
            self._running_tokens[query_id] = cur_tokens + num_tokens
            return []
        if not self._make_room(self.kv_pool, need, now):
            self.stats.queue_events += 1
            return None
        blocks = self.kv_pool.allocate(Tier.HBM, need)
        have.extend(blocks)
        self._running_tokens[query_id] = cur_tokens + num_tokens
        return blocks

    def running_blocks(self, query_id: str) -> list[int]:
        return list(self._running.get(query_id, ()))

    @_checked
    def abort_running(self, query_id: str) -> None:
        blocks = self._running.pop(query_id, [])
        self._running_tokens.pop(query_id, None)
        if blocks:
            self.kv_pool.release(Tier.HBM, blocks)

    @_checked
    def commit(
        self,
        query_id: str,
        lookup: LookupResult,
        full_tokens: Sequence[int],
        now: float,
    ) -> Optional[Node]:
        """Query finished: fold its running KV blocks into the tree.

        The matched prefix is already covered by tree nodes; the new suffix
        is classified at the request's declared ``shared_prefix_len``
        boundary — the adapter-independent part grows the shared trunk
        (``lora_id=None``, under the deepest matched trunk node or the root)
        and the adapter-divergent remainder forks under this adapter — each
        span becoming a node owning the (block-aligned part of the) running
        blocks. Partial tail blocks are freed (vLLM-style: only whole blocks
        are shareable). With ``reuse_history_kv=False`` (S-LoRA) all running
        blocks are freed and nothing is inserted.
        """
        blocks = self._running.pop(query_id, [])
        self._running_tokens.pop(query_id, None)
        if not self.config.reuse_history_kv:
            if blocks:
                self.kv_pool.release(Tier.HBM, blocks)
            return None
        m = lookup.match
        if m.lora_node is None:
            if blocks:
                self.kv_pool.release(Tier.HBM, blocks)
            return None
        bs = self.config.block_size
        suffix = tuple(full_tokens)[m.matched_tokens :]
        cache_tokens = (len(suffix) // bs) * bs
        if cache_tokens == 0:
            if blocks:
                self.kv_pool.release(Tier.HBM, blocks)
            return None
        keep_blocks = blocks[: cache_tokens // bs]
        spill = blocks[cache_tokens // bs :]
        if spill:
            self.kv_pool.release(Tier.HBM, spill)
        # classify the committed span at the shared-prefix boundary
        # (lookup.shared_prefix_len is already block-quantized, and 0 when
        # sharing is off): [matched, boundary) is trunk, the rest is fork
        shared_take = 0
        if lookup.shared_prefix_len > m.matched_tokens:
            shared_take = min(
                lookup.shared_prefix_len - m.matched_tokens, cache_tokens
            )
        spans: list[tuple[tuple, Optional[str]]] = []
        if shared_take:
            spans.append((suffix[:shared_take], None))
        if shared_take < cache_tokens:
            spans.append(
                (suffix[shared_take:cache_tokens], m.lora_node.lora_id)
            )
        parent = m.last_node
        node: Optional[Node] = None
        attached: list[Node] = []
        off = 0
        for span_toks, span_lora in spans:
            span_blocks = keep_blocks[off // bs : (off + len(span_toks)) // bs]
            off += len(span_toks)
            node, absorbed = self.tree.insert_kv_ext(
                parent=parent,
                tokens=span_toks,
                size_bytes=len(span_toks) * self.config.kv_bytes_per_token,
                num_blocks=len(span_blocks),
                tier=Residency.HBM,
                now=now,
                lora_id=span_lora,
            )
            # leading span tokens absorbed by pre-existing nodes (divergence
            # below a partially-matched edge, or another adapter already grew
            # this trunk span): our recomputed blocks for that range are
            # redundant — free them, the existing nodes own the data.
            redundant = span_blocks[: absorbed // bs]
            own = span_blocks[absorbed // bs :]
            if redundant:
                self.kv_pool.release(Tier.HBM, redundant)
            if own:
                node.hbm_blocks = own
                node.num_blocks = len(own)
                attached.append(node)
            parent = node
        if self.tracer.enabled:
            for n in attached:
                self.tracer.audit(EV_CACHE_COMMIT, now, node_id=n.node_id,
                                  kind=_audit_kind(n), lora=n.lora_id,
                                  bytes=n.size_bytes, query=query_id)
        # Validity repair: the inserts may have descended through ancestors
        # that were swapped out after this query's lookup (the query
        # recomputed their KVs rather than matching them). Keeping a new
        # node in HBM would violate the validity invariant — demote it.
        # Shallow-first so a demoted trunk span cascades to the fork span
        # just attached below it.
        if self.config.maintain_dependencies:
            for n in attached:
                if n.tier is not Residency.HBM:
                    continue
                p = n.parent
                while p is not None and p.kind is not NodeKind.ROOT:
                    if p.tier is not Residency.HBM:
                        self._swap_out_node(n, now)
                        break
                    p = p.parent
        return node

    @_checked
    def preempt_running(
        self,
        query_id: str,
        lookup: Optional[LookupResult],
        computed_tokens: Sequence[int],
        now: float,
    ) -> Optional[Node]:
        """Demote a preempted victim's running KV into the dependency tree.

        The SLO-tier preemption path: instead of discarding the victim's
        computed work (vLLM-style recompute preemption), its block-aligned
        running KV folds into the tree via the commit path — the blocks
        become ordinary unpinned leaf nodes the scorer can rank and the
        two-tier swapper can demote to host under pressure, and the victim's
        resume lookup matches them back (token-identical resume, swap-in
        instead of recompute). ``computed_tokens`` is the full token prefix
        whose KV the victim actually computed (prompt so far + generated
        minus the pending decode input).

        With ``lookup=None`` (recurrent layouts, whose prefix cache is state
        snapshots — the caller folds a snapshot via :meth:`commit_state`
        separately) or ``reuse_history_kv=False`` (S-LoRA ablation) the
        running blocks are simply released. Either way the query is recorded
        in the preempted registry for the sanitizer's residue check; a later
        :meth:`allocate_running` for the same id (the resume) clears it.
        """
        node: Optional[Node] = None
        if lookup is not None and self.config.reuse_history_kv:
            node = self.commit(query_id, lookup, computed_tokens, now)
        else:
            self.abort_running(query_id)
        self._preempted.add(query_id)
        self.stats.preemptions += 1
        if self.tracer.enabled:
            self.tracer.audit(
                EV_CACHE_PREEMPT, now, query=query_id,
                folded_node=(node.node_id if node is not None else None))
        return node

    def estimate_ttft(self, lora_id: str, history_tokens: Sequence[int],
                      shared_prefix_len: int = 0) -> float:
        """READ-ONLY time-to-first-token estimate for a waiting request.

        Prices the unmatched prefix recompute, host->HBM transfer of any
        host-resident matched KV (or resumable state snapshot), and the
        adapter cold-start — via :func:`admission_ttft_estimate` over a
        non-mutating :meth:`DependencyTree.probe_chain` walk. Deliberately
        NOT :meth:`lookup`: the admission order probes every waiting request
        every step, and lookup touches visit counters / splits edges, which
        would skew the cost model's statistics in proportion to queue depth.
        """
        toks = tuple(history_tokens)
        sq = 0
        if self.config.share_prefix_kv and shared_prefix_len > 0:
            bs = self.config.block_size
            sq = (min(shared_prefix_len, len(toks)) // bs) * bs
        chain = self.tree.probe_chain(lora_id, toks, shared_len=sq)
        host_bytes = 0
        if self.config.state_bytes > 0:
            # recurrent prefix cache: the resume point is the deepest
            # fully-covered payload snapshot; one whole snapshot transfers
            matched = 0
            pos = 0
            tier = None
            for node, cov in chain:
                pos += cov
                if (node.kind is NodeKind.STATE and node.has_payload
                        and cov == node.num_tokens):
                    matched, tier = pos, node.tier
            if tier is Residency.HOST:
                host_bytes += self.config.state_bytes
        else:
            matched = 0
            for node, cov in chain:
                matched += cov
                if node.tier is Residency.HOST:
                    host_bytes += cov * self.config.kv_bytes_per_token
        lnode = self.tree.lora_node(lora_id)
        lora_resident = lnode is not None and lnode.tier is Residency.HBM
        # +1: prefill always recomputes the final prompt token for logits
        return admission_ttft_estimate(
            self.hw,
            new_tokens=len(toks) + 1 - matched,
            host_kv_bytes=host_bytes,
            lora_resident=lora_resident,
            lora_bytes=lnode.size_bytes if lnode is not None else 0,
        )

    @_checked
    def commit_state(
        self, lora_id: str, prefix_tokens: Sequence[int], now: float
    ) -> Optional[Node]:
        """Record a freshly captured recurrent-state snapshot at a boundary.

        Inserts (or reuses) a STATE node covering ``prefix_tokens`` under the
        LoRA branch and allocates ``state_blocks`` HBM blocks for its
        payload, evicting per the scorer on demand. Returns the node — whose
        ``hbm_blocks`` the data plane must now fill via ``StateCache.store``
        — or None when the snapshot is not cacheable: state caching off,
        history reuse disabled (S-LoRA ablation), empty boundary, the
        boundary is already snapshotted, the ancestry is not HBM-resident
        (unlike KV commit, which demotes, an unplaceable snapshot is simply
        dropped — recompute is its backstop), or HBM cannot make room. The
        caller then just discards the captured state.
        """
        if self.config.state_bytes <= 0 or not self.config.reuse_history_kv:
            return None
        toks = tuple(prefix_tokens)
        if not toks:
            return None
        lnode = self.tree.lora_node(lora_id)
        if lnode is None:
            return None
        # insert a hollow husk first; payload is attached only once blocks
        # are secured, so a failed allocation leaves no dangling accounting
        node, absorbed = self.tree.insert_kv_ext(
            parent=lnode, tokens=toks, size_bytes=0, num_blocks=0,
            tier=Residency.HBM, now=now, kind=NodeKind.STATE,
        )
        fresh = absorbed < len(toks)
        if node.kind is not NodeKind.STATE or node.has_payload:
            return None  # boundary collides with a KV node / already cached
        ok = True
        p = node.parent
        while p is not None and p.kind is not NodeKind.ROOT:
            if p.tier is not Residency.HBM:
                ok = False  # ancestor swapped out since the query's lookup
                break
            p = p.parent
        nblocks = self.config.state_blocks
        if ok:
            ok = self._make_room(
                self.kv_pool, nblocks, now, protect={node.node_id}
            )
        if not ok:
            if fresh and not node.children and node.ref_count == 0:
                self.tree.remove(node)  # drop the husk we just created
            return None
        node.hbm_blocks = self.kv_pool.allocate(Tier.HBM, nblocks)
        node.num_blocks = nblocks
        node.size_bytes = self.config.state_bytes
        node.tier = Residency.HBM
        if self.tracer.enabled:
            self.tracer.audit(EV_CACHE_COMMIT, now, node_id=node.node_id,
                              kind=_audit_kind(node), lora=lora_id,
                              bytes=node.size_bytes)
        return node

    # ------------------------------------------------------------- swap core
    def _swap_in_node(
        self, node: Node, now: float, protect: Optional[set[int]] = None
    ) -> Optional[SwapOp]:
        """host -> HBM. Returns None if room cannot be made. ``protect``
        shields additional nodes (the admitting query's working set) from the
        demand evictions this swap-in may trigger."""
        if node.tier is Residency.HBM:
            return SwapOp(SwapKind.SWAP_IN, node.kind, node.lora_id, 0, node_id=node.node_id)
        pool = self._pool_for(node.kind)
        # score sampled pre-mutation so the audit log reflects the state the
        # decision was made in (promotion resets last_access below)
        score = (self.scorer.score(node, now) if self.tracer.enabled
                 else None)
        shield = (protect or set()) | {node.node_id}
        if not self._make_room(pool, node.num_blocks, now, protect=shield):
            return None
        dst = pool.allocate(Tier.HBM, node.num_blocks)
        src = node.host_blocks
        pool.release(Tier.HOST, src)
        node.host_blocks = []
        node.hbm_blocks = dst
        node.tier = Residency.HBM
        node.last_access = now
        self.stats.swap_in_bytes += node.size_bytes
        self.stats.swap_in_count += 1
        op = SwapOp(
            SwapKind.SWAP_IN, node.kind, node.lora_id, node.size_bytes,
            src_blocks=tuple(src), dst_blocks=tuple(dst), node_id=node.node_id,
        )
        self._pending_ops.append(op)
        if self.tracer.enabled:
            self.tracer.audit(EV_CACHE_SWAP_IN, now, node_id=node.node_id,
                              kind=_audit_kind(node), lora=node.lora_id,
                              bytes=node.size_bytes, score=score)
        return op

    def _swap_out_node(self, node: Node, now: float) -> SwapOp:
        """HBM -> host (or drop if the host tier is full)."""
        pool = self._pool_for(node.kind)
        src = node.hbm_blocks
        # every eviction is auditable with the score it was evicted AT:
        # sample before the move mutates tier/blocks
        score = (self.scorer.score(node, now) if self.tracer.enabled
                 else None)
        if pool.can_allocate(Tier.HOST, node.num_blocks):
            dst = pool.allocate(Tier.HOST, node.num_blocks)
            pool.release(Tier.HBM, src)
            node.hbm_blocks = []
            node.host_blocks = dst
            node.tier = Residency.HOST
            self.stats.swap_out_bytes += node.size_bytes
            self.stats.swap_out_count += 1
            op = SwapOp(
                SwapKind.SWAP_OUT, node.kind, node.lora_id, node.size_bytes,
                src_blocks=tuple(src), dst_blocks=tuple(dst), node_id=node.node_id,
            )
            self._pending_ops.append(op)
            if self.tracer.enabled:
                self.tracer.audit(EV_CACHE_SWAP_OUT, now,
                                  node_id=node.node_id,
                                  kind=_audit_kind(node), lora=node.lora_id,
                                  bytes=node.size_bytes, score=score)
            return op
        # host full: drop. KV/STATE nodes are removed (data lost); LoRA nodes
        # keep their tree identity (weights reloadable from disk) with
        # tier=None. A dropped snapshot's blocks vanish with it — its
        # children are self-contained snapshots, unaffected.
        pool.release(Tier.HBM, src)
        node.hbm_blocks = []
        self.stats.drops += 1
        op = SwapOp(
            SwapKind.DROP, node.kind, node.lora_id, node.size_bytes,
            src_blocks=tuple(src), node_id=node.node_id,
        )
        self._pending_ops.append(op)
        if self.tracer.enabled:
            self.tracer.audit(EV_CACHE_DROP, now, node_id=node.node_id,
                              kind=_audit_kind(node), lora=node.lora_id,
                              bytes=node.size_bytes, score=score)
        if node.kind is not NodeKind.LORA and not node.children:
            self.tree.remove(node)
        else:
            node.tier = None
        return op

    def drain_ops(self) -> list[SwapOp]:
        """Return and clear every swap op since the last drain (including
        demand evictions performed inside admit/allocate_running)."""
        ops = self._pending_ops
        self._pending_ops = []
        return ops

    def evict_candidates(self, kind: Optional[NodeKind] = None) -> list[Node]:
        if self.config.maintain_dependencies:
            cands = self.tree.hbm_leaves()
        else:
            cands = [
                n
                for n in self.tree.hbm_nodes()
                if n.ref_count == 0 and n.kind is not NodeKind.ROOT
            ]
        if kind is not None and not self.config.unified_pool:
            cands = [n for n in cands if n.kind is kind]
        return cands

    def _make_room(
        self,
        pool: BlockPool,
        nblocks: int,
        now: float,
        protect: Optional[set[int]] = None,
    ) -> bool:
        """Evict per scorer (ascending Eval) until ``nblocks`` are free."""
        if pool.can_allocate(Tier.HBM, nblocks):
            return True
        self.scorer.refresh(now)
        kind = None
        if not self.config.unified_pool:
            kind = NodeKind.LORA if pool is self.lora_pool else NodeKind.KV
        while not pool.can_allocate(Tier.HBM, nblocks):
            cands = [
                n
                for n in self.evict_candidates(kind)
                if not protect or n.node_id not in protect
            ]
            if not self.config.unified_pool:
                cands = [n for n in cands if self._pool_for(n.kind) is pool]
            if not cands:
                return False
            # node_id tiebreak: equal scores (e.g. cold same-size nodes) must
            # not make victim choice depend on tree-dict insertion order
            victim = min(cands, key=lambda n: (self.scorer.score(n, now), n.node_id))
            if self.tracer.enabled:
                # decision record: the victim's score and the surviving
                # candidates it beat (lowest-scored first)
                ranked = sorted(
                    ((self.scorer.score(n, now), n.node_id) for n in cands
                     if n is not victim))
                self.tracer.audit(
                    EV_CACHE_EVICT, now, node_id=victim.node_id,
                    kind=_audit_kind(victim), lora=victim.lora_id,
                    bytes=victim.size_bytes,
                    score=self.scorer.score(victim, now), reason="demand",
                    beat=[[nid, sc] for sc, nid in ranked[:3]])
            self._swap_out_node(victim, now)
        return True

    # -------------------------------------------------------------- metrics
    def hbm_breakdown(self) -> dict:
        """HBM bytes by category (paper Fig. 14): history KV (per-adapter) /
        shared trunk KV / state snapshots / LoRA / running."""
        bb = self.config.block_bytes
        lora = sum(
            len(n.hbm_blocks) * bb
            for n in self.tree.iter_nodes({NodeKind.LORA})
        )
        kv = 0
        shared = 0
        for n in self.tree.iter_nodes({NodeKind.KV}):
            if n.is_shared:
                shared += len(n.hbm_blocks) * bb
            else:
                kv += len(n.hbm_blocks) * bb
        state = sum(
            len(n.hbm_blocks) * bb
            for n in self.tree.iter_nodes({NodeKind.STATE})
        )
        running = sum(len(b) * bb for b in self._running.values())
        total = (
            self.pool.num_hbm_blocks * bb
            if self.config.unified_pool
            else (self.lora_pool.num_hbm_blocks + self.kv_pool.num_hbm_blocks) * bb
        )
        return {
            "lora_bytes": lora,
            "history_kv_bytes": kv,
            "shared_kv_bytes": shared,
            "state_snapshot_bytes": state,
            "running_kv_bytes": running,
            "total_bytes": total,
        }

    def invalid_kv_fraction(self) -> float:
        total = sum(
            n.size_bytes
            for n in self.tree.iter_nodes({NodeKind.KV, NodeKind.STATE})
            if n.tier is Residency.HBM
        )
        if total == 0:
            return 0.0
        return self.tree.invalid_hbm_bytes() / total

    def check_invariants(self) -> None:
        """Run the full libra-check structural sweep (always-on entry point;
        the legacy pool-partition and validity checks are a subset of it)."""
        check_pool_invariants(self)

    def sanitize_check(self, context: str = "") -> None:
        """Invariant sweep gated on the sanitizer flag — cheap no-op when
        off. Collaborators (the swapper) call this after their own pool
        mutations so sanitize mode covers every mutation site, not just the
        manager's public methods."""
        if self._sanitize:
            check_pool_invariants(self, context=context)
