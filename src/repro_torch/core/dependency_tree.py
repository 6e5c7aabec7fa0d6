"""Usage-dependency tree (FASTLIBRA §4) with a shared base-model trunk.

A radix/trie structure over LoRAs, shared base-model prefixes, and
adapter-specific KV-cache prefixes:

* layer 0: a single virtual root (always "resident"),
* layer 1a: one node per LoRA adapter (the paper's "second layer"),
* layer 1b: a **shared radix trunk** of adapter-independent KV nodes
  (``lora_id=None``) directly under the root — base-model KV for spans the
  request declared adapter-independent (system prompts computed with the
  adapter inactive, A-LoRA / LRAgent style). Trunk nodes are cached ONCE and
  may carry fork children under *multiple* adapters,
* below each LoRA node — or forking off a trunk node via a composite
  ``(lora_id, chunk)`` child key — a radix trie of adapter-divergent KV
  prefixes produced by queries that used that LoRA. Each root→leaf path is a
  conversation record; siblings share their parent prefix. For recurrent
  architectures (RWKV-6, RG-LRU) the prefix nodes are fixed-size **state
  snapshots** (:attr:`NodeKind.STATE`) instead of per-token KV — same trie,
  same residency/eviction machinery, but the payload is indivisible (see
  :meth:`DependencyTree._split`). STATE never lives on the shared trunk.

The resulting shape is root → shared trunk (optional) → per-adapter forks,
so a thousand adapters serving one product system prompt cache the prefix
once instead of a thousand times. A trunk node's structural children are its
dependents: evicting it invalidates forks under every adapter below it,
which is why the cost model prices shared nodes by the *sum* of
dependent-fork recompute (see ``cost_model.CostModelScorer``).

Every node carries the statistics the cost model (§5.2) needs: visit
frequency (exponentially decayed), last-recent-use time, size in blocks/bytes
and swap (transfer) cost. Residency is per-node (HBM / HOST); the structural
invariant maintained by the cache manager is

    node.tier == HBM  ⇒  node.parent.tier == HBM          (validity invariant)

which is exactly "no invalid KV": a KV prefix is only HBM-resident if its
whole ancestry — its LoRA, or the shared trunk above its fork point — is.
A shared trunk node is valid with no LoRA ancestor at all (its parent chain
terminates at the root). Swap-out therefore only targets *HBM leaves* (HBM
nodes with no HBM children), swap-in only *host roots* (host nodes whose
parent is already in HBM).

The tree is pure control plane: payloads are opaque block-id lists owned by
the manager. ``align`` (tokens) quantizes match/split points so node spans
stay block-aligned when the data plane requires it (align = kv block size).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Callable, Iterator, Optional, Sequence

from .invariants import PoolInvariantError

Token = int
TokenSeq = tuple[Token, ...]


class NodeKind(enum.Enum):
    ROOT = "root"
    LORA = "lora"
    KV = "kv"  # per-token KV-cache prefix node (attention archs)
    # Recurrent-state snapshot node (RWKV / RG-LRU): the fixed-size model
    # state at the prefix boundary this node's path ends on. Unlike KV, the
    # payload is indivisible and lives entirely on the node whose boundary it
    # was captured at; radix splits therefore create *hollow* STATE interiors
    # (no blocks) that are pure trie structure — resumable boundaries are the
    # STATE nodes with payload blocks.
    STATE = "state"


class Residency(enum.Enum):
    HBM = "hbm"
    HOST = "host"


_node_ids = itertools.count()

# sentinel: insert_kv_ext inherits the parent's lora_id unless told otherwise
_INHERIT: object = object()


@dataclasses.dataclass
class Node:
    kind: NodeKind
    lora_id: Optional[str]  # which LoRA branch this node belongs to (None for root)
    tokens: TokenSeq  # edge label (empty for root/LoRA nodes)
    tier: Optional[Residency]
    parent: Optional["Node"] = None
    node_id: int = dataclasses.field(default_factory=lambda: next(_node_ids))
    # children keyed by the first ``align`` tokens of the child's edge label
    # (LoRA children of the root are keyed by node_id — the root is never
    # prefix-matched). Keying by the full first chunk guarantees that any two
    # siblings share < align leading tokens, so radix splits always land on
    # align boundaries and data-plane blocks never straddle nodes.
    children: dict[object, "Node"] = dataclasses.field(default_factory=dict)
    # --- statistics for the cost model -------------------------------------
    visit_count: float = 0.0  # exponentially-decayed visit counter
    last_access: float = 0.0  # LRU time
    last_decay: float = 0.0  # bookkeeping for the decayed counter
    size_bytes: int = 0
    num_blocks: int = 0
    # --- data plane --------------------------------------------------------
    hbm_blocks: list[int] = dataclasses.field(default_factory=list)
    host_blocks: list[int] = dataclasses.field(default_factory=list)
    ref_count: int = 0  # pinned by running queries; cannot be swapped out

    # ------------------------------------------------------------------ util
    @property
    def num_tokens(self) -> int:
        return len(self.tokens)

    @property
    def is_shared(self) -> bool:
        """Whether this is a shared base-model trunk node: adapter-independent
        KV cached once under the root and forked per adapter below."""
        return self.kind is NodeKind.KV and self.lora_id is None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    @property
    def has_payload(self) -> bool:
        """Whether this node owns data-plane blocks in some tier. False for
        hollow STATE interiors created by radix splits (and for dropped
        nodes), which are structure only."""
        return bool(self.hbm_blocks or self.host_blocks)

    def hbm_children(self) -> list["Node"]:
        return [c for c in self.children.values() if c.tier is Residency.HBM]

    def is_hbm_leaf(self) -> bool:
        """Swap-out candidate: resident, unpinned, no HBM-resident child."""
        return (
            self.tier is Residency.HBM
            and self.ref_count == 0
            and not self.hbm_children()
            and self.kind is not NodeKind.ROOT
        )

    def is_host_root(self) -> bool:
        """Swap-in candidate: in host memory with an HBM-resident parent."""
        if self.tier is not Residency.HOST:
            return False
        p = self.parent
        return p is not None and (p.kind is NodeKind.ROOT or p.tier is Residency.HBM)

    def path_tokens(self) -> TokenSeq:
        """Full token prefix from the LoRA node down to (and incl.) this node."""
        parts: list[TokenSeq] = []
        n: Optional[Node] = self
        while n is not None and n.kind in (NodeKind.KV, NodeKind.STATE):
            parts.append(n.tokens)
            n = n.parent
        return tuple(t for seg in reversed(parts) for t in seg)

    def path_num_tokens(self) -> int:
        """Length of :meth:`path_tokens` without materializing the tuple —
        scorers call this per candidate per eviction-loop iteration."""
        out = 0
        n: Optional[Node] = self
        while n is not None and n.kind in (NodeKind.KV, NodeKind.STATE):
            out += len(n.tokens)
            n = n.parent
        return out

    # -------------------------------------------------------------- counters
    def touch(self, now: float, decay_tau: float) -> None:
        """Record a visit at time ``now`` with exponential frequency decay."""
        if decay_tau > 0 and self.last_decay < now:
            self.visit_count *= math.exp(-(now - self.last_decay) / decay_tau)
        self.visit_count += 1.0
        self.last_decay = now
        self.last_access = now

    def decayed_visits(self, now: float, decay_tau: float) -> float:
        if decay_tau <= 0 or now <= self.last_decay:
            return self.visit_count
        return self.visit_count * math.exp(-(now - self.last_decay) / decay_tau)


@dataclasses.dataclass
class MatchResult:
    """Result of prefix-matching a query against the tree."""

    lora_node: Optional[Node]
    kv_nodes: list[Node]  # matched prefix chain, shallow → deep
    matched_tokens: int  # total tokens covered by kv_nodes
    last_node: Node  # deepest matched node (LoRA node if no KV matched;
    # the root when a shared span was declared but no trunk node matched)
    shared_matched_tokens: int = 0  # leading tokens served by the shared trunk

    @property
    def hbm_hit_tokens(self) -> int:
        return sum(n.num_tokens for n in self.kv_nodes if n.tier is Residency.HBM)

    @property
    def host_hit_tokens(self) -> int:
        return sum(n.num_tokens for n in self.kv_nodes if n.tier is Residency.HOST)

    @property
    def shared_hbm_hit_tokens(self) -> int:
        return sum(n.num_tokens for n in self.kv_nodes
                   if n.is_shared and n.tier is Residency.HBM)


class DependencyTree:
    """The unified usage-dependency tree over LoRAs and KV prefixes."""

    def __init__(self, align: int = 1, decay_tau: float = 60.0,
                 block_tokens: int = 0):
        if align < 1:
            raise ValueError("align must be >= 1")
        self.align = align
        # data-plane block quantum for KV block-ownership math. Historically
        # equal to ``align``, but a state-caching tree runs align=1 (snapshot
        # boundaries are arbitrary) while KV blocks are still block_tokens
        # wide — splitting block lists at token offsets would hand a 3-token
        # upper node 3 whole blocks. Ownership therefore always splits at
        # block_tokens boundaries (straddling blocks stay with the lower
        # node).
        self.block_tokens = block_tokens or align
        self.decay_tau = decay_tau
        self.root = Node(kind=NodeKind.ROOT, lora_id=None, tokens=(), tier=None)
        self._lora_nodes: dict[str, Node] = {}
        self._total_visits = 0.0
        self._last_visit_decay = 0.0

    # ------------------------------------------------------------- structure
    def lora_node(self, lora_id: str) -> Optional[Node]:
        return self._lora_nodes.get(lora_id)

    def lora_nodes(self) -> list[Node]:
        return list(self._lora_nodes.values())

    def add_lora(
        self,
        lora_id: str,
        size_bytes: int,
        num_blocks: int,
        tier: Residency = Residency.HOST,
        now: float = 0.0,
    ) -> Node:
        """Insert a LoRA node on the second layer (idempotent)."""
        if lora_id in self._lora_nodes:
            return self._lora_nodes[lora_id]
        node = Node(
            kind=NodeKind.LORA,
            lora_id=lora_id,
            tokens=(),
            tier=tier,
            parent=self.root,
            size_bytes=size_bytes,
            num_blocks=num_blocks,
        )
        node.last_access = now
        node.last_decay = now
        # LoRA children are keyed by id hash in the root's child map; the root
        # is never prefix-matched so any unique key works.
        self.root.children[node.node_id] = node
        self._lora_nodes[lora_id] = node
        return node

    def _child_key(self, parent: Node, lora_id: Optional[str],
                   tokens: TokenSeq) -> object:
        """Child-map key for an edge starting with ``tokens`` under
        ``parent``. Plain first-chunk keys everywhere except the fork point:
        an adapter-labelled child of a shared trunk node (or of the root) is
        keyed ``(lora_id, chunk)`` so forks under different adapters with
        identical divergence tokens coexist as siblings."""
        chunk = tuple(tokens[: self.align])
        if (lora_id is not None and parent.kind is not NodeKind.LORA
                and parent.lora_id is None):
            return (lora_id, chunk)
        return chunk

    def match(self, lora_id: str, tokens: Sequence[Token], now: float,
              shared_len: int = 0) -> MatchResult:
        """DFS prefix match: shared trunk first (when the request declares a
        ``shared_len`` adapter-independent prefix), then the adapter fork.

        With ``shared_len=0`` this is the legacy walk — LoRA node first, then
        the longest KV prefix chain under it. With ``shared_len>0`` the first
        ``shared_len`` (align-quantized) tokens are matched against the
        ``lora_id=None`` trunk under the root; only if the trunk fully covers
        the declared span does the walk cross into this adapter's fork (via
        the composite child key) and continue on plain keys below.

        Only counts a node as matched if the query's remaining tokens fully
        cover the node's edge label (partial edge coverage stops the walk; the
        manager may later split the edge on insert). Match length is quantized
        down to ``align``. Visit counters of matched nodes are updated.
        """
        self._bump_total(now)
        lnode = self._lora_nodes.get(lora_id)
        if lnode is not None:
            lnode.touch(now, self.decay_tau)
        toks = tuple(tokens)
        # quantize usable prefix down to align so data-plane blocks stay whole
        usable = (len(toks) // self.align) * self.align
        toks = toks[:usable]
        shared_usable = (min(max(shared_len, 0), len(toks)) // self.align
                         ) * self.align
        chain: list[Node] = []
        pos = 0
        if shared_usable:
            cur: Node = self.root
            while pos < shared_usable:
                child = cur.children.get(toks[pos : pos + self.align])
                if child is None:
                    break
                # never match a trunk edge past the declared shared span: the
                # remainder of the prompt is adapter-divergent even if its
                # tokens happen to coincide with a longer trunk edge
                common = _common_prefix_len(child.tokens, toks[pos:shared_usable])
                common = (common // self.align) * self.align
                if common == 0:
                    break
                if common < len(child.tokens):
                    child = self._split(child, common)
                child.touch(now, self.decay_tau)
                chain.append(child)
                pos += common
                cur = child
        shared_matched = pos
        if lnode is None:
            return MatchResult(None, chain, pos,
                               chain[-1] if chain else self.root,
                               shared_matched_tokens=shared_matched)
        if shared_usable:
            # adapter fork hangs off the deepest trunk node (or the root when
            # nothing shared is cached yet); reachable only once the trunk
            # covered the whole declared span
            cur = chain[-1] if chain else self.root
            walk = pos == shared_usable
        else:
            cur = lnode
            walk = True
        while walk and pos < len(toks):
            child = cur.children.get(self._child_key(cur, lora_id, toks[pos:]))
            if child is None:
                break
            common = _common_prefix_len(child.tokens, toks[pos:])
            common = (common // self.align) * self.align
            if common == 0:
                break
            if common < len(child.tokens):
                # partial edge coverage: split radix-style so the shared
                # (align-quantized) prefix becomes matchable (SGLang-like).
                child = self._split(child, common)
            child.touch(now, self.decay_tau)
            chain.append(child)
            pos += common
            cur = child
        if chain:
            last = chain[-1]
        else:
            last = self.root if shared_usable else lnode
        return MatchResult(lnode, chain, pos, last,
                           shared_matched_tokens=shared_matched)

    def probe_chain(self, lora_id: str, tokens: Sequence[Token],
                    shared_len: int = 0) -> list[tuple[Node, int]]:
        """READ-ONLY prefix-match estimate: (node, covered tokens) pairs.

        Mirrors :meth:`match`'s trunk-then-fork walk but never touches visit
        counters, never bumps the decayed total, and never splits a
        partially-covered edge — the deadline-aware admission order probes
        every waiting request every step, and a mutating probe would skew the
        cost model's visit-frequency statistics (and restructure the radix
        tree) in proportion to queue depth. The walk stops at the first
        partially-covered edge after counting its align-quantized common
        prefix, which is exactly where a real match would also stop after its
        split — so the covered-token total matches what admission will see
        (modulo forks hanging below a would-be split point: a rare, strict
        underestimate, acceptable for a cost estimate).
        """
        toks = tuple(tokens)
        usable = (len(toks) // self.align) * self.align
        toks = toks[:usable]
        shared_usable = (min(max(shared_len, 0), len(toks)) // self.align
                         ) * self.align
        out: list[tuple[Node, int]] = []
        pos = 0
        cur: Node = self.root
        if shared_usable:
            while pos < shared_usable:
                child = cur.children.get(toks[pos : pos + self.align])
                if child is None:
                    break
                common = _common_prefix_len(child.tokens, toks[pos:shared_usable])
                common = (common // self.align) * self.align
                if common == 0:
                    break
                out.append((child, common))
                pos += common
                if common < len(child.tokens):
                    return out  # partial edge: a real match stops here too
                cur = child
        lnode = self._lora_nodes.get(lora_id)
        if lnode is None:
            return out
        if shared_usable:
            if pos != shared_usable:
                return out  # trunk didn't cover the span: no fork walk
        else:
            cur = lnode
        while pos < len(toks):
            child = cur.children.get(self._child_key(cur, lora_id, toks[pos:]))
            if child is None:
                break
            common = _common_prefix_len(child.tokens, toks[pos:])
            common = (common // self.align) * self.align
            if common == 0:
                break
            out.append((child, common))
            pos += common
            if common < len(child.tokens):
                break
            cur = child
        return out

    def insert_kv(
        self,
        parent: Node,
        tokens: Sequence[Token],
        size_bytes: int,
        num_blocks: int,
        tier: Residency,
        now: float,
    ) -> Node:
        """Insert a KV node under ``parent`` (a LoRA or KV node).

        ``tokens`` is the *suffix* below the parent's path; with align>1 its
        length must be a multiple of ``align``. If the suffix partially
        overlaps an existing child edge, the edge is split radix-style at the
        divergence point (always align-quantized by construction — see the
        children-keying comment on :class:`Node`); sizes divide
        proportionally and the absorbed prefix reuses the existing node.
        Returns the deepest node covering the suffix. Callers needing to know
        how many leading tokens were absorbed by existing nodes should use
        :meth:`insert_kv_ext`.
        """
        node, _ = self.insert_kv_ext(parent, tokens, size_bytes, num_blocks, tier, now)
        return node

    def insert_kv_ext(
        self,
        parent: Node,
        tokens: Sequence[Token],
        size_bytes: int,
        num_blocks: int,
        tier: Residency,
        now: float,
        kind: NodeKind = NodeKind.KV,
        lora_id: object = _INHERIT,
    ) -> tuple[Node, int]:
        """Like :meth:`insert_kv` but also returns the number of leading
        suffix tokens absorbed by pre-existing/split nodes (their data-plane
        blocks are redundant and should be freed by the caller).

        ``kind=NodeKind.STATE`` inserts a state-snapshot boundary instead of
        a KV prefix: callers insert the node as a hollow husk
        (``size_bytes=0, num_blocks=0``) and attach the indivisible snapshot
        payload to the *returned* node after allocating its blocks — the
        per-token proportional size split below is meaningless for a
        fixed-size snapshot.

        ``lora_id`` defaults to inheriting the parent's label. Pass ``None``
        explicitly to grow the shared base-model trunk (parent must be the
        root or another trunk node), or an adapter id to fork an
        adapter-divergent branch off a trunk node."""
        toks = tuple(tokens)
        if not toks:
            raise ValueError("cannot insert empty KV edge")
        if self.align > 1 and len(toks) % self.align != 0:
            raise ValueError(
                f"edge length {len(toks)} not a multiple of align={self.align}"
            )
        if lora_id is _INHERIT:
            lora_id = parent.lora_id
        if parent.kind is NodeKind.ROOT and lora_id is not None:
            raise ValueError(
                "adapter-labelled KV must live under a LoRA or shared branch")
        if lora_id is None and kind is not NodeKind.KV:
            raise ValueError("shared trunk nodes must be KV kind")
        if kind is NodeKind.STATE and parent.lora_id is None:
            # a snapshot is the full model state INCLUDING the adapter's
            # contribution, so it is never adapter-independent
            raise ValueError("STATE snapshots cannot fork off the shared trunk")
        bytes_per_token = size_bytes / len(toks)
        absorbed = 0
        while True:
            existing = parent.children.get(self._child_key(parent, lora_id, toks))
            if existing is None:
                node = Node(
                    kind=kind,
                    lora_id=lora_id,
                    tokens=toks,
                    tier=tier,
                    parent=parent,
                    size_bytes=int(round(bytes_per_token * len(toks))),
                    num_blocks=num_blocks,
                )
                # creation counts as a visit: a freshly committed node is the
                # most-recent state of a live conversation — without this the
                # cost model (prob=0) would evict exactly the nodes most
                # likely to be re-hit on the next turn.
                node.touch(now, self.decay_tau)
                parent.children[self._child_key(parent, lora_id, toks)] = node
                return node, absorbed
            common = _common_prefix_len(existing.tokens, toks)
            common = (common // self.align) * self.align
            if common < self.align:
                raise PoolInvariantError("sibling key collision without overlap")
            if common < len(existing.tokens):
                existing = self._split(existing, common)
            existing.touch(now, self.decay_tau)
            if common == len(toks):
                return existing, absorbed + common  # fully absorbed
            parent = existing
            toks = toks[common:]
            absorbed += common
            num_blocks = max(0, num_blocks - common // self.block_tokens)

    def _split(self, node: Node, at: int) -> Node:
        """Split ``node``'s edge at token offset ``at``; returns the new upper
        node. Stats are copied; sizes divide proportionally (block counts are
        re-derived by the manager for data-plane nodes).

        STATE nodes split *hollow*: a snapshot is the full model state at the
        node's own boundary, so there is no data for the intermediate
        boundary — the upper node gets zero bytes/blocks (pure trie
        structure) and the payload stays whole on the lower node."""
        if not 0 < at < len(node.tokens):
            raise PoolInvariantError(
                f"split offset {at} outside edge of node {node.node_id} "
                f"({len(node.tokens)} tokens)"
            )
        upper_tokens, lower_tokens = node.tokens[:at], node.tokens[at:]
        frac = 0.0 if node.kind is NodeKind.STATE else at / len(node.tokens)
        upper = Node(
            kind=node.kind,
            lora_id=node.lora_id,
            tokens=upper_tokens,
            tier=node.tier,
            parent=node.parent,
            size_bytes=int(node.size_bytes * frac),
            num_blocks=0,
            visit_count=node.visit_count,
            last_access=node.last_access,
            last_decay=node.last_decay,
        )
        if node.parent is None:
            raise PoolInvariantError(
                f"cannot split detached node {node.node_id} (no parent)"
            )
        # a fork root keeps its composite (lora_id, chunk) key in the shared
        # parent's child map; the lower half re-keys plainly under the upper
        node.parent.children[
            self._child_key(node.parent, node.lora_id, upper_tokens)] = upper
        node.parent = upper
        node.tokens = lower_tokens
        node.size_bytes -= upper.size_bytes
        upper.children[self._child_key(upper, node.lora_id, lower_tokens)] = node
        # split block ownership at the aligned boundary (KV only: a state
        # snapshot is indivisible and stays entirely on the lower node)
        if node.kind is not NodeKind.STATE and (node.hbm_blocks or node.host_blocks):
            nb_upper = at // self.block_tokens
            for attr in ("hbm_blocks", "host_blocks"):
                blocks = getattr(node, attr)
                if blocks:
                    setattr(upper, attr, blocks[:nb_upper])
                    setattr(node, attr, blocks[nb_upper:])
            upper.num_blocks = len(upper.hbm_blocks) + len(upper.host_blocks)
            node.num_blocks = len(node.hbm_blocks) + len(node.host_blocks)
        # NOTE: ref_count stays on the lower (original) node only. Pins are
        # held on the *deepest* node of a matched path; ancestors (incl. the
        # new upper) are protected structurally because they have an
        # HBM-resident child and leaf-only eviction never touches them.
        return upper

    def remove(self, node: Node) -> None:
        """Remove a (childless, unpinned) node from the tree."""
        if node.children:
            raise ValueError("cannot remove a node with children")
        if node.ref_count:
            raise ValueError("cannot remove a pinned node")
        parent = node.parent
        if parent is None:
            raise PoolInvariantError(
                f"cannot remove already-detached node {node.node_id}"
            )
        if node.kind is NodeKind.LORA:
            del parent.children[node.node_id]
            del self._lora_nodes[node.lora_id]  # type: ignore[arg-type]
        else:
            del parent.children[self._child_key(parent, node.lora_id, node.tokens)]
        node.parent = None

    # ------------------------------------------------------------ traversals
    def iter_nodes(self, kinds: Optional[set[NodeKind]] = None) -> Iterator[Node]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.kind is NodeKind.ROOT:
                continue
            if kinds is None or n.kind in kinds:
                yield n

    def dependent_fork_loras(self, node: Node) -> set[str]:
        """Adapter ids with fork KV depending on this shared trunk node.

        Walks the subtree below ``node``; descends through deeper trunk
        nodes (their forks depend on this node too) and stops at the first
        adapter-labelled node on each path — everything below it belongs to
        the same adapter. Evicting ``node`` invalidates all of these forks,
        so the cost model prices it by their summed recompute."""
        out: set[str] = set()
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.lora_id is not None:
                out.add(n.lora_id)
                continue
            stack.extend(n.children.values())
        return out

    def shared_nodes(self) -> list[Node]:
        """All shared base-model trunk nodes (``lora_id=None`` KV)."""
        return [n for n in self.iter_nodes({NodeKind.KV}) if n.is_shared]

    def hbm_leaves(self) -> list[Node]:
        """Swap-out candidates (paper §4.2: evict leaves only)."""
        return [n for n in self.iter_nodes() if n.is_hbm_leaf()]

    def host_roots(self) -> list[Node]:
        """Swap-in candidates (paper §4.2: load subtree roots only)."""
        return [n for n in self.iter_nodes() if n.is_host_root()]

    def hbm_nodes(self) -> list[Node]:
        return [n for n in self.iter_nodes() if n.tier is Residency.HBM]

    def resident_lora_count(self) -> int:
        return sum(
            1 for n in self._lora_nodes.values() if n.tier is Residency.HBM
        )

    # ------------------------------------------------------------ statistics
    def _bump_total(self, now: float) -> None:
        if self.decay_tau > 0 and self._last_visit_decay < now:
            self._total_visits *= math.exp(
                -(now - self._last_visit_decay) / self.decay_tau
            )
        self._total_visits += 1.0
        self._last_visit_decay = now

    def total_visits(self, now: float) -> float:
        if self.decay_tau <= 0 or now <= self._last_visit_decay:
            return self._total_visits
        return self._total_visits * math.exp(
            -(now - self._last_visit_decay) / self.decay_tau
        )

    def visit_prob(self, node: Node, now: float) -> float:
        """prob_i — the node's decayed visit share of all query arrivals."""
        tot = self.total_visits(now)
        if tot <= 0:
            return 0.0
        return min(1.0, node.decayed_visits(now, self.decay_tau) / tot)

    def check_validity_invariant(self) -> None:
        """Every HBM node's parent must be HBM (or the root): no invalid KVs."""
        for n in self.iter_nodes():
            if n.tier is Residency.HBM and n.parent is not None:
                p = n.parent
                if not (p.kind is NodeKind.ROOT or p.tier is Residency.HBM):
                    raise PoolInvariantError(
                        f"validity invariant violated at node {n.node_id} "
                        f"({n.kind}, lora={n.lora_id})"
                    )

    def invalid_hbm_bytes(self) -> int:
        """Bytes of HBM-resident KV whose ancestry is NOT fully resident.

        Always 0 for FastLibra-managed trees; baseline policies (WOM, vLLM)
        report nonzero values here — this reproduces the paper's 46–48 %
        invalid-KV measurements.
        """
        out = 0
        for n in self.iter_nodes({NodeKind.KV, NodeKind.STATE}):
            if n.tier is not Residency.HBM:
                continue
            p = n.parent
            valid = True
            while p is not None and p.kind is not NodeKind.ROOT:
                if p.tier is not Residency.HBM:
                    valid = False
                    break
                p = p.parent
            if not valid:
                out += n.size_bytes
        return out


def _common_prefix_len(a: TokenSeq, b: TokenSeq) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
