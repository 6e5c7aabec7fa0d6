"""libra-check runtime layer: the pool-invariant sanitizer.

The unified caching pool now spans three object kinds (LoRA adapters,
per-token KV prefixes, recurrent-state snapshots), two tiers, open-query
running blocks, and a scorer-driven eviction loop — and its invariants are
subtle enough that PR 5's hypothesis fuzz caught an admit bug (make-room
evicting a node of the same admission's working set) that no unit test had.
This module makes those invariants *machine-checked*:

:func:`check_pool_invariants` validates the full structural state of a
:class:`~repro_torch.core.cache_manager.CacheManager` — byte-accounting exactness,
parent-residency validity chains, block aliasing/leaks, radix structure,
hollow-STATE interior rules, open-query pin bookkeeping, scorer consistency
— and raises a structured :class:`PoolInvariantError` carrying every
violation plus a dependency-tree dump.

With ``REPRO_SANITIZE=1`` (or ``ManagerConfig(sanitize=True)``) the manager
runs the full pass after **every mutating operation** (lookup/admit/
allocate/commit/abort/swap-sweep), so a corruption is caught at the op that
introduced it, not at whatever later op happens to trip over it. The checks
are pure reads — enabling the sanitizer never changes pool behavior.

This module deliberately has **no top-level imports from the rest of
``repro_torch.core``** (the core modules import :class:`PoolInvariantError` from
here, so a top-level back-import would be a cycle) and no jax dependency:
the jit-cache probe below duck-types on the compiled-function attribute.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Iterable, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .cache_manager import CacheManager
    from .dependency_tree import DependencyTree, Node


class PoolInvariantError(AssertionError):
    """A machine-checked pool invariant does not hold.

    Subclasses :class:`AssertionError` so callers (and tests) that guarded
    the old ``assert``-based checks keep working — but unlike ``assert``,
    these raises survive ``python -O``. ``violations`` lists every failed
    invariant from the sweep that raised; ``dump`` is a rendering of the
    dependency tree at failure time.
    """

    def __init__(self, message: str, *, violations: Iterable[str] = (),
                 dump: str = ""):
        self.violations = list(violations) or [message]
        self.dump = dump
        text = message
        if len(self.violations) > 1:
            text += "\n" + "\n".join(f"  - {v}" for v in self.violations)
        if dump:
            text += "\n--- dependency tree at failure ---\n" + dump
        super().__init__(text)


def sanitize_enabled() -> bool:
    """Whether ``REPRO_SANITIZE`` asks for per-op invariant checking."""
    return os.environ.get("REPRO_SANITIZE", "").strip() not in ("", "0")


# --------------------------------------------------------------- tree dump
def dump_tree(tree: "DependencyTree", max_nodes: int = 200) -> str:
    """Human-readable dump of the dependency tree (for error reports)."""
    lines: list[str] = []

    def walk(node: "Node", depth: int) -> None:
        if len(lines) >= max_nodes:
            return
        tier = node.tier.value if node.tier is not None else "-"
        lines.append(
                "  " * depth
                + f"[{node.kind.value}#{node.node_id}] lora={node.lora_id} "
                f"ntok={node.num_tokens} tier={tier} "
                f"hbm={len(node.hbm_blocks)} host={len(node.host_blocks)} "
                f"nblk={node.num_blocks} bytes={node.size_bytes} "
                f"ref={node.ref_count}"
        )
        for child in node.children.values():
            walk(child, depth + 1)

    walk(tree.root, 0)
    if len(lines) >= max_nodes:
        lines.append(f"... (truncated at {max_nodes} nodes)")
    return "\n".join(lines)


# --------------------------------------------------------- jit-cache probe
def jit_cache_size(fn: object) -> int:
    """Number of distinct programs a jitted callable has traced/compiled.

    Duck-types on jax's compiled-function cache probe so this module stays
    jax-free; a plain (un-jitted) callable counts as 0. The compile-count
    regression tests assert bounds on sums of these across an engine's
    jitted entry points — a recompile storm (e.g. a non-static Python
    scalar in a jit signature) shows up as an unbounded count.
    """
    size = getattr(fn, "_cache_size", None)
    if callable(size):
        return int(size())
    return 0


# ------------------------------------------------------------- the checks
def _iter_pools(mgr: "CacheManager"):
    """(name, pool) pairs, unique by identity (non-unified mode has two)."""
    seen: dict[int, str] = {}
    for name, pool in (("pool", mgr.pool), ("lora_pool", mgr.lora_pool),
                       ("kv_pool", mgr.kv_pool)):
        if id(pool) not in seen:
            seen[id(pool)] = name
            yield name, pool


def _check_pool_partition(mgr: "CacheManager", out: list[str]) -> None:
    """I-pool: per tier, free and allocated ids partition [0, total)."""
    from .block_pool import Tier

    for name, pool in _iter_pools(mgr):
        for tier, total in ((Tier.HBM, pool.num_hbm_blocks),
                            (Tier.HOST, pool.num_host_blocks)):
            free = set(pool._free[tier])
            alloc = pool._allocated[tier]
            if len(free) != len(pool._free[tier]):
                out.append(f"pool-partition: {name}/{tier.value} free list "
                           f"has duplicate ids")
            if not free.isdisjoint(alloc):
                out.append(f"pool-partition: {name}/{tier.value} "
                           f"double-booked blocks {sorted(free & alloc)[:8]}")
            if len(free) + len(alloc) != total or free | alloc != set(range(total)):
                out.append(
                    f"pool-partition: {name}/{tier.value} id space corrupt "
                    f"(free={len(free)} alloc={len(alloc)} total={total})")


def _check_tier_residency(mgr: "CacheManager", out: list[str]) -> None:
    """I-tier: a node's block lists agree with its residency tier."""
    from .dependency_tree import NodeKind, Residency

    for n in mgr.tree.iter_nodes():
        if n.tier is Residency.HBM and n.host_blocks:
            out.append(f"tier-residency: HBM node #{n.node_id} owns "
                       f"{len(n.host_blocks)} host blocks")
        if n.tier is Residency.HOST and n.hbm_blocks:
            out.append(f"tier-residency: host node #{n.node_id} owns "
                       f"{len(n.hbm_blocks)} HBM blocks")
        if n.tier is None and (n.hbm_blocks or n.host_blocks):
            out.append(f"tier-residency: dropped node #{n.node_id} still "
                       f"owns data-plane blocks")
        if n.kind in (NodeKind.KV, NodeKind.LORA) and n.tier is not None:
            held = len(n.hbm_blocks) + len(n.host_blocks)
            if held != n.num_blocks:
                out.append(
                    f"tier-residency: {n.kind.value} node #{n.node_id} "
                    f"num_blocks={n.num_blocks} but holds {held}")


def _check_validity_chain(mgr: "CacheManager", out: list[str]) -> None:
    """I-validity: HBM node => parent HBM (no HBM payload under a host
    ancestor) — the paper's zero-invalid-KV property. Dependency-maintained
    managers only; baselines (WOM/vLLM) violate this by design."""
    from .dependency_tree import NodeKind, Residency

    if not mgr.config.maintain_dependencies:
        return
    for n in mgr.tree.iter_nodes():
        if n.tier is Residency.HBM and n.parent is not None:
            p = n.parent
            if not (p.kind is NodeKind.ROOT or p.tier is Residency.HBM):
                out.append(
                    f"validity-chain: HBM node #{n.node_id} "
                    f"({n.kind.value}, lora={n.lora_id}) under "
                    f"non-resident parent #{p.node_id} (tier={p.tier})")
    bad = mgr.tree.invalid_hbm_bytes()
    if bad:
        out.append(f"validity-chain: {bad} invalid HBM bytes "
                   f"(dependency-maintained manager must report 0)")


def _owned_blocks(mgr: "CacheManager"):
    """(hbm_by_pool, host_owned) maps of every owned block with its owner."""
    hbm: dict[int, dict[int, str]] = {}
    host: dict[int, str] = {}
    dup: list[str] = []

    def own(table: dict[int, str], b: int, owner: str) -> None:
        if b in table:
            dup.append(f"block-aliasing: block {b} owned by both "
                       f"{table[b]} and {owner}")
        else:
            table[b] = owner

    for n in mgr.tree.iter_nodes():
        pool = mgr._pool_for(n.kind)
        tab = hbm.setdefault(id(pool), {})
        for b in n.hbm_blocks:
            own(tab, b, f"node#{n.node_id}")
        for b in n.host_blocks:
            own(host, b, f"node#{n.node_id}")
    kv_tab = hbm.setdefault(id(mgr.kv_pool), {})
    for qid, blocks in mgr._running.items():
        for b in blocks:
            own(kv_tab, b, f"running:{qid}")
    return hbm, host, dup


def _check_block_ownership(mgr: "CacheManager", out: list[str]) -> None:
    """I-alias + I-leak: every owned block is allocated exactly once, and
    every allocated block has exactly one owner (tree node or running
    query) — byte accounting is exact, not merely bounded."""
    from .block_pool import Tier

    hbm_by_pool, host_owned, dup = _owned_blocks(mgr)
    out.extend(dup)
    for name, pool in _iter_pools(mgr):
        owned = hbm_by_pool.get(id(pool), {})
        alloc = pool._allocated[Tier.HBM]
        missing = set(owned) - alloc
        orphan = alloc - set(owned)
        if missing:
            out.append(f"block-ownership: {name}/hbm owned-but-unallocated "
                       f"{sorted(missing)[:8]}")
        if orphan:
            out.append(f"block-ownership: {name}/hbm allocated-but-unowned "
                       f"(leaked) {sorted(orphan)[:8]}")
    # host free/allocated structures are shared between pools in the
    # non-unified layout, so the host tier is checked once via mgr.pool
    host_alloc = mgr.pool._allocated[Tier.HOST]
    missing = set(host_owned) - host_alloc
    orphan = host_alloc - set(host_owned)
    if missing:
        out.append(f"block-ownership: host owned-but-unallocated "
                   f"{sorted(missing)[:8]}")
    if orphan:
        out.append(f"block-ownership: host allocated-but-unowned (leaked) "
                   f"{sorted(orphan)[:8]}")


def _check_byte_accounting(mgr: "CacheManager", out: list[str]) -> None:
    """I-bytes: hbm_breakdown() component sums == block-pool used bytes ==
    per-node block sums, *exactly*."""
    from .block_pool import Tier

    bb = mgr.config.block_bytes
    bd = mgr.hbm_breakdown()
    comp = (bd["lora_bytes"] + bd["history_kv_bytes"] + bd["shared_kv_bytes"]
            + bd["state_snapshot_bytes"] + bd["running_kv_bytes"])
    pool_used = sum(
        (pool.num_hbm_blocks - len(pool._free[Tier.HBM])) * bb
        for _, pool in _iter_pools(mgr)
    )
    node_sum = sum(len(n.hbm_blocks) for n in mgr.tree.iter_nodes()) * bb
    node_sum += sum(len(b) for b in mgr._running.values()) * bb
    if comp != pool_used:
        out.append(f"byte-accounting: breakdown components sum to {comp} "
                   f"but block pools have {pool_used} HBM bytes in use")
    if node_sum != pool_used:
        out.append(f"byte-accounting: per-node HBM bytes {node_sum} != "
                   f"pool used bytes {pool_used}")
    if comp > bd["total_bytes"]:
        out.append(f"byte-accounting: used {comp} exceeds capacity "
                   f"{bd['total_bytes']}")


def _check_radix_structure(mgr: "CacheManager", out: list[str]) -> None:
    """I-radix: child keys match edge labels, parent pointers are
    consistent, KV edges are align-quantized, siblings never share an
    align-chunk prefix (match/split determinism depends on this)."""
    from .dependency_tree import NodeKind

    tree = mgr.tree
    align = tree.align
    stack = [tree.root]
    while stack:
        n = stack.pop()
        for key, child in n.children.items():
            if child.parent is not n:
                out.append(f"radix-structure: child #{child.node_id} of "
                           f"#{n.node_id} has parent pointer "
                           f"{child.parent and child.parent.node_id}")
            if child.kind is NodeKind.LORA:
                if key != child.node_id:
                    out.append(f"radix-structure: LoRA node #{child.node_id}"
                               f" keyed by {key!r}, expected its node_id")
            else:
                if not child.tokens:
                    out.append(f"radix-structure: {child.kind.value} node "
                               f"#{child.node_id} has an empty edge label")
                elif key != tree._child_key(n, child.lora_id, child.tokens):
                    out.append(
                        f"radix-structure: node #{child.node_id} keyed by "
                        f"{key!r} but expected "
                        f"{tree._child_key(n, child.lora_id, child.tokens)!r}")
                if child.kind is NodeKind.KV and len(child.tokens) % align:
                    out.append(f"radix-structure: KV node #{child.node_id} "
                               f"edge length {len(child.tokens)} not a "
                               f"multiple of align={align}")
            stack.append(child)


def _check_lora_registry(mgr: "CacheManager", out: list[str]) -> None:
    """I-lora: the LoRA registry and the second tree layer agree, and every
    prefix node's lora_id is consistent with its parent — inherited inside a
    branch, forking (adapter label under a shared parent) only at the trunk
    boundary, and never adapter-labelled directly under the root."""
    from .dependency_tree import NodeKind

    tree = mgr.tree
    layer = {n.node_id: n for n in tree.root.children.values()}
    for lid, node in tree._lora_nodes.items():
        if node.kind is not NodeKind.LORA or node.lora_id != lid:
            out.append(f"lora-registry: registry entry {lid!r} points at "
                       f"{node.kind.value} node #{node.node_id} "
                       f"(lora_id={node.lora_id!r})")
        if node.node_id not in layer:
            out.append(f"lora-registry: {lid!r} node #{node.node_id} is not "
                       f"a child of the root")
    for n in tree.iter_nodes():
        if n.kind is NodeKind.LORA:
            if tree._lora_nodes.get(n.lora_id) is not n:
                out.append(f"lora-registry: LoRA node #{n.node_id} "
                           f"({n.lora_id!r}) missing from the registry")
            continue
        p = n.parent
        if p is None:
            continue
        if p.kind is NodeKind.ROOT:
            if n.lora_id is not None:
                out.append(f"lora-registry: adapter-labelled node "
                           f"#{n.node_id} (lora={n.lora_id!r}) directly "
                           f"under the root")
        elif p.lora_id is not None:
            # inside a LoRA branch or an adapter fork: labels inherit
            if n.lora_id != p.lora_id:
                out.append(f"lora-registry: node #{n.node_id} labelled "
                           f"lora={n.lora_id!r} lives under branch "
                           f"{p.lora_id!r}")
        elif n.lora_id is not None and n.lora_id not in tree._lora_nodes:
            # fork root off the shared trunk: its adapter must be registered
            out.append(f"lora-registry: fork root #{n.node_id} references "
                       f"unregistered adapter {n.lora_id!r}")


def _check_shared_prefix(mgr: "CacheManager", out: list[str]) -> None:
    """I-shared: shared-trunk structure. Trunk nodes are KV-kind with
    ``lora_id=None`` and live only under the root or another trunk node;
    no trunk exists when sharing is disabled; STATE never forks off the
    trunk; every fork root hangs off a live (root-reachable) shared parent
    under its composite child key; and ``hbm_breakdown()`` splits
    ``shared_kv_bytes`` exactly."""
    from .dependency_tree import NodeKind

    tree = mgr.tree
    bb = mgr.config.block_bytes
    shared_blocks = 0
    for n in tree.iter_nodes():
        if n.kind is not NodeKind.LORA and n.lora_id is None:
            if n.kind is not NodeKind.KV:
                out.append(f"shared-prefix: {n.kind.value} node #{n.node_id}"
                           f" carries lora_id=None (trunk is KV-only)")
                continue
            shared_blocks += len(n.hbm_blocks)
            if not mgr.config.share_prefix_kv:
                out.append(f"shared-prefix: trunk node #{n.node_id} exists "
                           f"with share_prefix_kv disabled")
            p = n.parent
            if p is not None and not (p.kind is NodeKind.ROOT
                                      or (p.kind is NodeKind.KV
                                          and p.lora_id is None)):
                out.append(f"shared-prefix: trunk node #{n.node_id} under "
                           f"non-trunk parent #{p.node_id} "
                           f"({p.kind.value}, lora={p.lora_id!r})")
        elif (n.parent is not None and n.parent.kind is NodeKind.KV
              and n.parent.lora_id is None):
            # adapter fork root off the shared trunk
            if n.kind is NodeKind.STATE:
                out.append(f"shared-prefix: STATE snapshot #{n.node_id} "
                           f"forks off the shared trunk")
            top = n.parent
            while top.parent is not None:
                top = top.parent
            if top is not tree.root:
                out.append(f"shared-prefix: fork root #{n.node_id} "
                           f"references a detached shared parent "
                           f"#{n.parent.node_id}")
            key = tree._child_key(n.parent, n.lora_id, n.tokens)
            if n.parent.children.get(key) is not n:
                out.append(f"shared-prefix: fork root #{n.node_id} not "
                           f"reachable from its shared parent under key "
                           f"{key!r}")
    want = shared_blocks * bb
    got = mgr.hbm_breakdown()["shared_kv_bytes"]
    if got != want:
        out.append(f"shared-prefix: hbm_breakdown shared_kv_bytes={got} but "
                   f"trunk nodes own {want} HBM bytes")


def _check_hollow_state(mgr: "CacheManager", out: list[str]) -> None:
    """I-state: snapshot payloads are whole (exactly state_blocks in exactly
    one tier) and hollow interiors are pure trie structure."""
    from .dependency_tree import NodeKind

    sb = mgr.config.state_blocks
    for n in mgr.tree.iter_nodes({NodeKind.STATE}):
        if n.has_payload:
            if n.hbm_blocks and n.host_blocks:
                out.append(f"hollow-state: snapshot #{n.node_id} split "
                           f"across tiers")
            held = len(n.hbm_blocks or n.host_blocks)
            if held != sb or n.num_blocks != sb:
                out.append(
                    f"hollow-state: snapshot #{n.node_id} holds {held} "
                    f"blocks (num_blocks={n.num_blocks}), expected {sb} — "
                    f"snapshots are fixed-size and indivisible")
        else:
            # a hollow interior owns nothing; a dropped snapshot keeps its
            # nominal num_blocks only with tier=None
            if not (n.num_blocks == 0 or n.tier is None):
                out.append(f"hollow-state: payload-less STATE #{n.node_id} "
                           f"claims num_blocks={n.num_blocks} with "
                           f"tier={n.tier}")


def _check_pin_bookkeeping(mgr: "CacheManager", out: list[str]) -> None:
    """I-pin: ref counts are non-negative and every open query's running
    block list matches its recorded token count exactly (the abort path
    must leave no residue)."""
    for n in mgr.tree.iter_nodes():
        if n.ref_count < 0:
            out.append(f"pin-bookkeeping: node #{n.node_id} ref_count="
                       f"{n.ref_count}")
    for qid in mgr._running_tokens:
        if qid not in mgr._running:
            out.append(f"pin-bookkeeping: query {qid!r} has a token count "
                       f"but no running block list")
    for qid, blocks in mgr._running.items():
        toks = mgr._running_tokens.get(qid, 0)
        want = mgr.kv_blocks_for(toks) if toks else 0
        if len(blocks) != want:
            out.append(f"pin-bookkeeping: query {qid!r} holds {len(blocks)} "
                       f"running blocks for {toks} tokens (expected {want})")


def _check_scorer_consistency(mgr: "CacheManager", out: list[str]) -> None:
    """I-score: the eviction scorer is usable — every candidate the swapper
    could pick scores to a finite, repeatable value, and the structural
    leaf/root candidate predicates actually hold for what the tree
    enumerates. A NaN (or nondeterministic) score silently scrambles
    ascending-Eval eviction order."""
    import math

    now = max((n.last_access for n in mgr.tree.iter_nodes()), default=0.0)
    for n in mgr.tree.hbm_leaves():
        if n.hbm_children() or n.ref_count != 0:
            out.append(f"scorer-consistency: hbm_leaves() returned "
                       f"#{n.node_id} which is not an unpinned HBM leaf")
        s1 = mgr.scorer.score(n, now)
        s2 = mgr.scorer.score(n, now)
        if not math.isfinite(s1):
            out.append(f"scorer-consistency: non-finite score {s1!r} for "
                       f"candidate #{n.node_id}")
        elif s1 != s2:
            out.append(f"scorer-consistency: score for #{n.node_id} is not "
                       f"repeatable ({s1!r} != {s2!r})")
    for n in mgr.tree.host_roots():
        if n.parent is None or not n.is_host_root():
            out.append(f"scorer-consistency: host_roots() returned "
                       f"#{n.node_id} which is not a host root")


def _check_preempted_residue(mgr: "CacheManager", out: list[str]) -> None:
    """I-preempt: a preempted query left nothing behind in the running set.

    ``preempt_running`` demotes the victim's computed KV into the tree (or
    releases it) and records the query in ``_preempted``; until a resume
    ``allocate_running`` clears the mark, the query must hold zero running
    blocks and zero running-token bookkeeping — a leak here is exactly the
    "preemption discards the bookkeeping but not the blocks" failure mode
    this family exists to catch. The folded KV itself must be demotable:
    preemption never leaves it pinned (ref_count is the engine's admission
    pin, which the engine drops before preempting)."""
    for qid in mgr._preempted:
        if mgr._running.get(qid):
            out.append(f"preempted-residue: query {qid!r} was preempted but "
                       f"still holds {len(mgr._running[qid])} running blocks")
        if mgr._running_tokens.get(qid, 0):
            out.append(f"preempted-residue: query {qid!r} was preempted but "
                       f"still has running token count "
                       f"{mgr._running_tokens[qid]}")


_CHECKS = (
    _check_pool_partition,
    _check_tier_residency,
    _check_validity_chain,
    _check_block_ownership,
    _check_byte_accounting,
    _check_radix_structure,
    _check_lora_registry,
    _check_shared_prefix,
    _check_hollow_state,
    _check_pin_bookkeeping,
    _check_scorer_consistency,
    _check_preempted_residue,
)


def check_pool_invariants(mgr: "CacheManager", context: str = "") -> None:
    """Run every structural invariant over ``mgr``; raise a structured
    :class:`PoolInvariantError` (with a tree dump) if any fail.

    Pure reads only — safe to call at any quiescent point (the manager's
    sanitize hooks call it after every mutating public operation).
    """
    violations: list[str] = []
    for check in _CHECKS:
        check(mgr, violations)
    if violations:
        where = f" after {context}" if context else ""
        raise PoolInvariantError(
            f"{len(violations)} pool invariant violation(s){where}",
            violations=violations,
            dump=dump_tree(mgr.tree),
        )
