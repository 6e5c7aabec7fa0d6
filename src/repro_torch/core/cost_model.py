"""Performance-driven cost model (FASTLIBRA §5).

Implements Equations 3–6 of the paper:

  Low_lora        = Σ_i (1 − (1 − prob_i)^BS)                         (Eq. 3)
  LoRA_Eval_i     = max(1, Low_lora / Now_lora)        (LoRA nodes)   (Eq. 4)
  Retain_Eval_i   = cost_i · prob_i · (1 − sigmoid(t_i))              (Eq. 5)
  Eval_i          = LoRA_Eval_i · Retain_Eval_i                       (Eq. 6)

``cost_i`` is the node's swap (transfer) cost in seconds = bytes / PCIe bw;
``prob_i`` the decayed visit-frequency share recorded on the dependency tree;
``t_i`` the time since last use. The paper does not state a time scale for
the sigmoid forget gate — we introduce ``sigmoid_tau`` (default 15 s, tuned — see EXPERIMENTS.md §Perf-policy) so that
``sigmoid(t_i / tau)`` spans its dynamic range over realistic inter-arrival
gaps; this is recorded as an assumption in DESIGN.md.

A node with a *higher* ``Eval`` benefits TTFT more when retained in HBM, so
swap-out consumes candidates in ascending order and swap-in in descending
order (§5.3).

Scorers are pluggable so the ablations drop in cleanly:
  * :class:`CostModelScorer` — full FASTLIBRA (Eq. 6).
  * ``CostModelScorer(lora_reward=False)`` — FASTLIBRA-WOL (Eq. 4 removed).
  * :class:`LRUScorer` — FASTLIBRA-WOS / vLLM-style LRU ordering.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol

from .dependency_tree import DependencyTree, Node, NodeKind


def sigmoid(x: float) -> float:
    if x >= 0:
        z = math.exp(-x)
        return 1.0 / (1.0 + z)
    z = math.exp(x)
    return z / (1.0 + z)


@dataclasses.dataclass
class HardwareModel:
    """Host↔HBM link + accelerator constants used for swap-cost estimates.

    Defaults follow the paper's platform (Table 1): PCIe 4.0 ×16 ≈ 32 GB/s
    raw, ~26 GB/s effective; NPU 256 TFLOPS fp16 with 64 GB HBM.
    """

    pcie_bw_bytes: float = 2e9  # effective copy bw (see sim.hardware.NPUSpec)
    pcie_latency_s: float = 10e-6
    hbm_bytes: int = 64 * 1024**3
    host_bytes: int = 256 * 1024**3
    flops_fp16: float = 256e12
    hbm_bw_bytes: float = 1.6e12  # HBM2e-class NPU
    # per-token prefill compute time — the recompute a retained state
    # snapshot saves (paper-platform scale: ~2·7e9 FLOPs/token at 55% MFU of
    # 256 TFLOPS ≈ 1e-4 s). The simulator overrides this from its deployed
    # model's roofline.
    prefill_s_per_token: float = 1e-4

    def transfer_cost(self, nbytes: int) -> float:
        return self.pcie_latency_s + nbytes / self.pcie_bw_bytes

    def recompute_cost(self, n_tokens: int) -> float:
        """Prefill cost of recomputing an ``n_tokens`` prefix from scratch."""
        return n_tokens * self.prefill_s_per_token


def admission_ttft_estimate(
    hw: HardwareModel,
    *,
    new_tokens: int,
    host_kv_bytes: int = 0,
    lora_resident: bool = True,
    lora_bytes: int = 0,
) -> float:
    """Estimated time-to-first-token for a WAITING request (SLO admission).

    The same components Eqs. 3–6 price for retention, viewed from the other
    side: prefix recompute for the unmatched suffix, swap-in transfer for any
    host-resident matched KV/state, and the adapter cold-start when its LoRA
    is not HBM-resident. Deadline-aware admission ranks waiting requests by
    ``deadline - now - estimate`` (least slack first within a priority tier),
    so a request whose cached prefix makes it cheap to serve jumps ahead of
    one that must recompute everything.
    """
    cost = hw.recompute_cost(max(0, new_tokens))
    if host_kv_bytes > 0:
        cost += hw.transfer_cost(host_kv_bytes)
    if not lora_resident and lora_bytes > 0:
        cost += hw.transfer_cost(lora_bytes)
    return cost


def expected_lora_demand(probs: list[float], batch_size: float) -> float:
    """Eq. 3 — expected number of distinct LoRAs present in a recent batch.

    ``batch_size`` is the engine's unified mixed-batch load: per-step REAL
    token count (decode rows 1 token, prefill rows their chunk), averaged
    over the last 5 s. The paper states Eq. 3 over a request count; tokens
    are the mixed-scheduler generalization — monotone in load, identical
    when every row is a 1-token decode row — so Low_lora saturates toward
    the full adapter set exactly when the batch is actually busy."""
    bs = max(0.0, batch_size)
    return sum(1.0 - (1.0 - min(1.0, max(0.0, p))) ** bs for p in probs)


class NodeScorer(Protocol):
    def score(self, node: Node, now: float) -> float:
        """Higher ⇒ more valuable to retain in HBM."""
        ...

    def refresh(self, now: float) -> None:
        """Recompute batch-level terms (Low_lora etc.) before a sweep."""
        ...


class CostModelScorer:
    """Eq. 6 scorer over the dependency tree."""

    def __init__(
        self,
        tree: DependencyTree,
        hardware: HardwareModel,
        *,
        lora_reward: bool = True,
        sigmoid_tau: float = 15.0,
        density_ordering: bool = True,
    ):
        self.tree = tree
        self.hw = hardware
        self.lora_reward = lora_reward
        self.sigmoid_tau = sigmoid_tau
        # Beyond-paper correction (EXPERIMENTS.md §Perf-policy): the paper
        # orders candidates by Eval_i directly, but Eval_i ∝ cost_i ∝ bytes,
        # so large cold nodes dominate small hot ones. Greedy knapsack should
        # rank by value *density* Eval_i / bytes. density_ordering=False
        # reproduces the paper-literal ordering for the ablation.
        self.density_ordering = density_ordering
        self._lora_eval = 1.0
        self._recent_batch_size = 0.0

    # The engine/simulator reports the recent average batch load (last 5 s,
    # §5.1) before each swapper sweep — the unified mixed-batch token count
    # under the Sarathi-style scheduler (see expected_lora_demand).
    def observe_batch_size(self, bs: float) -> None:
        self._recent_batch_size = bs

    def refresh(self, now: float) -> None:
        if not self.lora_reward:
            self._lora_eval = 1.0
            return
        probs = [self.tree.visit_prob(n, now) for n in self.tree.lora_nodes()]
        low_lora = expected_lora_demand(probs, self._recent_batch_size)
        now_lora = max(1, self.tree.resident_lora_count())
        self._lora_eval = max(1.0, low_lora / now_lora)

    @property
    def low_lora(self) -> float:
        probs = [self.tree.visit_prob(n, 0.0) for n in self.tree.lora_nodes()]
        return expected_lora_demand(probs, self._recent_batch_size)

    def retain_eval(self, node: Node, now: float) -> float:
        if node.kind is NodeKind.STATE:
            if not node.has_payload:
                # hollow radix interior: nothing to retain, evict first
                return 0.0
            # A snapshot's retention benefit is the recompute it saves — the
            # full-prefix prefill cost — not its (tiny, fixed) byte transfer
            # cost: one O(1) snapshot replaces an O(n) prefix recompute.
            cost = self.hw.recompute_cost(node.path_num_tokens())
        elif node.is_shared:
            # A shared trunk node is a dependency of fork KV under every
            # adapter below it: dropping it invalidates all of them, so its
            # retention value is the larger of its own reload cost and the
            # summed per-fork recompute of the prefix it carries.
            n_deps = max(1, len(self.tree.dependent_fork_loras(node)))
            cost = max(
                self.hw.transfer_cost(node.size_bytes),
                n_deps * self.hw.recompute_cost(node.path_num_tokens()),
            )
        else:
            cost = self.hw.transfer_cost(node.size_bytes)
        prob = self.tree.visit_prob(node, now)
        t = max(0.0, now - node.last_access)
        decay = 1.0 - sigmoid(t / self.sigmoid_tau)
        return cost * prob * decay

    def score(self, node: Node, now: float) -> float:
        ev = self.retain_eval(node, now)
        if node.kind is NodeKind.LORA:
            ev *= self._lora_eval
        if self.density_ordering:
            ev /= max(1, node.size_bytes)
        return ev


class LRUScorer:
    """Plain LRU ordering (FASTLIBRA-WOS ablation & vLLM baseline).

    Score = last access time: most-recently-used retained first.
    """

    def __init__(self, tree: DependencyTree):
        self.tree = tree

    def refresh(self, now: float) -> None:  # noqa: D102 - protocol
        pass

    def observe_batch_size(self, bs: float) -> None:
        pass

    def score(self, node: Node, now: float) -> float:
        return node.last_access
