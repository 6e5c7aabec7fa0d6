"""Synthetic workload generation matching the paper's three scenarios.

The original datasets (LMSYS-33k, OPUS-100, Taskmaster) and the Microsoft
Azure Function trace are not redistributable offline; this module generates
statistically-matched synthetic traces with the same knobs the paper uses:

* **chatbot**     — multi-turn conversations, LoRA per conversation sampled
  from a Zipf popularity (LMSYS model-popularity-like), medium turns.
* **translation** — single-turn queries, many LoRAs (language pairs), and a
  *time-varying* hot set (the paper observes 41 → 75 active LoRAs mid-trace,
  which is what breaks static HBM partitions).
* **agent**       — fewest LoRAs, the longest conversations (Taskmaster-like),
  stressing history-KV reuse (where S-LoRA collapses).

Arrival timing follows an Azure-Function-like bursty process: per-interval
rates drawn from a lognormal modulation of the base rate (MAFT burstiness),
Poisson arrivals within an interval.

Large-LoRA-count distributions for the paper's §6.9: uniform / distinct
(round-robin) / skewed-σ (Gaussian over adapter index).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, Optional


@dataclasses.dataclass
class SimQuery:
    arrival: float
    conversation_id: int
    lora_id: str
    history: tuple[int, ...]  # tokens reusable from previous turns
    new_tokens: tuple[int, ...]  # this turn's fresh prompt tokens
    output_tokens: tuple[int, ...]  # the (deterministic) generated reply
    # leading prompt tokens that are adapter-INDEPENDENT (a product-wide
    # system prompt shared by every adapter): computed with the adapter
    # inactive, cacheable once on the shared trunk. 0 = legacy traces.
    shared_prefix_len: int = 0
    # SLO tier: higher = more latency-sensitive (0 = batch). Admission is
    # priority-strict; only strictly-lower tiers are preemptable.
    priority: int = 0
    # absolute first-token deadline on the trace clock (None = no SLO)
    deadline: Optional[float] = None

    @property
    def prompt(self) -> tuple[int, ...]:
        return self.history + self.new_tokens

    @property
    def output_len(self) -> int:
        return len(self.output_tokens)

    @property
    def full(self) -> tuple[int, ...]:
        return self.history + self.new_tokens + self.output_tokens


@dataclasses.dataclass
class TraceConfig:
    scenario: str = "chatbot"  # chatbot | translation | agent
    n_loras: int = 50
    duration: float = 600.0
    mean_qps: float = 2.0
    seed: int = 0
    burstiness: float = 0.6  # lognormal sigma of the per-interval rate
    interval: float = 30.0  # rate-modulation interval (s)
    distribution: str = "zipf"  # zipf | uniform | distinct | skewed
    skew_sigma: float = 100.0  # for skewed-x
    # cross-adapter shared system prompt: every conversation's prompt opens
    # with this many adapter-independent tokens (one product-wide system
    # prompt common to ALL adapters), and each query carries the matching
    # shared_prefix_len. 0 (default) keeps traces byte-identical to before.
    shared_system_prompt_len: int = 0
    # mixed-SLO tiering: this fraction of conversations is interactive
    # (priority 1) with a first-token deadline of arrival +
    # interactive_ttft_slo; the rest stay batch tier (priority 0, no
    # deadline). 0.0 (default) keeps traces byte-identical to before.
    interactive_fraction: float = 0.0
    interactive_ttft_slo: float = 1.0


_SCENARIOS = {
    #              turns      user_toks   out_toks  gap(s)  template
    "chatbot": dict(turns=(1, 8), user=(30, 220), out=(40, 260), gap=20.0,
                    template=16),
    "translation": dict(turns=(1, 1), user=(20, 120), out=(20, 140), gap=0.0,
                        template=48),
    "agent": dict(turns=(4, 16), user=(20, 120), out=(30, 160), gap=12.0,
                  template=24),
}


def _conv_tokens(conv_id: int, start: int, n: int) -> tuple[int, ...]:
    """Unique-but-deterministic token ids for conversation content."""
    base = (conv_id + 1) * 1_000_000
    return tuple(base + start + i for i in range(n))


def _template_tokens(lora_idx: int, n: int) -> tuple[int, ...]:
    """Per-LoRA shared system/template prefix (e.g. the translation
    instruction) — reused across all queries of that adapter, which is what
    cross-query prefix caching exploits in single-turn scenarios."""
    base = -(lora_idx + 1) * 10_000  # negative range: never collides with convs
    return tuple(base - i for i in range(n))


def _shared_system_tokens(n: int) -> tuple[int, ...]:
    """The product-wide system prompt common to ALL adapters — one token
    range far below every per-LoRA template and conversation range."""
    base = -(10**9)
    return tuple(base - i for i in range(n))


class _LoraSampler:
    def __init__(self, cfg: TraceConfig, rng: random.Random):
        self.cfg = cfg
        self.rng = rng
        self._rr = 0
        if cfg.distribution == "zipf":
            w = [1.0 / (i + 1) ** 0.9 for i in range(cfg.n_loras)]
            tot = sum(w)
            self.weights = [x / tot for x in w]
        elif cfg.distribution == "skewed":
            mid = cfg.n_loras / 2
            w = [math.exp(-((i - mid) ** 2) / (2 * cfg.skew_sigma**2))
                 for i in range(cfg.n_loras)]
            tot = sum(w)
            self.weights = [x / tot for x in w]
        else:
            self.weights = None

    def sample(self, t: float) -> int:
        cfg = self.cfg
        if cfg.distribution == "distinct":
            self._rr = (self._rr + 1) % cfg.n_loras
            return self._rr
        if cfg.distribution == "uniform":
            return self.rng.randrange(cfg.n_loras)
        idx = self.rng.choices(range(cfg.n_loras), weights=self.weights)[0]
        if cfg.scenario == "translation":
            # time-varying hot set: rotate the popularity ranking so the
            # active-LoRA working set drifts (the paper's 41→75 effect)
            shift = int(t / max(1.0, cfg.duration) * cfg.n_loras * 0.5)
            idx = (idx + shift) % cfg.n_loras
        return idx


def generate_trace(cfg: TraceConfig) -> list[SimQuery]:
    rng = random.Random(cfg.seed)
    sc = _SCENARIOS[cfg.scenario]
    sampler = _LoraSampler(cfg, rng)
    queries: list[SimQuery] = []
    conv_counter = 0
    t = 0.0
    while t < cfg.duration:
        # Azure-like bursty rate for this interval
        rate = cfg.mean_qps * math.exp(
            rng.gauss(-cfg.burstiness**2 / 2, cfg.burstiness)
        )
        end = min(cfg.duration, t + cfg.interval)
        # Poisson arrivals in [t, end)
        tt = t
        while True:
            tt += rng.expovariate(max(rate, 1e-6))
            if tt >= end:
                break
            conv_counter += 1
            conv_id = conv_counter
            lora = sampler.sample(tt)
            # SLO tier per conversation (every turn inherits it): the guard
            # short-circuits so interactive_fraction=0 draws nothing from
            # the rng stream and legacy traces stay byte-identical
            interactive = (cfg.interactive_fraction > 0
                           and rng.random() < cfg.interactive_fraction)
            n_turns = rng.randint(*sc["turns"])
            cursor = 0
            shared = _shared_system_tokens(cfg.shared_system_prompt_len)
            history: tuple[int, ...] = (
                shared + _template_tokens(lora, sc["template"]))
            arr = tt
            for turn in range(n_turns):
                user_n = rng.randint(*sc["user"])
                out_n = rng.randint(*sc["out"])
                new = _conv_tokens(conv_id, cursor, user_n)
                cursor += user_n
                out = _conv_tokens(conv_id, cursor, out_n)
                cursor += out_n
                queries.append(
                    SimQuery(
                        arrival=arr,
                        conversation_id=conv_id,
                        lora_id=f"lora-{lora}",
                        history=history,
                        new_tokens=new,
                        output_tokens=out,
                        shared_prefix_len=len(shared),
                        priority=1 if interactive else 0,
                        deadline=(arr + cfg.interactive_ttft_slo
                                  if interactive else None),
                    )
                )
                history = history + new + out
                arr += rng.expovariate(1.0 / max(sc["gap"], 1e-6)) if sc["gap"] else 0.0
                if arr >= cfg.duration:
                    break
        t = end
    queries.sort(key=lambda q: q.arrival)
    return queries


def trace_stats(queries: list[SimQuery]) -> dict:
    if not queries:
        return {}
    loras = {q.lora_id for q in queries}
    return {
        "n_queries": len(queries),
        "n_loras_used": len(loras),
        "avg_prompt": sum(len(q.prompt) for q in queries) / len(queries),
        "avg_history": sum(len(q.history) for q in queries) / len(queries),
        "avg_output": sum(q.output_len for q in queries) / len(queries),
        "duration": queries[-1].arrival,
    }
