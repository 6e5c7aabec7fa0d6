"""Summarize a dumped libra-trace file.

Usage::

    python -m repro_torch.obs.report trace.json [--top N]

Reads Chrome trace-event JSON produced by ``Tracer.dump`` (or any
conforming file) and prints:

* span histograms — per span name: count, total/mean/p50/p99 duration;
* the cache audit summary — event counts per decision kind and the top-N
  evicted/demoted nodes by total bytes moved, with their last cost-model
  score;
* the TTFT attribution table — per finished request, the additive
  queue/lora_load/swap_in/recompute/compute/stall/other breakdown and its
  reconciliation against measured TTFT;
* estimate_ttft calibration — MAE and signed bias of predicted vs actual.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List

from .tracer import (
    ATTRIB_CATEGORIES,
    EV_CACHE_DROP,
    EV_CACHE_EVICT,
    EV_CACHE_SWAP_OUT,
    EV_CALIBRATION,
    EV_TTFT_ATTRIBUTION,
)

_EVICT_EVENTS = (EV_CACHE_EVICT, EV_CACHE_SWAP_OUT, EV_CACHE_DROP)


def _p(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def load(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents list)")
    return events


def span_histograms(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per-name duration stats over all complete ("X") events, in ms."""
    by_name: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_name.setdefault(ev["name"], []).append(ev.get("dur", 0.0) / 1e3)
    return {
        name: {
            "count": float(len(durs)),
            "total_ms": sum(durs),
            "mean_ms": sum(durs) / len(durs),
            "p50_ms": _p(durs, 0.5),
            "p99_ms": _p(durs, 0.99),
        }
        for name, durs in sorted(by_name.items())
    }


def audit_summary(events: List[Dict[str, Any]], top: int = 10) -> Dict[str, Any]:
    """Counts per audit event + top evicted nodes by total bytes moved."""
    counts: Dict[str, int] = {}
    nodes: Dict[Any, Dict[str, Any]] = {}
    for ev in events:
        name = ev.get("name", "")
        if not name.startswith("cache."):
            continue
        counts[name] = counts.get(name, 0) + 1
        args = ev.get("args") or {}
        if name in _EVICT_EVENTS and "node_id" in args:
            rec = nodes.setdefault(
                args["node_id"],
                {"node_id": args["node_id"], "kind": args.get("kind"), "evictions": 0, "bytes": 0, "last_score": None},
            )
            rec["evictions"] += 1
            rec["bytes"] += int(args.get("bytes", 0))
            if "score" in args:
                rec["last_score"] = args["score"]
            rec["kind"] = args.get("kind", rec["kind"])
    ranked = sorted(nodes.values(), key=lambda r: (-r["bytes"], r["node_id"]))
    return {"counts": counts, "top_evicted": ranked[:top]}


def attribution_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One row per finished request: breakdown + TTFT reconciliation."""
    rows = []
    for ev in events:
        if ev.get("name") != EV_TTFT_ATTRIBUTION:
            continue
        args = ev.get("args") or {}
        row = {"rid": args.get("rid")}
        total = 0.0
        for cat in ATTRIB_CATEGORIES:
            v = float(args.get(cat, 0.0))
            row[cat] = v
            total += v
        row["sum"] = total
        row["ttft"] = float(args.get("ttft", 0.0))
        row["resid"] = row["ttft"] - total
        rows.append(row)
    return rows


def calibration(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """MAE/bias of estimate_ttft's predictions against measured TTFT."""
    errs = []
    for ev in events:
        if ev.get("name") != EV_CALIBRATION:
            continue
        args = ev.get("args") or {}
        if "predicted" in args and "actual" in args:
            errs.append(float(args["predicted"]) - float(args["actual"]))
    if not errs:
        return {"n": 0, "mae_s": 0.0, "bias_s": 0.0}
    return {
        "n": len(errs),
        "mae_s": sum(abs(e) for e in errs) / len(errs),
        "bias_s": sum(errs) / len(errs),
    }


def render(path: str, top: int = 10) -> str:
    events = load(path)
    lines = [f"libra-trace report: {path} ({len(events)} events)", ""]

    lines.append("== span histograms (ms) ==")
    hists = span_histograms(events)
    if hists:
        lines.append(f"{'span':24s} {'count':>7s} {'mean':>9s} {'p50':>9s} {'p99':>9s} {'total':>10s}")
        for name, h in hists.items():
            lines.append(
                f"{name:24s} {int(h['count']):7d} {h['mean_ms']:9.3f} "
                f"{h['p50_ms']:9.3f} {h['p99_ms']:9.3f} {h['total_ms']:10.2f}"
            )
    else:
        lines.append("(no spans)")

    lines.append("")
    lines.append("== cache audit ==")
    audit = audit_summary(events, top=top)
    for name, n in sorted(audit["counts"].items()):
        lines.append(f"{name:24s} {n:7d}")
    if audit["top_evicted"]:
        lines.append(f"top {len(audit['top_evicted'])} evicted nodes (by bytes moved):")
        lines.append(f"{'node':>8s} {'kind':14s} {'evictions':>9s} {'bytes':>12s} {'last_score':>12s}")
        for rec in audit["top_evicted"]:
            score = "-" if rec["last_score"] is None else f"{rec['last_score']:.4g}"
            lines.append(
                f"{rec['node_id']!s:>8s} {str(rec['kind']):14s} "
                f"{rec['evictions']:9d} {rec['bytes']:12d} {score:>12s}"
            )
    else:
        lines.append("(no evictions recorded)")

    lines.append("")
    lines.append("== TTFT attribution (ms) ==")
    rows = attribution_rows(events)
    if rows:
        hdr = f"{'rid':>6s} " + " ".join(f"{c:>9s}" for c in ATTRIB_CATEGORIES)
        lines.append(hdr + f" {'sum':>9s} {'ttft':>9s} {'resid':>9s}")
        for row in rows:
            cells = " ".join(f"{row[c] * 1e3:9.3f}" for c in ATTRIB_CATEGORIES)
            lines.append(
                f"{row['rid']!s:>6s} {cells} {row['sum'] * 1e3:9.3f} "
                f"{row['ttft'] * 1e3:9.3f} {row['resid'] * 1e3:9.3f}"
            )
        n = len(rows)
        means = " ".join(f"{sum(r[c] for r in rows) / n * 1e3:9.3f}" for c in ATTRIB_CATEGORIES)
        lines.append(f"{'mean':>6s} {means}")
    else:
        lines.append("(no finished requests with attribution)")

    lines.append("")
    lines.append("== estimate_ttft calibration ==")
    cal = calibration(events)
    lines.append(f"n={cal['n']} mae={cal['mae_s'] * 1e3:.3f}ms bias={cal['bias_s'] * 1e3:+.3f}ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a libra-trace Chrome trace-event JSON file.",
    )
    ap.add_argument("trace", help="path to a trace dumped via --trace-out / Tracer.dump")
    ap.add_argument("--top", type=int, default=10, help="rows in the top-evicted table")
    args = ap.parse_args(argv)
    try:
        print(render(args.trace, top=args.top))
    except BrokenPipeError:  # e.g. piped into head
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
