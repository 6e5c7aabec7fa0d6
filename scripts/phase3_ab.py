"""Time chip_smoke.py's qwen3-0.6b kernel cases of two checkouts in turns.

    python3 scripts/phase3_ab.py A_DIR B_DIR [--rounds 1]

on one NVIDIA GPU. A_DIR and B_DIR are checkouts of the repository (the
parent commit and the change, say). Both build their kernels first, in
parallel, each into its own ``build/``. Then the turns run A, B, B, A (per
round), each in its own process, which imports that checkout's
``chip_smoke.py`` and ``src/repro_torch`` and runs phase 3's qwen3-0.6b
cases as ``chip_smoke.main`` runs them: fused_sgmv at S = 256, 1, 2016 and
64 over the q, k, v and o projections, ragged_extend at the 256-, 64- and
8-token buckets, paged_attention at the 2048-token table and the engine's
decode lengths, sgmv on q and o at S = 2016 and 1, flash_prefill and
flash_prefill_ragged. Each case's checks run as in chip_smoke (a failed
one ends the turn with an error). Prints one JSON line per turn
({"turn", "dir", "ms": {case: ms}, "cold_ms": {case: ms}}) and then one
summary line: per case, the mean of each checkout's turns and B / A; over
the cases, the largest and median |B / A - 1| and each checkout's largest
spread between its own turns (max / min - 1), warm and cold.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def turn(root: Path) -> dict:
    """Phase 3's qwen3-0.6b cases of the checkout at ``root``: {label: case}."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    projections = (("q", 1024, 2048), ("k", 1024, 1024), ("v", 1024, 1024),
                   ("o", 2048, 1024))
    cases = {}
    for S in (256, 1, 2016, 64):
        for p, di, do in projections:
            cases[f"fused_sgmv {p} S={S}"] = cs.sgmv_case(ops, ref, p, di, do, S, gen, dev)
    for S in (256, 64, 8):
        cases[f"ragged_extend S={S}"] = cs.ragged_case(ops, ref, gen, dev, S,
                                                       *cs.RAGGED_BUCKETS[S])
    for k in ("table", "engine"):
        cases[f"paged_attention {k}"] = cs.paged_case(ops, ref, gen, dev,
                                                      cs.PAGED_LENGTHS[k])
    torch.cuda.empty_cache()
    for S in (2016, 1):
        for p, di, do in (projections[0], projections[3]):
            cases[f"sgmv {p} S={S}"] = cs.sgmv_case(ops, ref, p, di, do, S, gen, dev,
                                                    base=False)
    torch.cuda.empty_cache()
    cases["flash_prefill"] = cs.flash_case(ops, ref, gen, dev)
    torch.cuda.empty_cache()
    cases["flash_prefill_ragged"] = cs.flash_case(
        ops, ref, gen, dev, lens=[0, 1, 37, 1000, 2015, 2016, 2016, 2016])
    return cases


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--run", help="(internal) run one turn in this checkout")
    args = ap.parse_args()
    if args.run:
        cases = turn(Path(args.run).resolve())
        print(json.dumps({"ms": {k: c["ms"] for k, c in cases.items()},
                          "cold_ms": {k: c["cold"]["ms"] for k, c in cases.items()
                                      if "cold" in c}}), flush=True)
        return
    dirs = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; print(build.build_all())",
         str(d / "src")]) for d in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("phase3_ab: a kernel build failed")
    times = {"A": [], "B": []}
    for i, who in enumerate("ABBA" * args.rounds):
        out = subprocess.run([sys.executable, __file__, "--run", str(dirs[who])],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"phase3_ab: turn {i} ({who}) failed:\n{out.stderr[-3000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        times[who].append(res)
        print(json.dumps({"turn": i, "who": who, "dir": str(dirs[who]), **res}), flush=True)
    summary = {}
    for kind in ("ms", "cold_ms"):
        ratios = {}
        for case in times["A"][0][kind]:
            a = statistics.mean(t[kind][case] for t in times["A"])
            b = statistics.mean(t[kind][case] for t in times["B"])
            ratios[case] = {"a": a, "b": b, "b_over_a": b / a}
        dev = [abs(r["b_over_a"] - 1) for r in ratios.values()]
        summary[kind] = {"cases": ratios, "max_abs_change": max(dev),
                         "median_abs_change": statistics.median(dev)}
        for who in "AB":  # the spread of one checkout's own turns
            runs = times[who]
            summary[kind][f"{who}_max_spread"] = max(
                (max(t[kind][c] for t in runs) / min(t[kind][c] for t in runs) - 1
                 for c in runs[0][kind]), default=0.0)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
