"""chip_smoke.py phase 11's tensor- and expert-parallel parts alone, on one
card: builds the kernels, holds fused_sgmv and flash_prefill (forward and
backward) at every ``TP_SHAPES`` local shape against their plain versions
(``tp_kernel_cases``), then runs ``FAMILY_RUNS`` (deepseek-v2-lite-16b,
rwkv6-1.6b, recurrentgemma-2b, seamless-m4t-large-v2 at full width in f32)
unsharded and on a (1, 2) mesh of two gloo ranks on the card
(``family_runs``), with chip_smoke's checks. Prints the card's name and
power limit, then one JSON line.

    python3 scripts/dist_families.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dist_families: no CUDA device")
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's main() sets it
    t0 = time.perf_counter()
    build_s = build.build_all()
    dev = torch.device("cuda", 0)
    t1 = time.perf_counter()
    cases = chip_smoke.tp_kernel_cases(ops, ref, configs,
                                       torch.Generator(device=dev).manual_seed(11), dev)
    t2 = time.perf_counter()
    lines, launches = chip_smoke.family_runs(configs, dev)
    t3 = time.perf_counter()
    print(smi, flush=True)
    print(json.dumps({"nvidia_smi": smi, "build_s": build_s, "tp_kernel_cases": cases,
                      "families": lines, "launches": launches,
                      "seconds": {"build": t1 - t0, "tp_kernel_cases": t2 - t1,
                                  "families": t3 - t2}}), flush=True)


if __name__ == "__main__":
    main()
