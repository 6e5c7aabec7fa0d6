"""chip_smoke.py phase 11's tensor- and expert-parallel parts alone, on one
card: builds the kernels, holds fused_sgmv and flash_prefill (forward and
backward) at every ``TP_SHAPES`` local shape against their plain versions
(``tp_kernel_cases``), then runs ``FAMILY_RUNS`` (deepseek-v2-lite-16b,
rwkv6-1.6b, recurrentgemma-2b, seamless-m4t-large-v2 at full width in f32)
unsharded and on a (1, 2) mesh of two gloo ranks on the card
(``family_runs``), then the sharded prefill and decode steps of
``SERVE_RUNS`` on the same mesh (``serve_runs``), with chip_smoke's
checks. ``--serving`` runs phase 3's ``lse_kernel_cases`` and
``serve_runs`` only. Prints the card's name and power limit, then one JSON
line (also written to the path after ``--out``, where given).

    python3 scripts/dist_families.py [--serving] [--out PATH]
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
    out = {"nvidia_smi": smi, "build_s": build_s}
    if "--serving" in sys.argv[1:]:
        out["lse_kernel_cases"] = chip_smoke.lse_kernel_cases(
            ops, ref, torch.Generator(device=dev).manual_seed(12), dev)
    else:
        out["tp_kernel_cases"] = chip_smoke.tp_kernel_cases(
            ops, ref, configs, torch.Generator(device=dev).manual_seed(11), dev)
        out["families"], out["launches"] = chip_smoke.family_runs(configs, dev)
    t2 = time.perf_counter()
    out["serving"], out["serve_launches"] = chip_smoke.serve_runs(configs, dev)
    t3 = time.perf_counter()
    out["seconds"] = {"build": t1 - t0, "kernels_or_families": t2 - t1, "serving": t3 - t2}
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    if "--out" in sys.argv[1:]:
        path = Path(sys.argv[sys.argv.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out))


if __name__ == "__main__":
    main()
