"""chip_smoke.py's bf16 parts for RWKV-6, the RG-LRU hybrid and
seamless-m4t alone, on one card: builds the kernels, runs phase 3
(``kernel_phase``: every kernel against its plain version, with the new
family shapes among the bf16 cases, and each part's seconds) unless
``--no-kernels``, then phase 9's runs of rwkv6-1.6b, recurrentgemma-2b and
seamless-m4t-large-v2 at full width and depth in bf16 beside f32
(``bf16_phase``, with chip_smoke's checks). A run whose check fails is
recorded with its message and the next one runs. Prints the card's name
and power limit, then one JSON line (also written to the path after
``--out``, where given); exits 1 if any check failed.

    python3 scripts/bf16_families.py [--no-kernels] [--out PATH]
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

FAMILIES = ("rwkv6-1.6b", "recurrentgemma-2b", chip_smoke.ENCDEC_ARCH)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bf16_families: no CUDA device")
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    # as chip_smoke's main() sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {"nvidia_smi": smi, "nvcc_seconds": build.build_all(), "failed": {}}
    seconds = {"build": time.perf_counter() - t0}
    if "--no-kernels" not in sys.argv[1:]:
        t0 = time.perf_counter()
        out["kernels"] = chip_smoke.kernel_phase(ops, ref, dev)
        seconds["kernels"] = time.perf_counter() - t0
    out["bf16"] = {}
    for name, B, S, chunk_len, steps, with_f32 in chip_smoke.BF16_ARCHS:
        if name not in FAMILIES:
            continue
        t0 = time.perf_counter()
        try:
            out["bf16"][name] = chip_smoke.bf16_phase(ops, configs, dev, name, B, S,
                                                      chunk_len, steps, with_f32)[0]
        except SystemExit as e:
            out["failed"][name] = str(e)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    print(smi, flush=True)
    print(json.dumps({"seconds": seconds, "failed": out["failed"]}), flush=True)
    if "--out" in sys.argv[1:]:
        path = Path(sys.argv[sys.argv.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out))
    if out["failed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
