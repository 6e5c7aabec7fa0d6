"""Split the port's host-link calls into host and device time, on the card.

    python3 scripts/link_probe.py [--iters 10]

``PagedKVPool.swap_out`` and ``swap_in`` of 1, 2, 4, .., 64 of the
engine's KV blocks (qwen3-0.6b at full width, f32, blocks of 16 tokens, as
``chip_smoke.py``'s ``link`` phase), each timed with ``chip_smoke.event_ms``
(device ms between CUDA events, the host's ms until the call returns and
until its work ends; medians of ``--iters`` round trips on fresh data,
each checked bit for bit), then one ``swap_in`` of 1 and of 8 blocks under
``torch.profiler``: the host's time in each ``aten::copy_`` and the
device's time in each host-to-device copy. Prints one JSON line per
size and one per profile, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kvcache import PagedKVPool  # noqa: E402
from repro_torch.serving.engine import kv_pool_spec  # noqa: E402

SIZES = (1, 2, 4, 8, 16, 32, 64)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("link_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    spec = kv_pool_spec(configs.get("qwen3-0.6b"), 16)
    n = max(SIZES)
    pool = PagedKVPool(spec, 2 * n, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    for nb in SIZES:
        blocks, back = list(range(nb)), list(range(n, n + nb))
        rows = {"swap_out": [], "swap_in": []}
        for _ in range(args.iters):
            for t in (pool.k_hbm, pool.v_hbm):
                t[:nb].normal_(generator=gen)
                t[n:n + nb].zero_()
            rows["swap_out"].append(cs.event_ms(lambda: pool.swap_out(blocks, blocks)))
            rows["swap_in"].append(cs.event_ms(lambda: pool.swap_in(blocks, back)))
            cs.require(all(torch.equal(t[n:n + nb], t[:nb]) for t in (pool.k_hbm, pool.v_hbm)),
                       f"link_probe: {nb} blocks differ after the round trip")
        line = {"blocks": nb, "bytes": nb * spec.block_bytes}
        for name, times in rows.items():
            line[name] = {k: statistics.median(t[i] for t in times)
                          for i, k in enumerate(("ms", "enqueue_ms", "wall_ms"))}
            line[name]["ms_all"] = [t[0] for t in times]
        print(json.dumps(line), flush=True)
    for nb in (1, 8):
        blocks, back = list(range(nb)), list(range(n, n + nb))
        pool.swap_out(blocks, blocks)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pool.swap_in(blocks, back)
            torch.cuda.synchronize()
        events = [{"name": e.key, "count": e.count,
                   "cpu_us": e.cpu_time_total, "device_us": e.device_time_total}
                  for e in prof.key_averages()
                  if e.cpu_time_total > 0 or e.device_time_total > 0]
        print(json.dumps({"profile_swap_in_blocks": nb, "events": events}), flush=True)


if __name__ == "__main__":
    main()
