"""Time the decode kernels on the card with a cold L2, kernel by kernel.

    python3 scripts/decode_kernels.py [--iters 40]

Cases: the skinny ``fused_sgmv`` at the four projections of a qwen3-0.6b
decode step (B=8, S=1, r=32, ids as in ``chip_smoke.py``) and
``paged_attention`` at ``chip_smoke.py``'s two length sets (B=8, a
2048-token table of 128-token pages, 16/8 heads of 128). Inputs that a
decode step finds in device memory (W, A, B; the KV) rotate over copies
that exceed twice the L2, as in ``chip_smoke.time_ms``. Each case prints
one JSON line: CUDA-event ms per call behind a spin kernel, and from
``torch.profiler`` over the same calls the device ms per call of each
kernel and the span from the first kernel's start to the last one's end.
For ``fused_sgmv`` also the time of one library GEMM ``x @ W`` on the
same rotated W: the base product alone, a yardstick of how fast a single
kernel streams W. Needs a CUDA device; the card's name and power limit
come first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def per_kernel(fn, calls: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, and of the span
    of each call's kernels (calls do not overlap: one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the stream is held while the host enqueues, as in chip_smoke.time_ms,
        # so the spans are the device's and not the host's launch gaps
        torch.cuda._sleep(int(2e6 * max(20.0, 0.2 * calls)))
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not e.name.startswith("at::cuda")),  # the spin kernel
                    key=lambda e: e.time_range.start)
    by_name = {}
    for e in events:
        name = e.name.removeprefix("void ").removeprefix("(anonymous namespace)::")
        name = name.split("(")[0]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
    per_call = len(events) // calls
    spans = [events[i + per_call - 1].time_range.end - events[i].time_range.start
             for i in range(0, per_call * calls, per_call)]
    return {"kernel_ms": {k: v / 1e3 / calls for k, v in by_name.items()},
            "span_ms": sum(spans) / 1e3 / calls, "kernels_per_call": per_call}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_kernels: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, r = 8, 8, 32
    ids = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 7], dtype=torch.int32, device=dev)
    for proj, d_in, d_out in (("q", 1024, 2048), ("k", 1024, 1024), ("v", 1024, 1024),
                              ("o", 2048, 1024)):
        x = torch.randn((B, 1, d_in), generator=gen, device=dev)
        w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
        a = torch.randn((N, d_in, r), generator=gen, device=dev) * d_in ** -0.5
        b = torch.randn((N, r, d_out), generator=gen, device=dev) * 0.1
        n = cs.cold_copies(4 * (d_in * d_out + 7 * r * (d_in + d_out)))
        copies = [(w.clone(), a.clone(), b.clone()) for _ in range(n)]
        fn = cs.rotating([lambda c=c: ops.fused_sgmv(x, *c, ids) for c in copies])
        ms, host_ms = cs.time_ms(fn, iters=args.iters)
        # what one library GEMM takes to stream the same W, cold: a yardstick
        # for the base product alone (not the same function)
        x2 = x.view(B, d_in)
        base = cs.rotating([lambda c=c: x2 @ c[0] for c in copies])
        cs.emit({"kernel": "fused_sgmv", "case": f"{proj} {d_in}->{d_out}, B=8, S=1",
                 "cold_ms": ms, "host_ms": host_ms, **per_kernel(fn, args.iters),
                 "x_at_w_cold_ms": cs.time_ms(base, iters=args.iters)[0]})
        del copies
    T, H, Hkv, D, ps = 2048, 16, 8, 128, 128
    pages = T // ps
    tables = torch.arange(B * pages, dtype=torch.int32, device=dev).view(B, pages)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    for key, lens in cs.PAGED_LENGTHS.items():
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(min(n, T) for n in lens)
        copies = [tuple(torch.randn((B * pages, ps, Hkv, D), generator=gen, device=dev)
                        for _ in range(2)) for _ in range(cs.cold_copies(8 * live * Hkv * D))]
        fn = cs.rotating([lambda c=c: ops.paged_attention(q, *c, tables, ln)
                          for c in copies])
        ms, host_ms = cs.time_ms(fn, iters=args.iters)
        cs.emit({"kernel": "paged_attention", "case": f"{key} lengths {lens}",
                 "cold_ms": ms, "host_ms": host_ms, **per_kernel(fn, args.iters)})
        del copies


if __name__ == "__main__":
    main()
