"""Time the decode kernels on the card with a cold L2, kernel by kernel.

    python3 scripts/decode_kernels.py [--iters 40] [--dtype f32|bf16]

f32 (the default): the skinny ``fused_sgmv`` at the four projections of a
qwen3-0.6b decode step (B=8, S=1, r=32, ids as in ``chip_smoke.py``) and
``paged_attention`` at ``chip_smoke.py``'s two length sets (B=8, a
2048-token table of 128-token pages, 16/8 heads of 128). bf16: ``fused_sgmv``
at every decode projection of phase 9 (``DECODE_BF16``: qwen3-0.6b's q, k,
o at B=8; llama-7b's q, deepseek-v2-lite-16b's q and kv_a, rwkv6-1.6b's r,
recurrentgemma-2b's q and k, seamless-m4t's decoder q at B=2) and at more
rows (``DECODE_BF16_ROWS``: the rows between those, on both sides of the
rule's limits), each on ``csrc/fused_sgmv_cluster.cu``'s loop and
``csrc/fused_sgmv.cu``'s bf16 skinny loop, both through their C entries
whatever the rule says, in turns (cluster, skinny, skinny, cluster), with
the loop ``sgmv.bf16_path`` gives the shape (``path``). Inputs that a
decode step finds in device memory (W, A, B; the KV) rotate over copies
that exceed twice the L2, as
in ``chip_smoke.time_ms``. Each case prints one JSON line: CUDA-event ms
per call behind a spin kernel, and from ``torch.profiler`` over the same
calls the device ms per call of each kernel, the kernels a call launches
and the span from the first kernel's start to the last one's end. For
``fused_sgmv`` also the time of one library GEMM ``x @ W`` on the same
rotated W: the base product alone, a yardstick of how fast a single kernel
streams W. Needs a CUDA device; the card's name and power limit come
first.
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


# (config, projection, B, d_in, d_out) of phase 9's bf16 decode steps, and q
# at 16 rows
DECODE_BF16 = (("qwen3-0.6b", "q", 8, 1024, 2048), ("qwen3-0.6b", "k", 8, 1024, 1024),
               ("qwen3-0.6b", "o", 8, 2048, 1024), ("qwen3-0.6b", "q", 16, 1024, 2048),
               ("llama-7b", "q", 2, 4096, 4096), ("deepseek-v2-lite-16b", "q", 2, 2048, 3072),
               ("deepseek-v2-lite-16b", "kv_a", 2, 2048, 576), ("rwkv6-1.6b", "r", 2, 2048, 2048),
               ("recurrentgemma-2b", "q", 2, 2560, 2560), ("recurrentgemma-2b", "k", 2, 2560, 256),
               ("seamless-m4t-large-v2", "q", 2, 1024, 1024))


# ... and the rows around the rule's limits: W of 2^24 (llama-7b q) and of
# 2^22 (rwkv6-1.6b r) at 4, 8 and 16 rows, W of 2^21 (qwen3-0.6b q, o) at
# 9 and 12 rows (and o at 16)
DECODE_BF16_ROWS = tuple(
    [("llama-7b", "q", B, 4096, 4096) for B in (4, 8, 16)]
    + [("rwkv6-1.6b", "r", B, 2048, 2048) for B in (4, 8, 16)]
    + [("qwen3-0.6b", "q", B, 1024, 2048) for B in (9, 12)]
    + [("qwen3-0.6b", "o", B, 2048, 1024) for B in (9, 12, 16)])


def bf16_cases(cs, iters: int) -> None:
    """bf16 fused_sgmv at each DECODE_BF16 and DECODE_BF16_ROWS shape, cold:
    the cluster loop and fused_sgmv.cu's skinny loop through their C
    entries, in turns (cluster, skinny, skinny, cluster)."""
    import importlib

    from repro_torch.kernels import build, ref

    sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")
    lib = build.load(sgmv_mod._SOURCE, sgmv_mod._SIGNATURES)
    clib = build.load(sgmv_mod._CLUSTER_SOURCE, sgmv_mod._CLUSTER_SIGNATURES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, N, r = torch.bfloat16, 8, 32
    sms = build.sm_count(dev)
    for arch, proj, B, d_in, d_out in DECODE_BF16 + DECODE_BF16_ROWS:
        ids = torch.tensor(([-1, 0, 1, 2, 3, 4, 5, 7] * 2)[:B], dtype=torch.int32, device=dev)
        x = torch.randn((B, 1, d_in), generator=gen, device=dev).to(bf16)
        w = (torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5).to(bf16)
        a = (torch.randn((N, d_in, r), generator=gen, device=dev) * d_in ** -0.5).to(bf16)
        b = (torch.randn((N, r, d_out), generator=gen, device=dev) * 0.1).to(bf16)
        live = int(torch.unique(ids[ids >= 0]).numel())
        n = cs.cold_copies(2 * (d_in * d_out + live * r * (d_in + d_out)))
        copies = [(w.clone(), a.clone(), b.clone()) for _ in range(n)]
        scratch = torch.empty((lib.fused_sgmv_scratch_floats(B, d_in, d_out, r, 1),), device=dev)
        y = torch.empty((B, 1, d_out), device=dev, dtype=bf16)
        yc = torch.empty((B, 1, d_out), device=dev, dtype=bf16)
        stream = torch.cuda.current_stream(dev).cuda_stream
        h = sgmv_mod.cluster_h(dev, stream, B, r)

        def skinny(c):
            code = lib.fused_sgmv_bf16_launch(
                x.data_ptr(), c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(),
                ids.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, 1, d_in, d_out, r, 1.0,
                stream)
            assert code == 0, code

        def cluster(c):
            code = clib.fused_sgmv_cluster_launch(
                x.data_ptr(), c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(),
                ids.data_ptr(), yc.data_ptr(), h.data_ptr(), h.numel(), B, 1, d_in, d_out, r,
                sms, 1.0, stream)
            assert code == 0, code

        new = cs.rotating([lambda c=c: cluster(c) for c in copies])
        old = cs.rotating([lambda c=c: skinny(c) for c in copies])
        want32 = ref.fused_sgmv_ref(*cs.up(x, w, a, b), ids, 1.0)
        for got in ((cluster((w, a, b)), yc)[1], (skinny((w, a, b)), y)[1]):
            cs.check_out(f"{arch} {proj} B={B}", got, ref.fused_sgmv_ref(x, w, a, b, ids, 1.0),
                         want32, bf16, cs.SGMV_TOL * float(want32.abs().max()))
        turns = [cs.time_ms(f, iters=iters)[0] for f in (new, old, old, new)]
        x2 = x.view(B, d_in)
        base = cs.rotating([lambda c=c: x2 @ c[0] for c in copies])
        cs.emit({"kernel": "fused_sgmv", "dtype": "bf16", "arch": arch,
                 "case": f"{proj} {d_in}->{d_out}, B={B}, S=1",
                 "path": sgmv_mod.bf16_path(B, d_in, d_out, (x.data_ptr(), w.data_ptr(),
                                                             a.data_ptr(), b.data_ptr()), bf16),
                 "cluster_cold_ms": (turns[0] + turns[3]) / 2,
                 "skinny_cold_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                 "cluster": per_kernel(new, iters), "skinny": per_kernel(old, iters),
                 "x_at_w_cold_ms": cs.time_ms(base, iters=iters)[0]})
        del copies


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
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
    if args.dtype == "bf16":
        bf16_cases(cs, args.iters)
        return
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
