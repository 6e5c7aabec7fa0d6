"""Time chip_smoke.py's phase 3 kernel cases of two checkouts in turns.

    python3 scripts/phase3_ab.py A_DIR B_DIR [--rounds 1]
        [--cases all|forward|backward|flash_bf16|sgmv_bf16|prefill_bf16|attn_bf16]

on one NVIDIA GPU. A_DIR and B_DIR are checkouts of the repository (the
parent commit and the change, say). Both build their kernels first, in
parallel, each into its own ``build/``. Then the turns run A, B, B, A (per
round), each in its own process, which imports that checkout's
``chip_smoke.py`` and ``src/repro_torch`` and runs phase 3's qwen3-0.6b
cases as ``chip_smoke.main`` runs them: fused_sgmv at S = 256, 1, 2016 and
64 over the q, k, v and o projections, ragged_extend at the 256-, 64- and
8-token buckets, paged_attention at the 2048-token table and the engine's
decode lengths, sgmv on q and o at S = 2016 and 1, flash_prefill and
flash_prefill_ragged; then the backward cases of
``chip_smoke.backward_kernel_cases``: flash_prefill_bwd at qwen3-0.6b's
B = 8, S = 512 and at every ``ARCH_HEADS`` shape (B = 2), lora_grad on
q/k/v/o and on q at ranks 1, 12 and 128, flash_prefill_bwd over one row of
4096 tokens (run here where a checkout's ``chip_smoke.py`` lacks it, so
both sides time it); and bf16 flash_prefill at qwen3-0.6b's 8 x 2016,
stablelm-12b's and gemma-2b's 2 x 2048 and flash_prefill_ragged at its
ragged lengths (``chip_smoke.bf16_kernel_cases``' flash cases). ``--cases``
keeps the forward, the backward or the bf16 flash cases only, or takes
``sgmv_bf16``: bf16 fused_sgmv (``chip_smoke.sgmv_case``) on qwen3-0.6b's
q, k, v and o at S = 256, 2016 and 1, q at ranks 1 and 128 (S = 256) and
at phase 9's 8 x 32 extend, llama-7b's q at 2 x 512 and deepseek's q and
kv_a at 2 x 256, bf16 sgmv on q and o at S = 2016 and 1, then the decode
steps (S = 1): q at ranks 1 and 128, phase 9's B = 2 projections
(``DECODE_B2``) and q at B = 16 (where the checkout's ``sgmv_case`` takes
16 rows), each with the loop it took and cuBLAS's bf16 ``x @ W`` (the base
term alone; cold too at S = 1 where the checkout times it) beside it; and
the device time of each CUDA kernel of one fused_sgmv call (q at S = 256,
2016 and 1, ``torch.profiler`` over 10 calls); or ``prefill_bf16``: phase 9's
bf16 ``LM.prefill`` (``chip_smoke.BF16_ARCHS``: qwen3-0.6b 8 x 2016,
llama-7b 2 x 512, deepseek-v2-lite-16b 2 x 256, full width and depth,
random weights, 8 LoRA slots) as :func:`prefill_turn` times it; or
``attn_bf16``: bf16 ragged_extend and paged_attention at every shape of
``chip_smoke.bf16_kernel_cases`` (the 256-token bucket and phase 3's table
and engine lengths at qwen3-0.6b, then llama-7b, qwen2-vl-7b, stablelm-12b
and gemma-2b, and phase 9's extend and first decode step of qwen3-0.6b
and llama-7b), each with the loop it took, warm (and paged_attention cold),
SDPA beside it; then, in the same turn, phase 9's bf16 extend and 8 decode
steps of qwen3-0.6b and llama-7b in device time (:func:`phase9_device_ms`:
``torch.profiler``'s busy ms and the attention kernels' ms). Each case's
checks run as in chip_smoke (a failed one ends the turn with an error). Prints the card's name and power limit
(``nvidia-smi``), then one JSON line per turn ({"turn", "dir", "ms": {case:
ms}, "cold_ms": {case: ms}, "plain_ms", "library_ms"}) and then one
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


# phase 9's decode projections of the configs run at B = 2: (config,
# projection, d_in, d_out)
DECODE_B2 = (("llama-7b", "q", 4096, 4096), ("deepseek-v2-lite-16b", "q", 2048, 3072),
             ("deepseek-v2-lite-16b", "kv_a", 2048, 576), ("rwkv6-1.6b", "r", 2048, 2048),
             ("recurrentgemma-2b", "q", 2560, 2560), ("recurrentgemma-2b", "k", 2560, 256),
             ("seamless-m4t-large-v2", "q", 1024, 1024))


def turn(root: Path, which: str = "all") -> dict:
    """Phase 3's cases of the checkout at ``root`` (``which``: all,
    forward, backward or flash_bf16): {label: case}."""
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
    if which in ("all", "backward"):
        bwd = cs.backward_kernel_cases(ops, ref, gen, dev)
        for c in bwd["flash_prefill_bwd"]:
            cases[f"flash_prefill_bwd {c.get('arch', 'qwen3-0.6b')} {c['case']}"] = c
        for c in bwd["lora_grad"]:
            cases[f"lora_grad {c['case'].split(', ids')[0]}"] = c
        torch.cuda.empty_cache()
        long_case = "flash_prefill_bwd qwen3-0.6b B=1, S=4096, 16/8 heads, D=128"
        if long_case not in cases:  # a chip_smoke.py from before the long case
            cases[long_case] = cs.flash_bwd_case(ops, ref, gen, dev, B=1, S=4096)
            torch.cuda.empty_cache()
    if which == "backward":
        return cases
    if which in ("all", "flash_bf16"):
        bf16 = torch.bfloat16
        cases["flash_prefill bf16"] = cs.flash_case(ops, ref, gen, dev, dtype=bf16)
        torch.cuda.empty_cache()
        cases["flash_prefill_ragged bf16"] = cs.flash_case(
            ops, ref, gen, dev, lens=[0, 1, 37, 1000, 2015, 2016, 2016, 2016], dtype=bf16)
        torch.cuda.empty_cache()
        for arch, B, S, H, Hkv, D in cs.ARCH_FLASH[:2]:  # stablelm-12b, gemma-2b
            cases[f"flash_prefill bf16 {arch}"] = cs.flash_case(
                ops, ref, gen, dev, B=B, S=S, H=H, Hkv=Hkv, D=D, dtype=bf16)
            torch.cuda.empty_cache()
    if which == "flash_bf16":
        return cases
    if which == "attn_bf16":
        bf16 = torch.bfloat16
        cases["ragged_extend bf16 S=256"] = cs.ragged_case(ops, ref, gen, dev, 256,
                                                           *cs.RAGGED_BUCKETS[256], dtype=bf16)
        for k in ("table", "engine"):
            cases[f"paged_attention bf16 {k}"] = cs.paged_case(ops, ref, gen, dev,
                                                               cs.PAGED_LENGTHS[k], dtype=bf16)
        for arch, H, Hkv, D in cs.ARCH_HEADS[:4]:
            cases[f"ragged_extend bf16 {arch}"] = cs.ragged_case(
                ops, ref, gen, dev, 256, *cs.RAGGED_BUCKETS[256], H=H, Hkv=Hkv, D=D, dtype=bf16)
            cases[f"paged_attention bf16 {arch}"] = cs.paged_case(
                ops, ref, gen, dev, cs.PAGED_LENGTHS["engine"], H=H, Hkv=Hkv, D=D, dtype=bf16)
            torch.cuda.empty_cache()
        # phase 9's extend and first decode step of qwen3-0.6b and llama-7b
        # (the shapes of phase9_device_ms, computed here so that a checkout
        # without chip_smoke.phase9_attention_shapes times them too)
        for (name, B, S, chunk_len, steps, _), (H, Hkv) in zip(cs.BF16_ARCHS[:2],
                                                               ((16, 8), (32, 32))):
            T = -(-(S + chunk_len + steps + 8 * (cs.DECODE_WINDOWS + 1)) // 128) * 128
            lens = [chunk_len - (7 * b) % chunk_len for b in range(B)]
            cases[f"ragged_extend bf16 {name} phase 9"] = cs.ragged_case(
                ops, ref, gen, dev, chunk_len, lens, [S] * B, B=B, T=T, H=H, Hkv=Hkv,
                dtype=bf16)
            cases[f"paged_attention bf16 {name} phase 9"] = cs.paged_case(
                ops, ref, gen, dev, [S + n + 1 for n in lens], B=B, T=T, H=H, Hkv=Hkv,
                dtype=bf16)
        cases.update(phase9_device_ms(root))
        return cases
    if which == "sgmv_bf16":
        bf16 = torch.bfloat16
        for S in (256, 2016, 1):
            for p, di, do in projections:
                cases[f"fused_sgmv bf16 {p} S={S}"] = cs.sgmv_case(ops, ref, p, di, do, S, gen,
                                                                   dev, dtype=bf16)
        for r in (1, 128):
            cases[f"fused_sgmv bf16 q S=256 r={r}"] = cs.sgmv_case(
                ops, ref, "q", 1024, 2048, 256, gen, dev, r=r, dtype=bf16)
        for name, proj, B, S, di, do in (
                ("qwen3-0.6b extend", "q", 8, 32, 1024, 2048),
                ("llama-7b", "q", 2, 512, 4096, 4096),
                ("deepseek-v2-lite-16b", "q", 2, 256, 2048, 3072),
                ("deepseek-v2-lite-16b", "kv_a", 2, 256, 2048, 576)):
            cases[f"fused_sgmv bf16 {name} {proj} B={B} S={S}"] = cs.sgmv_case(
                ops, ref, proj, di, do, S, gen, dev, B=B, dtype=bf16)
        torch.cuda.empty_cache()
        for S in (2016, 1):
            for p, di, do in (projections[0], projections[3]):
                cases[f"sgmv bf16 {p} S={S}"] = cs.sgmv_case(ops, ref, p, di, do, S, gen, dev,
                                                             base=False, dtype=bf16)
        # the decode steps (S = 1): q at ranks 1 and 128, phase 9's other
        # configs' projections at B = 2, and (where the checkout's
        # sgmv_case takes 16 rows) q at B = 16
        for r in (1, 128):
            cases[f"fused_sgmv bf16 q S=1 r={r}"] = cs.sgmv_case(
                ops, ref, "q", 1024, 2048, 1, gen, dev, r=r, dtype=bf16)
        for name, proj, di, do in DECODE_B2:
            cases[f"fused_sgmv bf16 {name} {proj} B=2 S=1"] = cs.sgmv_case(
                ops, ref, proj, di, do, 1, gen, dev, B=2, dtype=bf16)
        if hasattr(cs, "SGMV_DECODE"):
            cases["fused_sgmv bf16 q B=16 S=1"] = cs.sgmv_case(
                ops, ref, "q", 1024, 2048, 1, gen, dev, B=16, dtype=bf16)
        return cases
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


def prefill_turn(root: Path, reps: int = 7) -> dict:
    """Phase 9's bf16 prefill of each ``BF16_ARCHS`` config of the checkout
    at ``root``, as ``chip_smoke.static_run`` runs it (weights drawn on the
    card from seed 0, ``random_lora`` slots, ids 0.. with the last row -1,
    a cache of phase 9's length): one warm-up call, then ``reps`` calls,
    each synchronised on both sides. ms is their median; every call's wall
    ms is kept in ``reps_ms``."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import time

    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cases = {}
    for name, B, S, chunk_len, steps, _ in cs.BF16_ARCHS:
        cfg = configs.get(name)
        if cfg.is_encdec:  # its prefill takes frames: no decoder-only turn
            continue
        max_len = -(-(S + chunk_len + steps + 8 * (cs.DECODE_WINDOWS + 1)) // 128) * 128
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(2))
        ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1][:B - 1] + [-1], dtype=torch.int32)
        model = build_model(cfg, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        lora = cs.random_lora(model, 8, 1)
        times = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, tokens, max_len, lora=lora, adapter_ids=ids)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        cases[f"prefill bf16 {name} {B}x{S}"] = dict(
            ms=statistics.median(times), reps_ms=times, plain_ms=None, library_ms=None)
        del model, params, lora
        torch.cuda.empty_cache()
    return cases


def phase9_device_ms(root: Path, reps: int = 3) -> dict:
    """Phase 9's bf16 extend (a B x 32 chunk, rows left ragged) and 8 greedy
    decode steps after it, of qwen3-0.6b (8 x 2016) and llama-7b (2 x 512)
    at full width and depth as ``chip_smoke.static_run`` runs them, each
    under ``chip_smoke.profiled`` after a fresh prefill: ms is the median of
    ``reps`` device busy times, ``attn_ms`` the ragged_extend (extend) or
    paged_attention (decode) kernels' device ms in the same window."""
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cases = {}
    for name, B, S, chunk_len, steps, _ in cs.BF16_ARCHS[:2]:
        cfg = configs.get(name)
        max_len = -(-(S + chunk_len + steps + 8 * (cs.DECODE_WINDOWS + 1)) // 128) * 128
        g = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        chunk = torch.randint(0, cfg.vocab_size, (B, chunk_len), generator=g)
        lens = torch.tensor([chunk_len - (7 * b) % chunk_len for b in range(B)],
                            dtype=torch.int32)
        ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1][:B - 1] + [-1], dtype=torch.int32)
        start = torch.full((B,), S, dtype=torch.int32)
        last = (lens.long() - 1).clamp(min=0)[:, None]
        model = build_model(cfg, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        lora = cs.random_lora(model, 8, 1)
        runs = {"extend": [], "decode": []}
        for _ in range(reps + 1):  # the first run warms up
            _, cache = model.prefill(params, tokens, max_len, lora=lora, adapter_ids=ids)
            box = {}

            def extend():
                box["lg"], box["cache"] = model.extend(
                    params, cache, chunk, start, lora=lora, adapter_ids=ids, true_lens=lens,
                    logit_positions=last)

            def decode():
                tok = box["lg"][:, -1].argmax(-1).to(torch.int32)
                c = box["cache"]
                for _ in range(8):
                    lg, c = model.decode(params, c, tok[:, None], lora=lora, adapter_ids=ids)
                    tok = lg[:, -1].argmax(-1).to(torch.int32)

            torch.cuda.synchronize()
            runs["extend"].append(cs.profiled(extend))
            runs["decode"].append(cs.profiled(decode))
        for part, group in (("extend", "ragged_extend"), ("decode", "paged_attention")):
            prof = runs[part][1:]
            cases[f"phase9 {name} {part} (device)"] = dict(
                ms=statistics.median(r["device_busy_ms"] for r in prof),
                attn_ms=statistics.median((r["device_ms_by_group"] or {}).get(group, 0.0)
                                          for r in prof),
                wall_ms=statistics.median(r["wall_ms"] for r in prof),
                plain_ms=None, library_ms=None)
        del model, params, lora, cache, box
        torch.cuda.empty_cache()
    return cases


def launch_split(S: int, calls: int = 10) -> dict:
    """Device µs per call of each CUDA kernel of one bf16 fused_sgmv call
    on qwen3-0.6b's q projection (B = 8, rank 32), from ``torch.profiler``
    over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    x = torch.randn((8, S, 1024), generator=gen, device=dev).to(bf16)
    w = (torch.randn((1024, 2048), generator=gen, device=dev) / 32).to(bf16)
    a = (torch.randn((8, 1024, 32), generator=gen, device=dev) / 32).to(bf16)
    b = (torch.randn((8, 32, 2048), generator=gen, device=dev) * 0.1).to(bf16)
    ids = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 7], dtype=torch.int32, device=dev)
    for _ in range(3):
        ops.fused_sgmv(x, w, a, b, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.fused_sgmv(x, w, a, b, ids)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key[:80]] = us / calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cases", choices=("all", "forward", "backward", "flash_bf16",
                                        "sgmv_bf16", "prefill_bf16", "attn_bf16"),
                    default="all")
    ap.add_argument("--run", help="(internal) run one turn in this checkout")
    args = ap.parse_args()
    if args.run:
        root = Path(args.run).resolve()
        cases = (prefill_turn(root) if args.cases == "prefill_bf16"
                 else turn(root, args.cases))
        print(json.dumps({"ms": {k: c["ms"] for k, c in cases.items()},
                          "cold_ms": {k: c["cold"]["ms"] for k, c in cases.items()
                                      if "cold" in c},
                          "plain_ms": {k: c["plain_ms"] for k, c in cases.items()},
                          "library_ms": {k: c["library_ms"] for k, c in cases.items()},
                          "path": {k: c["path"] for k, c in cases.items() if "path" in c},
                          "cublas_xw_ms": {k: c["cublas_xw_ms"] for k, c in cases.items()
                                           if "cublas_xw_ms" in c},
                          "cublas_xw_cold_ms": {k: c["cold"]["cublas_xw_ms"]
                                                for k, c in cases.items()
                                                if "cublas_xw_ms" in c.get("cold", {})},
                          "reps_ms": {k: c["reps_ms"] for k, c in cases.items()
                                      if "reps_ms" in c},
                          "attn_ms": {k: c["attn_ms"] for k, c in cases.items()
                                      if "attn_ms" in c},
                          **({"launch_split_us": {f"q S={S}": launch_split(S)
                                                  for S in (256, 2016, 1)}}
                             if args.cases == "sgmv_bf16" else {})}),
              flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dirs = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; print(build.build_all())",
         str(d / "src")]) for d in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("phase3_ab: a kernel build failed")
    times = {"A": [], "B": []}
    for i, who in enumerate("ABBA" * args.rounds):
        out = subprocess.run([sys.executable, __file__, "--run", str(dirs[who]),
                              "--cases", args.cases], capture_output=True, text=True)
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
        if not ratios:  # the backward cases are timed warm only
            continue
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
