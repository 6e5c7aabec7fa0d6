"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the script
exits non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build   — nvcc builds every kernel of the path from ``src/repro_torch/
             kernels/csrc`` (one process per source, in parallel).
3. kernels — each kernel against its plain PyTorch version at the main
             path's shapes (qwen3-0.6b: 8 slots, 256-token buckets, a
             2048-token cache), timed with CUDA events beside its plain
             version, one PyTorch library call where one computes the same
             function, and its bound (bytes / 3.35 TB/s or f32 flops / 67
             TFLOP/s, the larger).
4. engine  — the serving engine on qwen3-0.6b at full width (28 layers,
             random weights from seed 0), 36 requests on 6 adapters with
             shared system prompts and repeated prompts, a 4 GiB KV pool and
             an 8 GiB host tier; launch counts are reset just before and
             read just after. Then ``profile``: a fresh 12-request wave,
             40 of its steps under ``torch.profiler``, gives the device's
             busy share and device time per kernel group.
5. cpu     — the card's tokens against a teacher-forced CPU run of the same
             weights (the kernels' plain versions).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SGMV_TOL = 1e-4  # times max|ref|: f32 sums of up to 2048 terms, other order
ATTN_TOL = 1e-5  # absolute: softmax-weighted unit-scale values
ARGMAX_TOL = 1e-3  # a card token may trail the CPU's best logit by this


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``. The stream is first held by
    a spin kernel that outlasts the host's enqueue of all ``iters`` calls,
    so the events time the device's work alone; a short kernel timed
    without it would read the host's launch cost. The host time is the
    enqueue time per call (Python, checks, launch)."""
    h0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_guess = (time.perf_counter() - h0) / warmup
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # ~2e6 cycles per ms at the H100's clock; hold for 3x the enqueue
    torch.cuda._sleep(int(2e6 * max(20.0, 3e3 * iters * host_guess)))
    t0.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - h0) / iters * 1e3
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_ms


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ----------------------------------------------------------------- phase 3
def sgmv_case(ops, ref, proj, d_in, d_out, S, gen, dev, B=8, N=8, r=32):
    x = torch.randn((B, S, d_in), generator=gen, device=dev)
    w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
    a = torch.randn((N, d_in, r), generator=gen, device=dev) * d_in ** -0.5
    b = torch.randn((N, r, d_out), generator=gen, device=dev) * 0.1
    ids = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 7], dtype=torch.int32, device=dev)
    scale = 1.0
    errs = []
    for zero_w in (False, True):
        ww = torch.zeros_like(w) if zero_w else w
        got = ops.fused_sgmv(x, ww, a, b, ids, scale=scale)
        want = ref.fused_sgmv_ref(x, ww, a, b, ids, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = SGMV_TOL * float(want.abs().max())
        require(err <= tol, f"fused_sgmv {proj} S={S} zero_w={zero_w}: "
                            f"max err {err} > {tol}")
        errs.append(err)
    live = ids >= 0
    n_live_ids = int(torch.unique(ids[live]).numel())
    M, M_live = B * S, int(live.sum()) * S
    nbytes = 4 * (M * d_in + d_in * d_out + M * d_out
                  + n_live_ids * r * (d_in + d_out)) + 4 * B
    flops = 2 * M * d_in * d_out + 2 * M_live * r * (d_in + d_out)
    bnd, by = bound_ms(nbytes, flops)
    ms, host_ms = time_ms(lambda: ops.fused_sgmv(x, w, a, b, ids, scale=scale))
    return dict(
        case=f"{proj} {d_in}->{d_out}, B={B}, S={S}, r={r}",
        max_abs_err=max(errs), ms=ms, host_ms=host_ms,
        plain_ms=time_ms(lambda: ref.fused_sgmv_ref(x, w, a, b, ids, scale))[0],
        bound_ms=bnd, bound_by=by, library_ms=None,
    )


def ragged_case(ops, ref, gen, dev, B=8, S=256, T=2048, H=16, Hkv=8, D=128):
    q = torch.randn((B, S, H, D), generator=gen, device=dev)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    v = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    lens = [0, 1, 37, 256, 256, 37, 1, 256]
    starts = [0, 2047, 500, 0, 1792, 1011, 64, 300]
    tl = torch.tensor(lens, dtype=torch.int32, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    got = ops.ragged_extend(q, k, v, st, tl)
    want = ref.ragged_extend_ref(q, k, v, st, tl)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(err <= ATTN_TOL, f"ragged_extend: max err {err} > {ATTN_TOL}")
    require(bool((got[0] == 0).all()), "ragged_extend: a true_lens 0 row is not 0")
    # the same function through one library call: GQA attention with the
    # equivalent boolean mask (padded queries see nothing and give NaN there)
    qpos = st[:, None].long() + torch.arange(S, device=dev)[None, :]
    kpos = torch.arange(T, device=dev)
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (torch.arange(S, device=dev)[None, :, None] < tl[:, None, None].long()))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))[0]
    live_q = sum(lens)
    kv_tokens = sum(s + n for s, n in zip(starts, lens) if n > 0)
    nbytes = 4 * (live_q * H * D + 2 * kv_tokens * Hkv * D + B * S * H * D) + 8 * B
    flops = sum(4 * H * D * (s + j + 1) for s, n in zip(starts, lens) for j in range(n))
    bnd, by = bound_ms(nbytes, flops)
    ms, host_ms = time_ms(lambda: ops.ragged_extend(q, k, v, st, tl))
    return dict(
        case=f"B={B}, S={S}, T={T}, {H}/{Hkv} heads, D={D}, true_lens={lens}",
        max_abs_err=err, ms=ms, host_ms=host_ms,
        plain_ms=time_ms(lambda: ref.ragged_extend_ref(q, k, v, st, tl))[0],
        bound_ms=bnd, bound_by=by, library_ms=lib,
    )


def paged_case(ops, ref, gen, dev, B=8, T=2048, H=16, Hkv=8, D=128, ps=128):
    pages = T // ps
    q = torch.randn((B, H, D), generator=gen, device=dev)
    kc = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    vc = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    kp, vp = kc.view(B * pages, ps, Hkv, D), vc.view(B * pages, ps, Hkv, D)
    tables = torch.arange(B * pages, dtype=torch.int32, device=dev).view(B, pages)
    lens = [0, 1, 129, 2048, 2048, 129, 1, 2049]  # 2049: an idle row at len T
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.paged_attention(q, kp, vp, tables, ln)
    want = ref.paged_attention_ref(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(err <= ATTN_TOL, f"paged_attention: max err {err} > {ATTN_TOL}")
    require(bool((got[0] == 0).all()), "paged_attention: a length 0 row is not 0")
    mask = (torch.arange(T, device=dev)[None, :] < ln[:, None].long())[:, None, None, :]
    qt = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))[0]
    kv_tokens = sum(min(n, T) for n in lens)
    nbytes = 4 * (2 * B * H * D + 2 * kv_tokens * Hkv * D) + 4 * B * (pages + 1)
    flops = 4 * H * D * kv_tokens
    bnd, by = bound_ms(nbytes, flops)
    ms, host_ms = time_ms(lambda: ops.paged_attention(q, kp, vp, tables, ln))
    return dict(
        case=f"B={B}, T={T}, page={ps}, {H}/{Hkv} heads, D={D}, lengths={lens}",
        max_abs_err=err, ms=ms, host_ms=host_ms,
        plain_ms=time_ms(lambda: ref.paged_attention_ref(q, kp, vp, tables, ln))[0],
        bound_ms=bnd, bound_by=by, library_ms=lib,
    )


# ----------------------------------------------------------------- phase 4
def make_trace(Request, vocab: int, seed: int = 0, N1: int = 24, tag: str = ""):
    """Two waves: N1 requests, then 12 that include 6 repeats of wave-1
    prompts (prefix hits). About half open with one 256-token shared system
    prompt declared as ``shared_prefix_len``. ``tag`` prefixes the ids."""
    rng = random.Random(seed)
    system = tuple(rng.randrange(vocab) for _ in range(256))

    def fresh(i):
        # 64-1024 tokens, skewed long (mean ~780) so the KV working set
        # (~5 GB) outgrows the 4 GiB pool and the swapper moves KV to host
        n = 64 + int(960 * (1.0 - rng.random() ** 3))
        if i % 2 == 0 and n > 320:
            body = tuple(rng.randrange(vocab) for _ in range(n - 256))
            return system + body, 256
        return tuple(rng.randrange(vocab) for _ in range(n)), 0

    wave1, wave2 = [], []
    for i in range(N1):
        prompt, shared = fresh(i)
        wave1.append(Request(f"{tag}w1-{i}", f"lora-{i % 6}", prompt,
                             max_new_tokens=32, shared_prefix_len=shared))
    for i in range(12):
        if i % 2 == 0:
            old = wave1[(3 * i) % N1]
            prompt, shared, adapter = old.prompt, old.shared_prefix_len, old.adapter_id
        else:
            (prompt, shared), adapter = fresh(i), f"lora-{(i + 3) % 6}"
        wave2.append(Request(f"{tag}w2-{i}", adapter, prompt, max_new_tokens=32,
                             shared_prefix_len=shared))
    return wave1, wave2


KERNEL_GROUPS = (  # device-event name fragment -> group, first match wins
    ("fused_sgmv", "fused_sgmv"), ("lora_shrink", "fused_sgmv"),
    ("ragged_extend", "ragged_extend"), ("paged_attention", "paged_attention"),
    ("gemm", "library matmul"), ("gemv", "library matmul"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)


def profile_steps(engine, Request, vocab: int, steps: int = 40):
    """Serve a fresh wave of 12 requests (another seed) and trace the first
    ``steps`` engine steps with ``torch.profiler`` (device activity only).
    Returns the device's busy share of the window's wall time and device
    time per kernel group; ``None`` fields if the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wave = make_trace(Request, vocab, seed=1, N1=12, tag="prof")[0]
    for r in wave:
        engine.submit(r)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run()  # finish the wave outside the window
    spans, groups, top = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        g = next((g for frag, g in KERNEL_GROUPS if frag in e.name), "other")
        groups[g] = groups.get(g, 0.0) + (hi - lo) / 1e3
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + (hi - lo) / 1e3
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):  # union of the kernel intervals
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {
        "steps": steps, "wall_ms": wall_us / 1e3, "device_events": len(spans),
        "device_busy_ms": busy / 1e3 if spans else None,
        "device_busy_share": busy / wall_us if spans else None,
        "device_ms_by_group": groups or None,
        "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]) or None,
    }


def pick_requests(finished):
    """At least 4 finished, never-preempted requests (a preempted request
    folds its tokens into its prompt): one with a shared prefix, one with a
    prefix hit, then the shortest others."""
    clean = [r for r in finished if r.preempt_count == 0]
    shared = [r for r in clean if r.shared_prefix_len > 0][:1]
    hit = [r for r in clean if r.matched_tokens > 0 and r not in shared][:1]
    others = sorted((r for r in clean if r not in shared + hit),
                    key=lambda r: len(r.prompt))
    picked = shared + hit + others[: 4 - len(shared + hit)]
    require(len(picked) >= 4 and shared and hit,
            f"need 4 clean requests with a shared prefix and a prefix hit, "
            f"got {len(picked)}")
    return picked


def check_against_cpu(cfg, ecfg, adapters, picked, seed: int = 0):
    """Rebuild the weights on the CPU (same seed, CPU generators) and run one
    teacher-forced ``extend`` over each request's prompt and generated
    tokens, with its shared span at adapter id -1 as the engine ran it.
    Each card token must be the CPU argmax or trail the CPU's best logit by
    at most ``ARGMAX_TOL``. Returns (tokens, argmax-equal, largest deficit,
    smallest top-2 gap)."""
    import zlib

    from repro_torch.lora import AdapterStore
    from repro_torch.models import build_model

    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(seed))
    store = AdapterStore(model, cfg.lora.max_adapters)
    for aid in adapters:
        store.register(aid, generator=torch.Generator().manual_seed(
            zlib.crc32(aid.encode())))
    worst, min_gap, exact, total = 0.0, math.inf, 0, 0
    for r in picked:
        slot = store.load(r.adapter_id)
        full = list(r.prompt) + list(r.generated)
        P, G = len(r.prompt), len(r.generated)
        cache = model.init_cache(1, ecfg.max_seq_len)
        sb = min(max(r.shared_prefix_len, 0), P)
        spans = [(0, sb, -1), (sb, P + G - 1, slot)] if sb else [(0, P + G - 1, slot)]
        logits = []
        for lo, hi, aid in spans:
            # the span's positions whose next token the card generated
            pos = [p - lo for p in range(max(lo, P - 1), hi)] or [0]
            out, cache = model.extend(
                params, cache, torch.tensor([full[lo:hi]]), cache["len"],
                lora=store.slots, adapter_ids=torch.tensor([aid], dtype=torch.int32),
                logit_positions=torch.tensor([pos]))
            if hi > max(lo, P - 1):
                logits.append(out[0])
        lg = torch.cat(logits)  # (G, vocab)
        require(lg.shape[0] == G, f"{r.request_id}: {lg.shape[0]} logits for {G} tokens")
        gen = torch.tensor(r.generated)
        top2 = lg.topk(2, dim=-1).values
        deficit = float((top2[:, 0] - lg[torch.arange(G), gen]).max())
        worst = max(worst, deficit)
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        exact += int((lg.argmax(-1) == gen).sum())
        total += G
        require(deficit <= ARGMAX_TOL,
                f"{r.request_id}: a card token trails the CPU max logit by {deficit}")
        store.unload(r.adapter_id)
    return total, exact, worst, min_gap


def main() -> None:
    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    per_kernel = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per_kernel, "dir": str(build.BUILD_DIR)})

    # ---------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    sgmv_cases = [sgmv_case(ops, ref, p, di, do, S, gen, dev)
                  for S in (256, 1)
                  for p, di, do in (("q", 1024, 2048), ("k", 1024, 1024),
                                    ("v", 1024, 1024), ("o", 2048, 1024))]
    rag = ragged_case(ops, ref, gen, dev)
    pag = paged_case(ops, ref, gen, dev)
    emit({"phase": "kernels", "fused_sgmv": sgmv_cases,
          "ragged_extend": rag, "paged_attention": pag})
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. engine
    cfg = configs.get("qwen3-0.6b")
    ecfg = EngineConfig(hbm_bytes=4 << 30, host_bytes=8 << 30, block_size=16,
                        max_batch_slots=8, max_seq_len=2048, prefill_chunk=256,
                        step_token_budget=512)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, ecfg, seed=0, device=dev)
    adapters = [f"lora-{i}" for i in range(6)]
    for aid in adapters:
        engine.register_adapter(aid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wave1, wave2 = make_trace(Request, cfg.vocab_size)
    reqs = wave1 + wave2
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in wave1:
        engine.submit(r)
    engine.run()
    for r in wave2:
        engine.submit(r)
    report = engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    decode_calls = engine._decode_calls
    prefill_calls = engine.prefill.stats.calls
    L = cfg.num_layers
    row = report.row()
    emit({"phase": "engine", "setup_s": setup_s, "run_s": run_s,
          "report": row, "launches": launches,
          "steps": engine._step_count, "decode_calls": decode_calls,
          "prefill_calls": prefill_calls,
          "swap_out_bytes": engine.kv_pool.swap_out_bytes,
          "swap_in_bytes": engine.kv_pool.swap_in_bytes,
          "prompt_tokens": sum(len(r.prompt) for r in reqs),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    require(row["n_finished"] == len(reqs) and row["n_unfinished"] == 0,
            f"finished {row['n_finished']} of {len(reqs)}")
    require(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")
    require(row["kv_hit_rate"] > 0, "kv_hit_rate is 0")
    require(launches["paged_attention"] == L * decode_calls
            and launches["ragged_extend"] == L * prefill_calls
            and launches["fused_sgmv"] == 4 * L * (decode_calls + prefill_calls),
            f"launches {launches} do not match {decode_calls} decode and "
            f"{prefill_calls} prefill calls of {L} layers")

    picked = pick_requests(engine.finished)
    emit({"phase": "profile", **profile_steps(engine, Request, cfg.vocab_size)})

    # -------------------------------------------------------------- 5. cpu
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total, exact, worst, min_gap = check_against_cpu(cfg, ecfg, adapters, picked)
    emit({"phase": "cpu", "requests": [r.request_id for r in picked],
          "shared_prefix": [r.shared_prefix_len for r in picked],
          "matched_tokens": [r.matched_tokens for r in picked],
          "tokens": total, "argmax_equal": exact,
          "largest_deficit": worst, "smallest_top2_gap": min_gap,
          "seconds": time.perf_counter() - t0})

    # ---------------------------------------------------------- 6. summary
    main_sgmv = sgmv_cases[0]  # the q projection in a 256-token bucket
    kernels = []
    for name, src, tpu, m in (
            ("fused_sgmv", "fused_sgmv.cu", "src/repro/kernels/sgmv.py:115", main_sgmv),
            ("ragged_extend", "ragged_extend.cu",
             "src/repro/kernels/ragged_extend.py:121", rag),
            ("paged_attention", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:99", pag)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": tpu,
            "launches": launches[name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "case": m["case"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
