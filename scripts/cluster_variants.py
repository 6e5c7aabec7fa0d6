"""Time edited variants of bf16 fused_sgmv's cluster loop on one NVIDIA GPU.

    python3 scripts/cluster_variants.py [--only NAME ...]

Each variant is ``src/repro_torch/kernels/csrc/fused_sgmv_cluster.cu`` with
its edits (text substitutions in a copy of ``csrc``, built with the flags
of ``kernels/build.py`` into a temporary directory, all in parallel), so
each line says what one design choice is worth on this card. Cases: the
decode projections of ``DECODE_BF16`` below (B rows at S = 1, rank 32,
ids as in ``chip_smoke.py``), timed as ``chip_smoke.py`` times the decode
kernels with a cold L2, each with its largest error against the plain
bf16 version (a diagnostic variant that drops work shows it). The variant
"as built" runs first and last, to show the drift
of the card. The variant ``timeline`` records ``%globaltimer`` at the
steps of each block of one launch (W blocks: entry, ids read, W streamed,
arrived at the cluster barrier, h read and the delta computed (blocks
whose share has a live row), cluster barrier passed, end; shrink blocks of a live id: entry, ids
read, its part of h stored; and when each of the first 8 ring stages was
ready) and prints, per step, the median and largest µs after the first
block's entry. Needs a card and nvcc;
prints the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from attention_variants import build_variants, load  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.sgmv import _CLUSTER_SIGNATURES  # noqa: E402

SRC = "fused_sgmv_cluster.cu"
# (name, B, d_in, d_out) of the decode projections timed
DECODE_BF16 = (("qwen3-0.6b q", 8, 1024, 2048), ("qwen3-0.6b k", 8, 1024, 1024),
               ("qwen3-0.6b o", 8, 2048, 1024), ("llama-7b q", 2, 4096, 4096),
               ("recurrentgemma-2b k", 2, 2560, 256))

MINE = "  bool mine = false;\n  for (int m = m_lo; m <= m_hi; ++m) mine |= live_row(m);\n"
LIVE = "    if (live_row(m)) v = v + ds[u - u0];\n"
LEAD = "    if (!((s_lead_mask >> b) & 1u)) return;  // uniform over the cluster"

HEAD = "constexpr int HEAD = 1;"
VARIANTS = {
    "as built": [],
    # stages a W block issues before it reads the ids: none (the ids
    # first), or the whole ring (every W request ahead of the shrink's)
    "head_0": [(SRC, HEAD, "constexpr int HEAD = 0;")],
    "head_2": [(SRC, HEAD, "constexpr int HEAD = 2;")],
    # a ring of 4 stages of 32 k rows (the same bytes in flight)
    "ks32_stages_4": [(SRC, "constexpr int KS = 64; ", "constexpr int KS = 32; "),
                      (SRC, "constexpr int STAGES = 2; ", "constexpr int STAGES = 4; ")],
    # clusters of at most 8 blocks (portable), not 16
    "cs_8": [(SRC, "constexpr int MAX_CS = 16; ", "constexpr int MAX_CS = 8; ")],
    # a part of h read again without a sleep between the reads
    "no_sleep": [(SRC, "          __nanosleep(32);\n", "")],
    # 4 lanes a unit in the expand's sum over ranks, not 8
    "kl_4": [(SRC, "constexpr int KL = 8; ", "constexpr int KL = 4; ")],
    # no prefetch of the expand's rows of B into L1 during the W stream
    "no_b_prefetch": [(SRC, "      prefetch_l1(bm + (size_t)(e / nl) * d_out + min(c0 + 32 * (e % nl), c1 - 1));\n",
                       "      ;\n")],
    # diagnostics (wrong results): no W block waits for h, reads it or adds
    # the expand; and no shrink block works either
    "no_expand": [(SRC, MINE, "  bool mine = false;\n"), (SRC, LIVE, "")],
    "no_shrink_no_expand": [(SRC, MINE, "  bool mine = false;\n"), (SRC, LIVE, ""),
                            (SRC, LEAD, "    return;")],
}

# the timeline: %globaltimer at each step of every block of one launch
TL_DEFS = """
__device__ unsigned long long g_tl[16384][16];
#define TL(k) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  g_tl[blockIdx.y * gridDim.x + blockIdx.x][k] = t_; } } while (0)

namespace {
"""
TL_EDITS = [
    (SRC, "\nnamespace {\n\nnamespace cg", TL_DEFS + "\nnamespace cg"),
    (SRC, "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  TL(0);\n"),
    (SRC, "    read_ids();\n    if (!((s_lead", "    read_ids();\n    TL(1);\n    if (!((s_lead"),
    (SRC, "      shrink_fma(hz);\n    }\n    return;\n", "      shrink_fma(hz);\n    }\n    TL(2);\n    return;\n"),
    (SRC, "  issue(0, HEAD);\n  read_ids();\n", "  issue(0, HEAD);\n  read_ids();\n  TL(1);\n"),
    (SRC, "  float* part = reinterpret_cast<float*>(ring);", "  TL(2);\n  float* part = reinterpret_cast<float*>(ring);"),
    (SRC, '  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");\n',
     '  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");\n  TL(3);\n'),
    (SRC, "        hs[m * MAX_R + k] = scale * tagged_sum(h + (size_t)m * r + k, (size_t)M * r, cs, tag);\n    }\n    __syncthreads();\n",
     "        hs[m * MAX_R + k] = scale * tagged_sum(h + (size_t)m * r + k, (size_t)M * r, cs, tag);\n    }\n    __syncthreads();\n    TL(4);\n"),
    (SRC, "      if (live && l == 0) ds[u - u0] = d;\n    }\n    __syncthreads();\n",
     "      if (live && l == 0) ds[u - u0] = d;\n    }\n    __syncthreads();\n    TL(7);\n"),
    (SRC, '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");  // every partial is out\n',
     '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");  // every partial is out\n  TL(5);\n'),
    (SRC, '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n}',
     '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n  TL(6);\n}'),
    (SRC, "      __syncthreads();              // everyone's\n",
     "      __syncthreads();              // everyone's\n      if (i < 8) TL(8 + i);\n"),
    (SRC, 'extern "C" const char* fused_sgmv_cluster_error_string',
     'extern "C" int fused_sgmv_cluster_timeline(unsigned long long* out, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(unsigned long long) * 16 * (size_t)n);\n'
     '}\n\nextern "C" const char* fused_sgmv_cluster_error_string'),
]
W_STEPS = ("entry", "ids", "w_streamed", "arrived", "h_read", "barrier_1", "end", "delta")
S_STEPS = ("entry", "ids", "h_part_stored")


def _inputs(B, d_in, d_out, gen, dev):
    bf16 = torch.bfloat16
    x = torch.randn((B, 1, d_in), generator=gen, device=dev).to(bf16)
    w = (torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5).to(bf16)
    a = (torch.randn((8, d_in, 32), generator=gen, device=dev) * d_in ** -0.5).to(bf16)
    b = (torch.randn((8, 32, d_out), generator=gen, device=dev) * 0.1).to(bf16)
    ids = torch.tensor(([-1, 0, 1, 2, 3, 4, 5, 7] * 2)[:B], dtype=torch.int32, device=dev)
    return x, w, a, b, ids


def _caller(lib, x, ids, d_in, d_out, y, sms, stream):
    """A launch of ``lib``'s loop on W, A, B, with a scratch of h of its own
    (zeros at first, as sgmv.cluster_h makes it)."""
    B = x.shape[0]
    h = torch.zeros((16 * 16 * 128,), device=x.device, dtype=torch.int64)

    def call(w, a, b):
        code = lib.fused_sgmv_cluster_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(), y.data_ptr(),
            h.data_ptr(), h.numel(), B, 1, d_in, d_out, 32, sms, 1.0, stream)
        assert code == 0, code
    return call


def timeline(lib, case, gen, dev, sms, stream):
    """One cold launch's steps per block (see the module docstring)."""
    name, B, d_in, d_out = case
    x, w, a, b, ids = _inputs(B, d_in, d_out, gen, dev)
    y = torch.empty((B, 1, d_out), device=dev, dtype=torch.bfloat16)
    call = _caller(lib, x, ids, d_in, d_out, y, sms, stream)
    plan = (ctypes.c_int64 * 4)()
    assert lib.fused_sgmv_cluster_plan(B, 1, d_in, d_out, sms, ctypes.addressof(plan)) == 0
    cols, nb, csz, _ = plan
    copies = [(w.clone(), a.clone(), b.clone()) for _ in range(cs.cold_copies(2 * d_in * d_out))]
    for c in copies:  # warm up, then one launch on a copy that has left the L2
        call(*c)
    call(*copies[0])
    torch.cuda.synchronize()
    n = (cols + nb) * csz
    buf = (ctypes.c_uint64 * (16 * n))()
    assert lib.fused_sgmv_cluster_timeline(ctypes.addressof(buf), n) == 0
    t = [[buf[16 * i + k] for k in range(16)] for i in range(n)]
    t0 = min(row[0] for row in t)
    idl = ids.tolist()
    leads = [bb for bb in range(nb) if idl[bb] >= 0 and idl[bb] not in idl[:bb]]
    out = {"case": name, "cs": csz, "cols": cols, "nb": nb}
    w_rows = [t[(nb + c) * csz + z] for c in range(cols) for z in range(csz)]
    s_rows = [t[bb * csz + z] for bb in leads for z in range(csz)]
    for what, rows, steps in (("w", w_rows, W_STEPS), ("shrink", s_rows, S_STEPS)):
        # a step some blocks skip (a W block whose share has no live row
        # reads no h) holds an older launch's time there: left out
        out[what] = {s: {"median_us": statistics.median(v), "max_us": max(v), "blocks": len(v)}
                     for k, s in enumerate(steps)
                     for v in [[(r[k] - t0) / 1e3 for r in rows if r[k] >= t0]] if v}
        # when each of the first 8 ring stages was ready (this launch's only)
        out[what]["stage_ready_median_us"] = [
            statistics.median(v) if v else None for v in
            ([(r[8 + i] - t0) / 1e3 for r in rows if r[8 + i] >= t0] for i in range(8))]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, help="variants to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cluster_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    variants = {k: v for k, v in VARIANTS.items()
                if args.only is None or k in args.only or k == "as built"}
    variants["timeline"] = TL_EDITS
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = build.sm_count(dev)
    cases = {}
    for case in DECODE_BF16:
        name, B, d_in, d_out = case
        x, w, a, b, ids = _inputs(B, d_in, d_out, gen, dev)
        want = ref.fused_sgmv_ref(x, w, a, b, ids)
        live = int(torch.unique(ids[ids >= 0]).numel())
        n = cs.cold_copies(2 * (d_in * d_out + live * 32 * (d_in + d_out)))
        cases[name] = (x, ids, [(w.clone(), a.clone(), b.clone()) for _ in range(n)],
                       d_in, d_out, want)
    sig = {**_CLUSTER_SIGNATURES, "fused_sgmv_cluster_timeline": "pi"}
    logs = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), variants, ("fused_sgmv_cluster",),
                              flags=("-Xptxas", "-v"), logs=logs)
        for name in [*variants, "as built"]:
            lib = load(libs[name]["fused_sgmv_cluster"],
                       sig if name == "timeline" else _CLUSTER_SIGNATURES)
            if name == "timeline":
                for case in DECODE_BF16:
                    print(json.dumps({"variant": name,
                                      **timeline(lib, case, gen, dev, sms, stream)}), flush=True)
                continue
            regs = [ln.strip() for ln in logs[name, "fused_sgmv_cluster"].splitlines()
                    if "registers" in ln or "spill" in ln]
            line = {"variant": name, "ptxas": regs[-2:]}
            for cname, (x, ids, copies, d_in, d_out, want) in cases.items():
                y = torch.empty((x.shape[0], 1, d_out), device=dev, dtype=torch.bfloat16)
                call = _caller(lib, x, ids, d_in, d_out, y, sms, stream)
                call(*copies[0])
                torch.cuda.synchronize()
                err = float((y.float() - want.float()).abs().max())
                line[cname] = {"cold_ms": cs.time_ms(cs.rotating(
                    [lambda c=c: call(*c) for c in copies]), iters=40)[0], "max_abs_err": err}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
