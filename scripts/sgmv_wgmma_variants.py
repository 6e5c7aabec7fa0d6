"""Time edited variants of bf16 fused_sgmv's wgmma loop on one NVIDIA GPU.

    python3 scripts/sgmv_wgmma_variants.py

Each variant is the CUDA source of ``src/repro_torch/kernels/csrc`` with
edits to ``fused_sgmv_wgmma.cu`` (text substitutions in a copy, built with
the flags of ``kernels/build.py`` and ``-Xptxas -v``, as
``scripts/attention_variants.py`` builds its variants), so each line says
what one design choice of that loop is worth on this card, and whether
ptxas serialized its wgmma products (warning C7515):

- ``wait_own``: the main loop waits for each stage's own products before
  releasing it (in place of keeping one stage's products in flight);
- ``three_stages``: a 3-stage ring in place of 4;
- ``tile_128``: 128 x 128 output tiles (m64n128k16 products, 64 sums a
  thread), the source's plan counting tiles of 128 columns;
- ``no_pdl``: the tile loop launched after the shrink has finished, not as
  its programmatic dependent;
- ``expand_off``: no expand products (wrong results: what the expand costs).

- plans other than the source's ``make_plan``: ``parts_N`` (the tile loop's
  d_in in N parts, at the small shapes) and ``shrink_parts_N`` (the
  shrink's d_in in N parts), each on the cases it bears on.

Each
variant runs bf16 fused_sgmv (rank 32 unless named) at qwen3-0.6b's q and k
over 8 x 2016 tokens, q (also at rank 128) and k over 8 x 256, phase 9's 8 x 32
extend and llama-7b's q over 2 x 512 and 2 x 32, and prints per case its device ms
(CUDA events, the timer of ``chip_smoke.py``), its largest error against the
plain bf16 version and whether it keeps chip_smoke's bars. "as built" runs
first and last, to show the drift of the card. Needs a card and nvcc;
prints the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from attention_variants import build_variants, load  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

sg = importlib.import_module("repro_torch.kernels.sgmv")


def ss_mn_wrapper(n: int) -> str:
    """wgmma.cuh's wgmma_ss_mn for an m64n{n}k16 product (the loop as built
    needs n = 256 only)."""
    regs = n // 2
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    lst = ", ".join(f"%{i}" for i in range(regs))
    return (f"__device__ __forceinline__ void wgmma_ss_mn(float (&d)[{regs}], uint64_t da, "
            f"uint64_t db) {{\n  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{lst}}}, '
            f'%{regs}, %{regs + 1}, p, 1, 1, 0, 1;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(da), "l"(db), "r"(1));\n}}\n\n')


F = "fused_sgmv_wgmma.cu"
SS256 = "// d += A·B, m64n256k16; A from shared memory K-major, B from shared memory\n"
# name -> [(file, text, replacement), ...]; each text must occur in its file
VARIANTS = {
    "as built": [],
    "wait_own": [
        (F, "  int prev = -1;\n  for (int kt = kt0; kt < kt1; ++kt) {",
         "  for (int kt = kt0; kt < kt1; ++kt) {"),
        (F, "    wg::wgmma_wait<1>();  // the previous stage's products have completed\n"
            "    wg::fence_regs(acc);\n    if (prev >= 0) release(prev);\n    prev = st;\n  }\n"
            "  wg::wgmma_wait();\n  wg::fence_regs(acc);\n  release(prev);\n",
         "    wg::wgmma_wait();\n    wg::fence_regs(acc);\n    release(st);\n  }\n")],
    "three_stages": [(F, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "tile_128": [(F, "constexpr int BM = 128, BN = 256;  // output tile",
                  "constexpr int BM = 128, BN = 128;"),
                 ("wgmma.cuh", SS256, ss_mn_wrapper(128) + SS256)],
    "no_pdl": [(F, "  e = launch_dependent(tile_kernel, grid, dim3(THREADS), SMEM, st, xmap, wmap, "
                   "hmap, bmap, ids,\n                       part, base_kper, y, M, S, d_in, "
                   "d_out, r);",
                "  tile_kernel<<<grid, THREADS, SMEM, st>>>(xmap, wmap, hmap, bmap, ids, part, "
                "base_kper, y, M, S, d_in, d_out, r);")],
    "expand_off": [(F, "      if (has) {", "      if (false) {")],
}
BASE_RULE = "  split(KT, sms / (2 * tiles), MIN_KPER, p.base_parts, p.base_kper);"
SHRINK_RULE = ("  split(KT, std::min(cdiv(KT, kmax), 2 * sms / blocks), 1, p.shrink_parts, "
               "p.shrink_kper);")
for n in (1, 2, 4, 8):
    VARIANTS[f"parts_{n}"] = [(F, BASE_RULE, f"  split(KT, {n}, 1, p.base_parts, p.base_kper);")]
    VARIANTS[f"shrink_parts_{n}"] = [
        (F, SHRINK_RULE, f"  split(KT, {n}, 1, p.shrink_parts, p.shrink_kper);")]
# case -> (B, S, d_in, d_out, r)
CASES = {
    "q 8 x 2016": (8, 2016, 1024, 2048, 32),
    "k 8 x 2016": (8, 2016, 1024, 1024, 32),
    "q 8 x 256": (8, 256, 1024, 2048, 32),
    "k 8 x 256": (8, 256, 1024, 1024, 32),
    "q 8 x 256, r=128": (8, 256, 1024, 2048, 128),
    "q 8 x 32 (extend)": (8, 32, 1024, 2048, 32),
    "llama-7b q 2 x 512": (2, 512, 4096, 4096, 32),
    "llama-7b q 2 x 32 (extend)": (2, 32, 4096, 4096, 32),
}
# the cases a plan variant runs (the others run every case)
PLAN_CASES = {"parts": ("q 8 x 32 (extend)", "k 8 x 256", "q 8 x 256"),
              "shrink_parts": ("q 8 x 2016", "q 8 x 256", "q 8 x 32 (extend)",
                               "llama-7b q 2 x 32 (extend)")}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sgmv_wgmma_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    ids = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 7], dtype=torch.int32, device=dev)
    inputs = {}
    for case, (B, S, d_in, d_out, r) in CASES.items():
        x = torch.randn((B, S, d_in), generator=gen, device=dev).to(bf)
        w = (torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5).to(bf)
        a = (torch.randn((8, d_in, r), generator=gen, device=dev) * d_in ** -0.5).to(bf)
        b = (torch.randn((8, r, d_out), generator=gen, device=dev) * 0.1).to(bf)
        i = ids[:B]
        inputs[case] = (x, w, a, b, i, ref.fused_sgmv_ref(x, w, a, b, i, 1.0),
                        ref.fused_sgmv_ref(x.float(), w.float(), a.float(), b.float(), i, 1.0))
    logs = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), VARIANTS, ("fused_sgmv_wgmma",),
                              flags=("-Xptxas", "-v"), logs=logs)
        for name in [*VARIANTS, "as built"]:
            lib = load(libs[name]["fused_sgmv_wgmma"], sg._WGMMA_SIGNATURES)
            cases = PLAN_CASES.get(name.rsplit("_", 1)[0], CASES)
            line = {"variant": name, "serialized": "C7515" in logs[name, "fused_sgmv_wgmma"]}
            for case, (x, w, a, b, i, want, want32) in inputs.items():
                if case not in cases:
                    continue
                B, S, d_in = x.shape
                d_out, r = w.shape[1], a.shape[2]
                out = (ctypes.c_int64 * 6)()
                assert lib.fused_sgmv_wgmma_plan(B, S, d_in, d_out, r, sms,
                                                 ctypes.addressof(out)) == 0
                sp, skper, bp, bkper, floats, n_count = out
                y = torch.empty((B, S, d_out), device=dev, dtype=bf)
                scratch = torch.empty((max(1, floats),), device=dev, dtype=torch.float32)
                counters = torch.zeros((max(1, n_count),), device=dev, dtype=torch.int32)

                def launch():
                    assert lib.fused_sgmv_bf16_wgmma_launch(
                        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), i.data_ptr(),
                        y.data_ptr(), scratch.data_ptr(), scratch.numel(), counters.data_ptr(),
                        counters.numel(), B * S, S, d_in, d_out, r, a.shape[0], sms, 1.0,
                        stream) == 0

                launch()
                torch.cuda.synchronize()
                err = float((y.float() - want.float()).abs().max())
                atol = (cs.SGMV_TOL * float(want.float().abs().max())
                        + cs.BF16_SPLIT_REL * float(want32.abs().max()))
                keeps = (err <= cs.BF16_TOL * float(want.float().abs().max())
                         and cs.one_rounding_err(y, want32, atol) <= 0)
                line[case] = {"ms": cs.time_ms(launch)[0], "max_abs_err": err,
                              "keeps_bars": keeps, "plan": [sp, skper, bp, bkper]}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
