"""Time edited variants of the bf16 wgmma flash loop on one NVIDIA GPU.

    python3 scripts/flash_wgmma_variants.py

Each variant is the CUDA source of ``src/repro_torch/kernels/csrc`` with
edits to ``attention_wgmma.cuh`` (text substitutions in a copy, built with
the flags of ``kernels/build.py``, as ``scripts/attention_variants.py``
builds its variants), so each line says what one design choice of that
loop is worth on this card:

- ``keys_128``: K/V tiles of 128 keys in place of 64 (D <= 128 only: the
  ring of a wider head does not fit the shared memory);
- ``three_stages``: a 3-stage ring where it fits (D <= 192);
- ``producer_warp``: 9 warps (two consumer warpgroups and one producer
  warp) without ``setmaxnreg``, so every thread keeps 224 registers.

Each variant runs bf16 ``flash_prefill`` at qwen3-0.6b's 8 x 2016,
``flash_prefill_ragged`` at chip_smoke's ragged lengths, and
``flash_prefill`` at stablelm-12b's (D = 160) and gemma-2b's (D = 256)
2 x 2048, and prints per case its device ms (CUDA events, the timer of
``chip_smoke.py``), its largest error against the plain bf16 version and
whether it keeps chip_smoke's bars. "as built" runs first and last, to show
the drift of the card. Needs a card and nvcc; prints the card's
``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

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
from repro_torch.kernels.flash_prefill import _SIGNATURES as FLASH_SIG  # noqa: E402


def ss_wrapper(n: int) -> str:
    """attention_wgmma.cuh's wgmma_ss for an m64n{n}k16 product (the loop
    as built needs n = 64 only)."""
    regs = n // 2
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    lst = ", ".join(f"%{i}" for i in range(regs))
    return (f"__device__ __forceinline__ void wgmma_ss(float (&d)[{regs}], uint64_t da, "
            f"uint64_t db, int acc) {{\n  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{lst}}}, '
            f'%{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(da), "l"(db), "r"(acc));\n}}\n\n')


H = "attention_wgmma.cuh"
RS64 = "// d += A·B, m64n64k16; A from registers, B from shared memory MN-major\n"
# name -> [(file, text, replacement), ...]; each text must occur in its file
VARIANTS = {
    "as built": [],
    "keys_128": [(H, "constexpr int BK = 64;     // keys of a K/V tile",
                  "constexpr int BK = 128;"),
                 (H, RS64, ss_wrapper(128) + RS64)],
    "three_stages": [(H, "constexpr int STAGES = 2;  // of the K/V ring",
                      "constexpr int STAGES = 3;")],
    "producer_warp": [
        (H, "constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup first",
         "constexpr int THREADS = 128 * CONSUMERS + 32;"),
        (H, "  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues the loads\n"
            "    setmaxnreg_dec<PRODUCER_REGS>();\n    if (threadIdx.x == 0) {",
         "  if (threadIdx.x >= 128 * CONSUMERS) {\n    if (threadIdx.x == 128 * CONSUMERS) {"),
        (H, "  setmaxnreg_inc<CONSUMER_REGS>();\n\n  const int c = threadIdx.x / 128 - 1;",
         "  const int c = threadIdx.x / 128;"),
        (H, "for (int e = threadIdx.x - 128; e < (z1 - z0) * DC * 8;",
         "for (int e = threadIdx.x; e < (z1 - z0) * DC * 8;"),
    ],
}
RAGGED = [0, 1, 37, 1000, 2015, 2016, 2016, 2016]
# case -> (B, S, H, Hkv, D, true_lens)
CASES = {
    "qwen3-0.6b 8 x 2016": (8, 2016, 16, 8, 128, None),
    "qwen3-0.6b ragged": (8, 2016, 16, 8, 128, RAGGED),
    "stablelm-12b 2 x 2048": (2, 2048, 32, 8, 160, None),
    "gemma-2b 2 x 2048": (2, 2048, 8, 1, 256, None),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_wgmma_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {}
    for case, (B, S, Hq, Hkv, D, lens) in CASES.items():
        q, k, v = (torch.randn((B, h, S, D), generator=gen, device=dev).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        tl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        plain = ((lambda *t: ref.flash_prefill_ref(*t)) if tl is None
                 else (lambda *t: ref.flash_prefill_ragged_ref(*t, tl)))
        inputs[case] = (q, k, v, tl, plain(q, k, v), plain(q.float(), k.float(), v.float()))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), VARIANTS, ("flash_prefill",))
        for name in [*VARIANTS, "as built"]:
            lib = load(libs[name]["flash_prefill"], FLASH_SIG)
            line = {"variant": name}
            for case, (q, k, v, tl, want, want32) in inputs.items():
                B, Hq, S, D = q.shape
                if (name == "keys_128" and D > 128) or (name == "three_stages" and D > 192):
                    continue
                out = torch.empty_like(q)

                def flash():
                    assert lib.flash_prefill_bf16_wgmma_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        None if tl is None else tl.data_ptr(), out.data_ptr(), None,
                        B, S, Hq, k.shape[1], D, *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], stream) == 0

                flash()
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                atol = cs.ATTN_TOL + cs.BF16_SPLIT_REL * float(want32.abs().max())
                keeps = (err <= cs.BF16_TOL * float(want.float().abs().max())
                         and cs.one_rounding_err(out, want32, atol) <= 0)
                line[case] = {"ms": cs.time_ms(flash)[0], "max_abs_err": err,
                              "keeps_bars": keeps}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
