"""Time edited variants of the decode kernels on one NVIDIA GPU, cold L2.

    python3 scripts/decode_variants.py

Each variant is the CUDA source of ``src/repro_torch/kernels/csrc`` with its
edits (text substitutions in a copy, built with the flags of
``kernels/build.py`` into a temporary directory), so each line says what
one design choice of the skinny ``fused_sgmv`` or of ``paged_attention``
is worth on this card. Cases: ``fused_sgmv`` at qwen3-0.6b's q, k and o
decode projections (B=8, S=1, r=32), ``sgmv`` at q, and ``paged_attention``
at ``chip_smoke.py``'s two length sets, each timed as ``chip_smoke.py``
times the decode kernels with a cold L2, with its largest error against
the plain version. The variant "as built" runs first and last, to show the
drift of the card. Needs a card and nvcc; prints the card's
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
from repro_torch.kernels.paged_attention import _SIGNATURES as PAGED_SIG  # noqa: E402
from repro_torch.kernels.sgmv import _SIGNATURES as SGMV_SIG  # noqa: E402

SPLITS = "int splits = (2 * sm_count() + per_split - 1) / per_split;"
BOUNDS = "__launch_bounds__(THREADS, MT <= 8 ? 3 : 2)"
# name -> [(file, text, replacement), ...]; each text must occur in its file
VARIANTS = {
    "as built": [],
    # the skinny merge launches when pass 1 has finished, not as its blocks
    # start
    "no_early_dependents": [("tf32x3.cuh",
                             'asm volatile("griddepcontrol.launch_dependents;\\n" ::);', "")],
    # a 3-stage ring: a q or o block's fourth stage waits for its first
    "ring_of_3": [("fused_sgmv.cu", "constexpr int SK_STAGES = 4;",
                   "constexpr int SK_STAGES = 3;")],
    # k splits for about one W block an SM, not two
    "one_block_an_sm": [("fused_sgmv.cu", SPLITS,
                         "int splits = (sm_count() + per_split - 1) / per_split;")],
    # registers for two blocks an SM, not three
    "two_blocks_by_registers": [("fused_sgmv.cu", BOUNDS, "__launch_bounds__(THREADS, 2)")],
    # registers for four blocks an SM
    "four_blocks_by_registers": [("fused_sgmv.cu", BOUNDS,
                                  "__launch_bounds__(THREADS, MT <= 8 ? 4 : 2)")],
    # four blocks an SM and k splits for about three W blocks an SM
    "four_blocks_three_w_blocks": [
        ("fused_sgmv.cu", BOUNDS, "__launch_bounds__(THREADS, MT <= 8 ? 4 : 2)"),
        ("fused_sgmv.cu", SPLITS, "int splits = (3 * sm_count() + per_split - 1) / per_split;")],
    # paged_attention chunks of 32 tokens: twice the blocks, half the
    # shared memory each (six blocks an SM)
    "paged_chunks_of_32": [("paged_attention.cu", "constexpr int CT = 64;",
                            "constexpr int CT = 32;")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    B, N, r = 8, 8, 32
    ids = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 7], dtype=torch.int32, device=dev)
    sgmv_cases = {}
    for proj, d_in, d_out, base in (("q", 1024, 2048, True), ("k", 1024, 1024, True),
                                    ("o", 2048, 1024, True), ("sgmv q", 1024, 2048, False)):
        x = torch.randn((B, 1, d_in), generator=gen, device=dev)
        w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
        a = torch.randn((N, d_in, r), generator=gen, device=dev) * d_in ** -0.5
        b = torch.randn((N, r, d_out), generator=gen, device=dev) * 0.1
        want = (ref.fused_sgmv_ref(x, w, a, b, ids) if base else ref.sgmv_ref(x, a, b, ids))
        n = cs.cold_copies(4 * ((d_in * d_out if base else 0) + 7 * r * (d_in + d_out)))
        copies = [(w.clone(), a.clone(), b.clone()) for _ in range(n)]
        sgmv_cases[proj] = (x, copies, d_in, d_out, base, want)
    T, H, Hkv, D, ps = 2048, 16, 8, 128, 128
    pages = T // ps
    tables = torch.arange(B * pages, dtype=torch.int32, device=dev).view(B, pages)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    paged_cases = {}
    for key, lens in cs.PAGED_LENGTHS.items():
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(min(n, T) for n in lens)
        copies = [tuple(torch.randn((B * pages, ps, Hkv, D), generator=gen, device=dev)
                        for _ in range(2)) for _ in range(cs.cold_copies(8 * live * Hkv * D))]
        want = ref.paged_attention_ref(q, *copies[0], tables, ln)
        paged_cases[key] = (ln, copies, want)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), VARIANTS, ("fused_sgmv", "paged_attention"))
        for name in [*VARIANTS, "as built"]:
            line = {"variant": name}
            lib = load(libs[name]["fused_sgmv"], SGMV_SIG)
            for proj, (x, copies, d_in, d_out, base, want) in sgmv_cases.items():
                y = torch.empty((B, 1, d_out), device=dev)
                scratch = torch.empty(
                    (lib.fused_sgmv_scratch_floats(B, d_in, d_out, r, int(base)),), device=dev)

                def call(w, a, b, x=x, y=y, scratch=scratch, d_in=d_in, d_out=d_out,
                         base=base):
                    if base:
                        code = lib.fused_sgmv_launch(
                            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                            ids.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, 1, d_in,
                            d_out, r, 1.0, stream)
                    else:
                        code = lib.sgmv_launch(
                            x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
                            y.data_ptr(), scratch.data_ptr(), B, 1, d_in, d_out, r, 1.0,
                            stream)
                    assert code == 0

                call(*copies[0])
                torch.cuda.synchronize()
                err = float((y - want).abs().max())
                line[proj] = {
                    "cold_ms": cs.time_ms(cs.rotating(
                        [lambda c=c: call(*c) for c in copies]), iters=40)[0],
                    "max_abs_err": err}
            plib = load(libs[name]["paged_attention"], PAGED_SIG)
            for key, (ln, copies, want) in paged_cases.items():
                out = torch.empty_like(q)
                scratch = torch.empty(
                    (plib.paged_attention_scratch_floats(B, H, Hkv, D, ps, pages),), device=dev)

                def pcall(kp, vp, ln=ln, out=out, scratch=scratch):
                    assert plib.paged_attention_launch(
                        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
                        ln.data_ptr(), out.data_ptr(), None, scratch.data_ptr(), B, H, Hkv, D,
                        ps, pages, stream) == 0

                pcall(*copies[0])
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                line[f"paged {key}"] = {
                    "cold_ms": cs.time_ms(cs.rotating(
                        [lambda c=c: pcall(*c) for c in copies]), iters=40)[0],
                    "max_abs_err": err}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
