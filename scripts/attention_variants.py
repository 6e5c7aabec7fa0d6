"""Time edited variants of the attention tile loop on one NVIDIA GPU.

    python3 scripts/attention_variants.py

Each variant is the CUDA source of ``src/repro_torch/kernels/csrc`` with one
edit (a text substitution in a copy, built with the flags of
``kernels/build.py`` into a temporary directory), so each line says what
one design choice of ``attention_tc.cuh`` or ``ragged_extend.cu`` is worth
on this card. ``flash_prefill`` runs at the generate path's shape (B=8,
S=2016, 16/8 heads, D=128) and ``ragged_extend`` at ``chip_smoke.py``'s
three engine buckets; each prints its device ms (CUDA events, the timer
of ``chip_smoke.py``) and its largest error against the plain version. The
variant "as built" runs first and last, to show the drift of the card.
Needs a card and nvcc; prints the card's ``nvidia-smi`` name and power
limit first.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.flash_prefill import _SIGNATURES as FLASH_SIG  # noqa: E402
from repro_torch.kernels.ragged_extend import _SIGNATURES as RAGGED_SIG  # noqa: E402

# name -> [(file, text, replacement), ...]; each text must occur in its file
VARIANTS = {
    "as built": [],
    # one TF32 product (hi·hi) in place of three: breaks the tolerance
    "one_tf32_product": [("tf32x3.cuh",
                          "  mma_tf32(d, alo, bhi);  // the small products first\n"
                          "  mma_tf32(d, ahi, blo);\n", "")],
    # scores divided by √D rather than multiplied by 1/√D
    "divide_scores": [("attention_tc.cuh", "sc[n][i] * scale",
                       "sc[n][i] / sqrtf((float)D)")],
    # KV parts of about 2 tiles, up to 16 a q tile
    "finer_kv_split": [("ragged_extend.cu",
                        "constexpr int MAX_SPLIT = 8;       // KV parts of one q tile, at most\n"
                        "constexpr int PART_TILES = 4;",
                        "constexpr int MAX_SPLIT = 16;\nconstexpr int PART_TILES = 2;")],
}


def build_variants(tmp: Path, variants: dict, sources: tuple[str, ...],
                   flags: tuple[str, ...] = (), logs: dict | None = None
                   ) -> dict[str, dict[str, Path]]:
    """variant -> source -> library, all compiled in parallel: each variant
    is a copy of ``csrc`` with its edits. ``flags`` go to nvcc after
    ``build.NVCC_FLAGS``; ``logs``, where given, receives nvcc's output per
    (variant, source)."""
    nvcc, procs, libs = build.nvcc_path(), [], {}
    for i, (name, edits) in enumerate(variants.items()):
        src = tmp / f"v{i}"
        shutil.copytree(build.CSRC, src)
        for file, old, new in edits:
            path = src / file
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: text not found in {file}")
            path.write_text(text.replace(old, new))
        libs[name] = {}
        for source in sources:
            out = src / f"lib{source}.so"
            libs[name][source] = out
            procs.append(((name, source), subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, *flags, "-o", str(out), str(src / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for key, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{log}")
        if logs is not None:
            logs[key] = log
    return libs


def load(path: Path, signatures: dict[str, str]):
    lib = ctypes.CDLL(str(path))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64,
             "f": ctypes.c_float}
    for fname, sig in signatures.items():
        fn = getattr(lib, fname)
        fn.argtypes = [kinds[a] for a in sig]
        fn.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    B, H, Hkv, D, S, T = 8, 16, 8, 128, 2016, 2048
    fq, fk, fv = (torch.randn((B, h, S, D), generator=gen, device=dev)
                  for h in (H, Hkv, Hkv))
    f_want = ref.flash_prefill_ref(fq, fk, fv)
    ragged = {}
    for s in (256, 64, 8):
        lens, starts = cs.RAGGED_BUCKETS[s]
        q = torch.randn((B, s, H, D), generator=gen, device=dev)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev) for _ in "kv")
        st, tl = (torch.tensor(a, dtype=torch.int32, device=dev) for a in (starts, lens))
        ragged[s] = (q, k, v, st, tl, ref.ragged_extend_ref(q, k, v, st, tl))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), VARIANTS, ("flash_prefill", "ragged_extend"))
        for name in [*VARIANTS, "as built"]:
            lib = load(libs[name]["flash_prefill"], FLASH_SIG)
            out = torch.empty_like(fq)

            def flash():
                assert lib.flash_prefill_launch(
                    fq.data_ptr(), fk.data_ptr(), fv.data_ptr(), None, out.data_ptr(),
                    B, S, H, Hkv, D, *fq.stride()[:3], *fk.stride()[:3],
                    *fv.stride()[:3], stream) == 0

            flash()
            torch.cuda.synchronize()
            line = {"variant": name, "flash_prefill": {
                "ms": cs.time_ms(flash, iters=10)[0],
                "max_abs_err": float((out - f_want).abs().max())}}
            rlib = load(libs[name]["ragged_extend"], RAGGED_SIG)
            for s, (q, k, v, st, tl, want) in ragged.items():
                parts = rlib.ragged_extend_kv_parts(B, s, T, H, Hkv, D)
                scratch = torch.empty((max(1, parts * B * s * H * (D + 2)),), device=dev)
                rout = torch.empty_like(q)

                def rag():
                    assert rlib.ragged_extend_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), st.data_ptr(),
                        tl.data_ptr(), rout.data_ptr(), scratch.data_ptr(), None,
                        B, s, T, H, Hkv, D, stream) == 0

                rag()
                torch.cuda.synchronize()
                line[f"ragged_extend S={s}"] = {
                    "kv_parts": parts, "ms": cs.time_ms(rag)[0],
                    "max_abs_err": float((rout - want).abs().max())}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
