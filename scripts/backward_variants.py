"""Time variants of the two backward kernels on one NVIDIA GPU.

    python3 scripts/backward_variants.py [--only NAME ...]

Each line says what one design choice of ``flash_prefill_bwd.cu`` or
``lora_grad.cu`` is worth on this card. A plan variant runs the kernels as
built under another plan (the wrappers' ``flash_prefill.bwd_plan`` and
``sgmv.lora_grad_plan`` decide the splits and pass them to the kernels):

- "separate_dq": dQ in a pass of its own (7 products), where the plan
  folds it into the dK/dV blocks as per-kv-tile partials summed in order
  (5 products and a pass over the partials);
- "fold_always": dQ folded whatever the partials take (the plan's budget,
  ``flash_prefill.DQ_FOLD_FLOATS``, sends the long case to the separate
  pass);
- "shrink_no_split": lora_grad's shrink without its split of d (one block
  a token tile);
- "outer_no_seq_split": its outer products without the split of the
  sequence.

A source variant is a copy of ``src/repro_torch/kernels/csrc`` with a text
edit, built with the flags of ``kernels/build.py`` into a temporary
directory; its library stands in for the built one behind the wrappers.
Its edit pins the source text it replaces (the script stops if the text is
gone): "outer_without_dx" leaves dx out of lora_grad's dA blocks (the dx it
returns is wrong: a measure of what dx costs).

Cases, with ``chip_smoke.py``'s inputs: flash_prefill_bwd at qwen3-0.6b's
B = 8, S = 512 and B = 1, S = 4096 (16/8 heads of 128); lora_grad on
qwen3-0.6b's q projection (1024 -> 2048, B = 8, S = 512) at ranks 1, 32
and 128. Each prints its device ms (CUDA events, ``chip_smoke.time_ms``),
the device ms of each CUDA kernel of the call (``torch.profiler``) and its
largest error against the plain version over the largest plain magnitude.
"as built" runs first and last, to show the drift of the card. Needs a
card and nvcc; prints the card's ``nvidia-smi`` name and power limit
first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

flash_mod = importlib.import_module("repro_torch.kernels.flash_prefill")
sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")


def _lora_plan_without(split: str):
    """sgmv.lora_grad_plan with one of its splits taken away ("shrink":
    no parts of d; "outer": no parts of the sequence), the scratch sized
    to match."""
    plan = sgmv_mod.lora_grad_plan

    def without(B, S, N, d_in, d_out, r, sms):
        r8, kh, kg, ms, _ = plan(B, S, N, d_in, d_out, r, sms)
        if split == "shrink":
            kh, kg = (1, -(-d_in // 32) * 32), (1, -(-d_out // 32) * 32)
        else:
            ms = (1, S)
        floats = sum(sgmv_mod._lora_grad_layout(B * S, N, d_in, d_out, r, r8, kh[0],
                                                kg[0], ms[0]))
        return r8, kh, kg, ms, floats

    return without


# name -> (source edits [(file, text, replacement), ...], plan patches
# [(module, attribute, value), ...])
VARIANTS = {
    "as built": ([], []),
    "separate_dq": ([], [(flash_mod, "DQ_FOLD_FLOATS", -1)]),
    "fold_always": ([], [(flash_mod, "DQ_FOLD_FLOATS", 1 << 62)]),
    "shrink_no_split": ([], [(sgmv_mod, "lora_grad_plan", _lora_plan_without("shrink"))]),
    "outer_no_seq_split": ([], [(sgmv_mod, "lora_grad_plan", _lora_plan_without("outer"))]),
    "outer_without_dx": ([("lora_grad.cu", "  const bool do_dx = is_a && p.dx != nullptr;",
                           "  const bool do_dx = false;")], []),
}


@contextlib.contextmanager
def patched(patches):
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in old:
            setattr(mod, name, value)


def build_variants(tmp: Path, variants: dict) -> dict[str, dict[str, Path]]:
    """source variant -> source -> library, all compiled in parallel: each
    is a copy of ``csrc`` with its edits and builds the sources it edits."""
    nvcc, procs, libs = build.nvcc_path(), [], {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        if not edits:
            continue
        src = tmp / f"v{i}"
        shutil.copytree(build.CSRC, src)
        for file, old, new in edits:
            path = src / file
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: text not found in {file}")
            path.write_text(text.replace(old, new))
        edited = {f[:-3] for f, _, _ in edits}
        libs[name] = {}
        for source in sorted(edited):
            out = src / f"lib{source}.so"
            libs[name][source] = out
            procs.append((name, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return libs


def use(source: str, path: Path | None, built: dict) -> None:
    """Put the library at ``path`` (None: the one built from the package,
    ``built[source]``) behind the wrappers of ``source``."""
    if path is None:
        build._libs[source] = built[source]
        return
    lib = ctypes.CDLL(str(path))
    lib[f"{source}_error_string"].restype = ctypes.c_char_p
    lib[f"{source}_error_string"].argtypes = [ctypes.c_int]
    build._libs[source] = lib


def kernel_ms(fn, n: int = 10) -> dict[str, float]:
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
            k = m.group(0) if m else e.name[:40]
            out[k] = out.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", help="variants to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("backward_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    variants = {k: v for k, v in VARIANTS.items()
                if not args.only or k in args.only or k == "as built"}
    flash_cases = {}
    for B, S in ((8, 512), (1, 4096)):
        H, Hkv, D = 16, 8, 128
        q, k, v, do = (torch.randn(s, generator=gen, device=dev).transpose(1, 2)
                       for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))
        out, lse = ops.flash_prefill_fwd(q, k, v)
        want = ref.flash_prefill_bwd_ref(q, k, v, out, lse, do)
        flash_cases[f"flash_prefill_bwd qwen3 B={B}, S={S}"] = (q, k, v, out, lse, do, want)
    torch.cuda.empty_cache()
    B, S = 8, 512
    lora = {}
    for r in (1, 32, 128):
        x = torch.randn((B, S, 1024), generator=gen, device=dev)
        dy = torch.randn((B, S, 2048), generator=gen, device=dev)
        a = torch.randn((5, 1024, r), generator=gen, device=dev) * 1024 ** -0.5
        b = torch.randn((5, r, 2048), generator=gen, device=dev) * 0.1
        ids = torch.tensor([-1, 0, 1, 2, 3, 0, 1, 2], dtype=torch.int32, device=dev)
        delta, da_w, db_w = ref.lora_grad_ref(x, dy, a, b, ids, 2.0)
        lora[r] = (x, dy, a, b, ids, delta, da_w, db_w)
    built = {source: build.load(source, {}) for source in ("flash_prefill_bwd", "lora_grad")}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), variants)
        for name in [*variants, "as built"]:
            edits, patches = variants[name]
            # the kernels a variant changes: its edited sources, or its
            # patched plans' kernels, or (as built) both
            runs = ({f[:-3] for f, _, _ in edits}
                    | {"flash_prefill_bwd" if m is flash_mod else "lora_grad"
                       for m, _, _ in patches}) or {"flash_prefill_bwd", "lora_grad"}
            line = {"variant": name}
            for source in runs:
                use(source, libs.get(name, {}).get(source), built)
            with patched(patches):
                if "flash_prefill_bwd" in runs:
                    for case, (q, k, v, out, lse, do, want) in flash_cases.items():
                        def flash():
                            return ops.flash_prefill_bwd(q, k, v, out, lse, do)

                        got = flash()
                        torch.cuda.synchronize()
                        line[case] = {
                            "ms": cs.time_ms(flash, iters=10)[0], "kernels": kernel_ms(flash),
                            "rel_err": max(float((g - w).abs().max() / w.abs().max())
                                           for g, w in zip(got, want))}
                        del got
                if "lora_grad" in runs:
                    for r, (x, dy, a, b, ids, delta, da_w, db_w) in lora.items():
                        dx = torch.zeros_like(x)
                        da, db = ops.lora_grad(x, dy, a, b, ids, 2.0, dx)
                        torch.cuda.synchronize()
                        err = max(float((g - w).abs().max() / w.abs().max())
                                  for g, w in ((da, da_w), (db, db_w), (dx, delta)))
                        call = lambda: ops.lora_grad(x, dy, a, b, ids, 2.0, dx)  # noqa: E731
                        line[f"lora_grad q r={r}"] = {"ms": cs.time_ms(call)[0],
                                                      "kernels": kernel_ms(call), "rel_err": err}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
