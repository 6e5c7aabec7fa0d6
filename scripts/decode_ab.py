"""Time the host-bound greedy decode of two checkouts against each other.

    python3 scripts/decode_ab.py A_DIR B_DIR [--pairs 10] [--steps 128]
    python3 scripts/decode_ab.py A_DIR B_DIR --rounds 3 [--steps 128]

on one NVIDIA GPU. A_DIR and B_DIR are checkouts of the repository (the
parent commit and the change, say). Both build their kernels first, in
parallel, each into its own ``build/``. A run of one checkout takes each of
qwen3-0.6b (the GQA cache), rwkv6-1.6b (the recurrent state) and
seamless-m4t-large-v2 (the encoder-decoder) at full width in f32, with
weights drawn on the card from a seed: it prefills B = 8 prompts of 64
tokens (seamless: 64 source frames) with four LoRA slots and one base row,
then times ``--steps`` greedy ``decode`` steps. At B = 8 a decode step is
bound by the host's launches, so its wall time per step is the host's cost
of the model's Python loop.

By default one process imports A's ``src/repro_torch`` as ``repro_torch``
and B's as ``repro_torch_b`` (the model and kernel modules import each
other relatively), so both share one CUDA context, one host state and the
same weights; ``--pairs`` pairs run A then B, or B then A, in turn, after
a warm-up run of each. It prints one JSON line per arch: each side's ms per
step of every run, their medians and quartiles, B / A of the medians, the
pairs B won, and whether both generated the same tokens (they must).

With ``--rounds`` each run is a process of its own instead, in the order
A, B, B, A per round, three timed runs an arch a process; it prints one
JSON line per process and a summary line of the same medians, quartiles
and token check. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCHS = ("qwen3-0.6b", "rwkv6-1.6b", "seamless-m4t-large-v2")
B, PROMPT = 8, 64


def import_as(name: str, root: Path):
    """The package ``src/repro_torch`` of the checkout at ``root``,
    imported under ``name``, with its models and configs."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("models", "configs"):
        importlib.import_module(f"{name}.{sub}")
    return mod


def setup(arch: str, pkgs: dict, steps: int):
    """The models of ``arch`` (one per package, sharing the weights) and a
    function that runs one of them: model -> (ms per decode step, tokens)."""
    import torch

    dev = torch.device("cuda")
    ids = torch.tensor([0, 1, 2, 3, 0, 1, 2, -1], dtype=torch.int32)
    models = {w: p.models.build_model(p.configs.get(arch), dtype=torch.float32, device=dev)
              for w, p in pkgs.items()}
    first = next(iter(models.values()))
    cfg = first.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params, lora = first.init_params(gen), first.init_lora(gen, 4)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                           device=dev).cpu()
    pre = ((torch.randn((B, PROMPT, cfg.d_model), generator=gen, device=dev), prompt)
           if cfg.is_encdec else (prompt,))

    def run(model):
        with torch.no_grad():
            logits, cache = model.prefill(params, *pre, PROMPT + steps + 1, lora=lora,
                                          adapter_ids=ids)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            toks = [tok]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = model.decode(params, cache, tok[:, None], lora=lora,
                                             adapter_ids=ids)
                tok = logits[:, -1].argmax(-1).to(torch.int32)
                toks.append(tok)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
        return ms, torch.stack(toks, 1).cpu()

    return models, run


def checksum(toks) -> int:
    import torch

    return int((toks.long() * torch.arange(1, toks.numel() + 1).view(toks.shape)).sum())


def stats(ms: dict) -> dict:
    q = {w: statistics.quantiles(ms[w], n=4) for w in "AB"}
    return {"a_median": q["A"][1], "b_median": q["B"][1],
            "b_over_a": q["B"][1] / q["A"][1],
            "a_quartiles": [q["A"][0], q["A"][2]], "b_quartiles": [q["B"][0], q["B"][2]]}


def pairs(dirs: dict, n_pairs: int, steps: int) -> bool:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    pkgs = {"A": import_as("repro_torch", dirs["A"]),
            "B": import_as("repro_torch_b", dirs["B"])}
    ok = True
    for arch in ARCHS:
        models, run = setup(arch, pkgs, steps)
        toks = {w: run(models[w])[1] for w in "AB"}  # warm-up
        ms, wins = {"A": [], "B": []}, 0
        for i in range(n_pairs):
            pair = {}
            for w in ("AB" if i % 2 == 0 else "BA"):
                pair[w], t = run(models[w])
                ms[w].append(pair[w])
                ok &= torch.equal(t, toks[w])
            wins += pair["B"] < pair["A"]
        same = torch.equal(toks["A"], toks["B"])
        ok &= same
        print(json.dumps({"arch": arch, "steps": steps, "ms_a": ms["A"], "ms_b": ms["B"],
                          **stats(ms), "pairs": n_pairs, "b_wins": wins,
                          "tokens_equal": same}), flush=True)
        del models, run
        torch.cuda.empty_cache()
    return ok


def turn(root: Path, steps: int) -> dict:
    """One process's run of the checkout at ``root``: three timed runs an arch."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    pkgs = {"A": import_as("repro_torch", root)}
    out = {"ms_per_step": {}, "tokens": {}}
    for arch in ARCHS:
        models, run = setup(arch, pkgs, steps)
        run(models["A"])  # warm-up: the kernels' first launches
        res = [run(models["A"]) for _ in range(3)]
        out["ms_per_step"][arch] = [ms for ms, _ in res]
        out["tokens"][arch] = checksum(res[-1][1])
        del models, run
        torch.cuda.empty_cache()
    return out


def rounds(dirs: dict, n_rounds: int, steps: int) -> bool:
    runs = {"A": [], "B": []}
    for i, who in enumerate("ABBA" * n_rounds):
        res = subprocess.run([sys.executable, __file__, str(dirs[who]), str(dirs[who]),
                              "--turn", "--steps", str(steps)], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"decode_ab: turn {i} ({who}) failed:\n{res.stderr[-3000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        runs[who].append(line)
        print(json.dumps({"turn": i, "who": who, "dir": str(dirs[who]), **line}), flush=True)
    summary = {}
    for arch in ARCHS:
        ms = {w: [t for r in runs[w] for t in r["ms_per_step"][arch]] for w in "AB"}
        summary[arch] = {**stats(ms), "tokens_equal": len(
            {r["tokens"][arch] for w in "AB" for r in runs[w]}) == 1}
    print(json.dumps({"summary": summary}), flush=True)
    return all(s["tokens_equal"] for s in summary.values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=0, help="> 0: a process per run")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--turn", action="store_true", help="(internal) one run of A")
    args = ap.parse_args()
    dirs = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    if args.turn:
        print(json.dumps(turn(dirs["A"], args.steps)), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; print(build.build_all())",
         str(d / "src")]) for d in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("decode_ab: a kernel build failed")
    ok = (rounds(dirs, args.rounds, args.steps) if args.rounds
          else pairs(dirs, args.pairs, args.steps))
    if not ok:
        raise SystemExit("decode_ab: the checkouts generated different tokens")


if __name__ == "__main__":
    main()
