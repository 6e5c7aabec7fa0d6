"""Time the MoE combine's k - 1 adds against one sum over k, in decode.

    python3 scripts/moe_combine_ab.py [--layers 8] [--rounds 4] [--steps 16]

on one NVIDIA GPU. deepseek-v2-lite-16b (64 experts, top 6, two shared) at
full width and ``--layers`` layers, in f32 and then in bf16, weights drawn
on the card from seed 0: B = 8 prompts of 256 tokens, 8 LoRA slots with a
row of id -1, then windows of ``--steps`` greedy ``decode`` steps, each
from the same prefilled cache. Side A is ``models.ffn.add_choices`` as the
package has it (a token's k choices added one at a time, k - 1 launches);
side B replaces it with one ``gk.sum(1)``. Each round runs A, B, B, A after
a warm-up of each. The card's name and power limit come first, then one
JSON line per dtype: every window's ms a step for each side, the medians,
B / A, and whether both sides chose the same tokens (bf16 may not: one sum
rounds once, the adds round k - 1 times). Each line also holds the two
combines alone at a decode step's shape, (8, 6, 2048), timed by
``chip_smoke.time_ms``: device and host (enqueue) ms a call of each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import build_model, ffn  # noqa: E402

B, PROMPT = 8, 256


def one_sum(gk):
    return gk.sum(1)


def window(model, params, lora, cache, start, tok, ids, steps):
    """ms a step of ``steps`` greedy decode steps from ``cache`` with its
    rows at lengths ``start`` (a decode writes the cache in place), and
    the tokens chosen."""
    cache["len"] = start.clone()
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = model.decode(params, cache, tok[:, None], lora=lora, adapter_ids=ids)
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, torch.stack(out, 1).cpu()


def run(dtype, layers: int, rounds: int, steps: int, dev="cuda") -> dict:
    cfg = dataclasses.replace(configs.get("deepseek-v2-lite-16b"), num_layers=layers)
    dev = torch.device(dev)
    model = build_model(cfg, dtype=dtype, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    lora = cs.random_lora(model, 8, 1)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen)
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 6][:B - 1] + [-1], dtype=torch.int32)
    max_len = -(-(PROMPT + steps) // 128) * 128
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens, max_len, lora=lora, adapter_ids=ids)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        start = cache["len"].clone()
        sides = {"A": ffn.add_choices, "B": one_sum}
        ms, toks = {"A": [], "B": []}, {}
        try:
            for side in ("A", "B"):  # warm-up
                ffn.add_choices = sides[side]
                toks[side] = window(model, params, lora, cache, start, tok, ids, steps)[1]
            for _ in range(rounds):
                for side in ("A", "B", "B", "A"):
                    ffn.add_choices = sides[side]
                    ms[side].append(window(model, params, lora, cache, start, tok, ids, steps)[0])
        finally:
            ffn.add_choices = sides["A"]
    gk = torch.randn((B, cfg.moe.top_k, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev).to(dtype)
    alone = {side: cs.time_ms(lambda f=f: f(gk), iters=200) if dev.type == "cuda" else None
             for side, f in (("A", sides["A"]), ("B", one_sum))}
    med = {s: statistics.median(v) for s, v in ms.items()}
    return {"arch": cfg.name, "layers": layers, "top_k": cfg.moe.top_k,
            "dtype": str(dtype).replace("torch.", ""), "batch": B, "context": PROMPT,
            "steps_a_window": steps, "ms_per_step": ms, "median_ms_per_step": med,
            "b_over_a": med["B"] / med["A"],
            "combine_alone_device_host_ms": alone,
            "same_tokens": bool(torch.equal(toks["A"], toks["B"]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build.build_all()
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(dtype, args.layers, args.rounds, args.steps)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
