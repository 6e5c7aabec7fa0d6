"""f32's own spread in one train step of a chip_smoke.py phase 11 family,
on one card: the seed-0 state and ``family_batch``'s first batch of a
``FAMILY_RUNS`` config (full width, its depth cut), one step of
``make_train_step`` on the card with the CUDA kernels, the same step with
``fused_sgmv`` replaced by its plain PyTorch version (on the card), the
same step in float64 on the host, and the step through
``make_sharded_train_step`` on a (1, 2) mesh of two gloo ranks on the card.
Prints the card's name and power limit, then one JSON line: each run's loss
and grad_norm, and a row a leaf of the AdamW first moments (the clipped
gradients) of the card runs against the float64 one.

    python3 scripts/family_precision.py [--arch rwkv6-1.6b]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def moments(state) -> dict:
    from repro_torch.tree import flatten_with_names

    return {n: t.detach().double().cpu().numpy() for n, t in flatten_with_names(state.opt.m)}


def sharded_rank(rank: int, world: int, cfg) -> dict:
    """One sharded step on this rank: its metrics, local moments and specs."""
    from repro_torch.distributed import batch_specs, build_mesh, make_shardings
    from repro_torch.distributed.elastic import ElasticPlan
    from repro_torch.distributed.sharded_step import make_sharded_train_step, train_state_specs
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models import build_model, make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = build_mesh(ElasticPlan(data=1, model=world, dropped_devices=0), "cuda")
    model = build_model(cfg, dtype=torch.float32, device=dev)
    full = make_train_state(model, torch.Generator(device=dev).manual_seed(0), n_lora_slots=4)
    shardings = make_shardings(train_state_specs(full, mesh), mesh)
    state = shard_tree(full, shardings)
    del full
    batch = chip_smoke.family_batch(cfg, 0, dev)
    new, met = make_sharded_train_step(model, shardings)(
        state, shard_tree(batch, make_shardings(batch_specs(batch, mesh), mesh)))
    return {"metrics": (float(met["loss"]), float(met["grad_norm"])), "m": moments(new),
            "specs": {n: s.spec for n, s in shardings.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b",
                    choices=[a for a, _, _ in chip_smoke.FAMILY_RUNS])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("family_precision: no CUDA device")
    from repro_torch import configs
    from repro_torch.distributed.runner import run_ranks
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import TrainState, build_model, make_train_state, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cut = {a: c for a, c, _ in chip_smoke.FAMILY_RUNS}[args.arch]
    cfg = chip_smoke.family_cfg(configs, args.arch, cut)
    dev = torch.device("cuda", 0)
    model = build_model(cfg, dtype=torch.float32, device=dev)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0), n_lora_slots=4)
    batch = chip_smoke.family_batch(cfg, 0, dev)
    out, runs = {"nvidia_smi": smi, "arch": args.arch, "cut": cut}, {}
    new, met = make_train_step(model)(state, batch)
    runs["card"] = (moments(new), (float(met["loss"]), float(met["grad_norm"])))
    del new
    kernel = ops.fused_sgmv
    ops.fused_sgmv = lambda x, w, a, b, ids, scale=1.0: ref.fused_sgmv_ref(x, w, a, b, ids, scale)
    try:
        new, met = make_train_step(model)(state, batch)
    finally:
        ops.fused_sgmv = kernel
    runs["card_plain_fused_sgmv"] = (moments(new), (float(met["loss"]), float(met["grad_norm"])))
    del new
    host = lambda t: t.detach().double().cpu()  # noqa: E731
    params, lora = tree_map(host, state.params), tree_map(host, state.lora)
    del state, model
    torch.cuda.empty_cache()
    torch.set_num_threads(8)
    state64 = TrainState(params=params, lora=lora, opt=adamw_init({"params": params,
                                                                    "lora": lora}),
                         step=torch.zeros((), dtype=torch.int32))
    batch64 = {k: host(v) if v.is_floating_point() else v.cpu() for k, v in batch.items()}
    new, met = make_train_step(build_model(cfg, dtype=torch.float64, device="cpu"))(
        state64, batch64)
    want = moments(new)
    out["f64_host"] = (float(met["loss"]), float(met["grad_norm"]))
    del new, state64
    ranks = run_ranks(sharded_rank, 2, chip_smoke.DIST_DIR / "precision_stores",
                      backend="gloo", args=(cfg,), timeout=600)
    whole = {}
    for n in want:
        spec = ranks[0]["specs"]["opt/m/" + n]
        dims = [d for d, e in enumerate(spec) if "model" in (e if isinstance(e, tuple) else (e,))]
        parts = [r["m"][n] for r in ranks]
        whole[n] = np.concatenate(parts, axis=dims[0]) if dims else parts[0]
    runs["sharded_1x2"] = (whole, ranks[0]["metrics"])
    rows = []
    for n, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        rows.append({"leaf": n, "max_abs_f64": float(scale),
                     **{f"{k}_rel_err": float(np.abs(m[n] - w).max() / scale)
                        for k, (m, _) in runs.items()}})
    out.update({k: met for k, (_, met) in runs.items()})
    out["leaves"] = sorted(rows, key=lambda r: -r["card_rel_err"])
    print(smi, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
