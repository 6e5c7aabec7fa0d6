"""Training launcher (PyTorch counterpart of ``repro.launch.train``): the
train step on one card, with asynchronous checkpoints and resume from the
latest one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 20 --batch 8 --seq 64 [--full-config] [--device cpu]

It trains on the card by default (the CUDA kernels and their backward
kernels); ``--device cpu`` runs their plain versions. Without
``--full-config`` it trains the reduced config. One device and no mesh:
the reference's elastic mesh, sharding and ``--compress`` (int8 gradient
compression on the data-parallel all-reduce) are ROADMAP Queue 1 item 7,
and ``--compress`` is refused. Batches are drawn from a ``torch.Generator``
seeded by the step, so their numbers differ from the reference's
``jax.random`` batches; as there, the labels equal the tokens (one key
draws both) and every row trains adapter slot 0.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.distributed import CheckpointManager
from repro_torch.models import build_model, make_train_state, make_train_step

DEFAULT_CKPT = (Path(__file__).resolve().parents[3] / "build" / "repro_torch_train"
                / "ckpt")


def make_batch(cfg, step: int, batch: int, seq: int, device) -> dict:
    """The step's batch from a generator seeded by ``step``."""
    gen = torch.Generator().manual_seed(step)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    out = {"tokens": tokens.to(device), "labels": tokens.clone().to(device),
           "adapter_ids": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, seq // 4, cfg.d_model), generator=gen).to(device)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Batches come from a torch.Generator seeded by the step: the numbers "
               "differ from the reference launcher's jax.random batches.")
    ap.add_argument("--arch", default="gemma-2b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress", action="store_true",
                    help="refused: int8 gradient compression on the data-parallel "
                         "all-reduce needs the multi-device port (ROADMAP Queue 1 item 7)")
    args = ap.parse_args()
    if args.compress:
        ap.error("--compress (int8 gradient compression on the data-parallel all-reduce) "
                 "needs the multi-device port: ROADMAP Queue 1 item 7")

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if not args.full_config:
        cfg = configs.reduced(cfg)
    model = build_model(cfg, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(model, gen, n_lora_slots=4)
    step_fn = make_train_step(model, lr=args.lr)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, state)
        start = latest
        print(f"resumed from step {latest}")

    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, make_batch(cfg, step, args.batch, args.seq, dev))
        if (step + 1) % 10 == 0:
            dt = (time.time() - t0) / (step - start + 1)
            print(f"step {step + 1:4d} loss={float(metrics['loss']):.4f} "
                  f"({dt * 1e3:.0f} ms/step)")
        if (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, state)
    mgr.wait()
    print("training done")


if __name__ == "__main__":
    main()
