"""Train LoRA adapters on a frozen base model with the PyTorch port: the
reduced config, LoRA-only AdamW, asynchronous checkpoints and resume from
the latest one (the port's counterpart of ``examples/train_lora.py``).

    PYTHONPATH=src python examples/train_lora_torch.py [--steps 200] \
        [--arch gemma-2b] [--device cpu]

It trains on the card by default; ``--device cpu`` runs the kernels' plain
versions. Batches come from a ``torch.Generator`` seeded by the step, with
the reference example's rule: each adapter's labels are
``(tokens·31 + id·7 + 1) % vocab``, so LoRA-only training has a signal.
"""

import argparse
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.distributed import CheckpointManager
from repro_torch.models import build_model, make_train_state, make_train_step

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / "repro_torch_train" / "lora"


def synthetic_batch(step: int, vocab: int, batch: int, seq: int, n_adapters: int,
                    device) -> dict:
    """Deterministic per-adapter label streams: each adapter's 'task'
    biases its labels."""
    gen = torch.Generator().manual_seed(step)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen)
    adapter_ids = torch.randint(0, n_adapters, (batch,), generator=gen)
    labels = (tokens * 31 + adapter_ids[:, None] * 7 + 1) % vocab
    return {"tokens": tokens.to(device), "labels": labels.to(device),
            "adapter_ids": adapter_ids.to(device, torch.int32)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = configs.reduced(configs.get(args.arch))
    model = build_model(cfg, dtype=torch.float32, device=dev)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             n_lora_slots=4, train_lora_only=True)
    step_fn = make_train_step(model, lr=3e-3, train_lora_only=True)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, state)
        start = latest
        print(f"resumed from checkpoint step {latest}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic_batch(step, cfg.vocab_size, args.batch, args.seq, 4, dev)
        state, metrics = step_fn(state, batch)
        if (step + 1) % 20 == 0:
            print(f"step {step + 1:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (step - start + 1) * 1e3:.0f} ms/step)")
        if (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, state)
    mgr.wait()
    print(f"done; adapters trained LoRA-only (base frozen), checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
