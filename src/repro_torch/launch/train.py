"""Training launcher (PyTorch counterpart of ``repro.launch.train``): the
train step sharded over an elastic ("data", "model") mesh of every rank the
job has, with checkpoints and a restart that re-shards onto the current
mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 20 --batch 8 --seq 64 [--full-config] [--device cpu] [--compress]
    PYTHONPATH=src torchrun --nproc-per-node=N -m repro_torch.launch.train ...

World size and rank come from ``torchrun``'s environment; without it the
launcher runs one rank. It trains on the cards by default (NCCL, one card
a rank, the CUDA kernels and their backward kernels); ``--device cpu``
runs the kernels' plain versions over gloo. Without ``--full-config`` it
trains the reduced config. As the reference's: the mesh is
``plan_mesh(world, preferred_model=min(4, heads))`` for every family
(tensor and expert parallelism over ``model``, see ``sharded_step``), the
state is placed by ``param_specs`` / ``moment_specs`` without ``cfg``, and the
latest checkpoint (whole leaves, the reference's format, written by rank
0) is restored onto the current mesh, so a restart on fewer ranks resumes.
``--compress`` builds the int8 error-feedback state and reports it, and,
as in the reference, the step does not use it (ROADMAP Queue 3). Batches
are drawn from a ``torch.Generator`` seeded by the step, so their numbers
differ from the reference's ``jax.random`` batches; as there, the labels
equal the tokens (one key draws both) and every row trains adapter slot 0.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.distributed import (CheckpointManager, batch_specs, build_mesh,
                                     init_state as compression_init, make_shardings,
                                     plan_mesh)
from repro_torch.distributed.runner import single_rank
from repro_torch.distributed.sharded_step import make_sharded_train_step, train_state_specs
from repro_torch.distributed.sharding import gather_tree, shard_tree
from repro_torch.models import build_model, make_train_state

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


def parse_args(argv=None) -> argparse.Namespace:
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
                    help="int8 gradient compression on the data-parallel all-reduce "
                         "(its state is built; as in the reference, the step does not "
                         "use it)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> None:
    """The training run of this rank, in the default process group."""
    rank, world = dist.get_rank(), dist.get_world_size()

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if not args.full_config:
        cfg = configs.reduced(cfg)
    model = build_model(cfg, dtype=torch.float32, device=dev)
    plan = plan_mesh(world, preferred_model=min(4, cfg.num_heads))
    mesh = build_mesh(plan, dev.type)
    say(f"mesh: data={plan.data} model={plan.model} (dropped {plan.dropped_devices} "
        f"devices) over {dist.get_backend()}")
    full = make_train_state(model, torch.Generator(device=dev).manual_seed(0),
                            n_lora_slots=4)
    shardings = make_shardings(train_state_specs(full, mesh), mesh)
    step_fn = make_sharded_train_step(model, shardings, lr=args.lr)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, full, shardings=shardings)
        start = latest
        say(f"resumed from step {latest} (re-sharded onto current mesh)")
    else:
        state = shard_tree(full, shardings)
    del full
    if args.compress:
        compression_init({"params": state.params, "lora": state.lora})
        say("gradient compression: int8 + error feedback enabled")

    t0 = time.time()
    batch_shardings = None
    for step in range(start, args.steps):
        batch = make_batch(cfg, step, args.batch, args.seq, dev)
        batch_shardings = batch_shardings or make_shardings(batch_specs(batch, mesh), mesh)
        state, metrics = step_fn(state, shard_tree(batch, batch_shardings))
        if (step + 1) % 10 == 0 or step + 1 == args.steps:
            dt = (time.time() - t0) / (step - start + 1)
            say(f"step {step + 1:4d} loss={float(metrics['loss']):.4f} "
                f"({dt * 1e3:.0f} ms/step)")
        if (step + 1) % args.ckpt_every == 0:
            whole = gather_tree(state, shardings)
            if rank == 0:
                mgr.save_async(step + 1, whole)
    mgr.wait()
    say("training done")


def run(rank: int, world: int, argv: list) -> None:
    """A rank of :func:`~repro_torch.distributed.runner.run_ranks`."""
    train(parse_args(argv))


def main() -> None:
    args = parse_args()
    dev = resolve_device(args.device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" not in os.environ:  # not under torchrun: one rank
        with single_rank(backend):
            train(args)
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend)
    try:
        train(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
