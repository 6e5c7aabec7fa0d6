"""Serving launcher: run the port's multi-LoRA engine (PyTorch counterpart
of ``repro.launch.serve``).

The engine runs on the card by default (``--device cuda``, the CUDA
kernels); ``--device cpu`` runs the kernels' plain versions. Without
``--full-config`` it serves the reduced config at the reference launcher's
sizes; with it, the full architecture at one-card sizes (4 GiB KV pool,
8 GiB pinned host tier, 8 slots of 2048 tokens).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --full-config --requests 16
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from repro_torch import configs
from repro_torch.distributed import RequestJournal
from repro_torch.serving import EngineConfig, Request, ServingEngine

DEFAULT_JOURNAL = (Path(__file__).resolve().parents[3] / "build"
                   / "repro_torch_serve" / "journal.jsonl")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=configs.ARCH_IDS)
    ap.add_argument("--variant", default="fastlibra")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--adapters", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture config at one-card sizes")
    ap.add_argument("--journal", default=str(DEFAULT_JOURNAL))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="arm libra-trace and dump Chrome trace-event JSON "
                         "here (load in Perfetto; see README §Observability)")
    args = ap.parse_args()

    cfg = configs.get(args.arch)
    if args.full_config:
        sizes = dict(hbm_bytes=4 << 30, host_bytes=8 << 30, block_size=16,
                     max_batch_slots=8, max_seq_len=2048, prefill_chunk=256,
                     step_token_budget=512)
    else:
        cfg = configs.reduced(cfg)
        sizes = dict(hbm_bytes=8 << 20, host_bytes=64 << 20, block_size=4,
                     max_batch_slots=4, max_seq_len=128)
    # --trace-out arms the tracer explicitly; otherwise the EngineConfig
    # default picks up REPRO_TRACE=1
    ekw = {"trace": True} if args.trace_out else {}
    engine = ServingEngine(
        cfg, EngineConfig(variant=args.variant, **sizes, **ekw),
        seed=args.seed, device=args.device,
    )
    for i in range(args.adapters):
        engine.register_adapter(f"lora-{i}")
    journal = RequestJournal(args.journal)

    # crash recovery: re-enqueue whatever a previous process left in flight
    for ev in journal.replay():
        engine.submit(Request(ev["rid"] + "-replayed", ev["adapter"],
                              tuple(ev["prompt"]), ev["max_new"]))
        print(f"replayed in-flight request {ev['rid']}")

    rng = random.Random(args.seed)
    for i in range(args.requests):
        rid = f"req-{i}"
        adapter = f"lora-{rng.randrange(args.adapters)}"
        prompt = tuple(rng.randrange(10, 200) for _ in range(rng.randint(6, 14)))
        journal.record_submit(rid, adapter, prompt, 6)
        engine.submit(Request(rid, adapter, prompt, max_new_tokens=6))
    report = engine.run()
    for r in engine.finished:
        journal.record_finish(r.request_id)
    print("report:", report.row())
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(f"trace: wrote {args.trace_out} "
              f"(summarize: python -m repro_torch.obs.report {args.trace_out})")


if __name__ == "__main__":
    main()
