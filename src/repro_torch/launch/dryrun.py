"""Multi-pod dry run (PyTorch counterpart of ``repro.launch.dryrun``),
reduced to what has a meaning for the eager port: for every (arch × shape)
cell on the production meshes, from the cell's meta trees
(``launch/specs.py``) and the sharding rules, the bytes one device holds
of the parameters, the LoRA slots, and the AdamW moments (a train cell) or
the decode cache (a decode cell), and ``model_flops``. Nothing is
allocated and no process group is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \
        --shape train_4k --mesh pod1           # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Each cell writes ``build/dryrun/<arch>__<shape>__<mesh>.json``. The
reference's lowering and compilation, its HLO cost analysis, collective
bytes by op and compile times have no counterpart: the port runs eagerly
and compiles nothing through XLA (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib

from .. import configs
from ..distributed.sharding import (batch_specs, cache_specs, make_shardings,
                                    moment_specs, param_specs)
from ..tree import flatten_with_names
from .mesh import production_axes
from .specs import batch_specs_for, model_flops, model_state_specs

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = ("pod1", "pod2")


def device_bytes(tree, specs: dict, mesh: dict) -> int:
    """Bytes one device holds of ``tree`` placed by ``specs``."""
    shardings = make_shardings(specs, mesh)
    return sum(math.prod(shardings[n].local_shape(tuple(t.shape))) * t.element_size()
               for n, t in flatten_with_names(tree))


def run_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    """One cell's record, its leaves placed as the train launcher places
    them (the rules without ``cfg``)."""
    shape = configs.get_shape(shape_name)
    cfg = configs.get(arch)
    mesh = production_axes(multi_pod=(mesh_name == "pod2"))
    state = model_state_specs(cfg, shape)
    batch = batch_specs_for(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
           "num_devices": math.prod(mesh.values()),
           "model_flops": model_flops(cfg, shape),
           "batch_bytes_per_device": device_bytes(batch, batch_specs(batch, mesh), mesh)}
    if shape.kind == "train":
        ts = state["train_state"]
        params, lora = ts.params, ts.lora
        rec["moment_bytes_per_device"] = sum(
            device_bytes(m, moment_specs(m, mesh), mesh) for m in (ts.opt.m, ts.opt.v))
    else:
        params, lora = state["params"], state["lora"]
        if "cache" in state:
            rec["cache_bytes_per_device"] = device_bytes(
                state["cache"], cache_specs(state["cache"], mesh), mesh)
    rec["param_bytes_per_device"] = device_bytes(params, param_specs(params, mesh), mesh)
    rec["lora_bytes_per_device"] = device_bytes(lora, param_specs(lora, mesh), mesh)
    return rec


def cell_path(arch: str, shape: str, mesh: str) -> pathlib.Path:
    return RESULTS / f"{arch}__{shape}__{mesh}.json"


def all_cells():
    for arch in configs.ARCH_IDS:
        for shape in configs.shape_cells(arch):
            for mesh in MESHES:
                yield arch, shape.name, mesh


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESHES + ("both",), default="pod1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    RESULTS.mkdir(parents=True, exist_ok=True)
    if args.list:
        for cell in all_cells():
            print(("DONE " if cell_path(*cell).exists() else "todo ") + "__".join(cell))
        return
    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [c for c in all_cells() if c[2] in meshes]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, m) for m in meshes]
    else:
        ap.error("--arch and --shape (or --all, --list)")
    for cell in cells:
        rec = run_cell(*cell)
        cell_path(*cell).write_text(json.dumps(rec, indent=1))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
