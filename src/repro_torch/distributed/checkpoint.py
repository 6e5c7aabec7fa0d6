"""Fault tolerance (PyTorch counterpart of ``repro.distributed.checkpoint``):
:class:`CheckpointManager` for training state, and :class:`RequestJournal`,
which persists in-flight request metadata so a restarted engine can
re-enqueue them (a copy of the reference's class).

The checkpoint format is the reference's, so either package restores the
other's checkpoints leaf for leaf:

* a checkpoint is one directory ``step_<N>/`` (N zero-padded to 10 digits)
  holding one ``.npy`` file a leaf and a JSON manifest (the step; each
  leaf's name, file, shape and dtype; a description of the tree);
* writes go to ``step_<N>.tmp/`` and are renamed when complete, so a crash
  mid-save never leaves a half-written latest checkpoint;
* ``save_async`` copies device tensors into pinned host memory on the
  current stream and writes the files on a thread once the copies are
  done: training goes on meanwhile;
* ``restore`` fills a tree shaped like a template, on the device asked for,
  or, given the current mesh's shardings (``make_shardings``), this rank's
  slice of every leaf, read from the whole leaf on disk: an elastic
  restart re-shards on load, as the reference's ``restore(shardings=)``;
* only the newest ``keep`` checkpoints stay.

Leaves are whole (a sharded run gathers them and one rank writes) and are
named and ordered as ``jax.tree_util`` walks the reference's pytrees
(:mod:`repro_torch.tree`: dict keys sorted, sequences and dataclass fields
in order, ``None`` no leaf).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..tree import flatten_with_names, unflatten


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None  # of the last save_async

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> pathlib.Path:
        """Write ``tree`` now (after any save in flight)."""
        self.wait()
        host = [(n, t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t)) for n, t in flatten_with_names(tree)]
        return self._write(step, host)

    def save_async(self, step: int, tree) -> None:
        """Copy every device tensor into pinned host memory on the current
        stream now, and write the files on a thread once the copies are
        done. The copies are taken before this returns, so the caller may
        go on to change ``tree``."""
        self.wait()
        host, event = [], None
        for n, t in flatten_with_names(tree):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t.detach(), non_blocking=True)
                host.append((n, buf))
            elif isinstance(t, torch.Tensor):
                host.append((n, t.detach().clone()))
            else:
                host.append((n, np.array(t)))
        if any(isinstance(b, torch.Tensor) and b.is_pinned() for _, b in host):
            event = torch.cuda.Event()
            event.record()

        def work():
            try:
                if event is not None:
                    event.synchronize()
                self._write(step, [(n, b.numpy() if isinstance(b, torch.Tensor) else b)
                                   for n, b in host])
            except BaseException as e:  # raised again by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; a failure of its writes raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host) -> pathlib.Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr) in enumerate(host):
            fn = f"leaf_{i:05d}.npy"
            np.save(tmp / fn, arr)
            manifest["leaves"].append({"name": name, "file": fn, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)})
        manifest["treedef"] = f"repro_torch.tree: {len(host)} leaves"
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        ckpts = sorted(c for c in self.dir.glob("step_*") if not c.name.endswith(".tmp"))
        for old in ckpts[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(old)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if not p.name.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: int, template, device=None, shardings=None):
        """The checkpoint of ``step`` as a tree shaped like ``template``
        (a tree of tensors, whole leaves; meta tensors will do with
        ``device``): each leaf in its template leaf's dtype, on ``device``,
        or on the template leaf's device without one. The leaves must be
        the template's, by name and number. With ``shardings`` ({leaf name:
        ``Sharding``}, as ``make_shardings`` gives them) each leaf is this
        rank's slice, read from the memory-mapped file."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        records = manifest["leaves"]
        like = flatten_with_names(template)
        if len(like) != len(records):
            raise ValueError(f"checkpoint has {len(records)} leaves, target needs "
                             f"{len(like)}")
        out = []
        for rec, (name, t) in zip(records, like):
            if rec["name"] != name:
                raise ValueError(f"checkpoint leaf {rec['name']!r} where the target "
                                 f"has {name!r}")
            arr = np.load(d / rec["file"], mmap_mode="r")
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {name!r} is {tuple(arr.shape)}, the "
                                 f"target's {tuple(t.shape)}")
            dev = device if device is not None else t.device
            local = (shardings[name].local(arr) if shardings is not None
                     else torch.from_numpy(np.array(arr)))  # a writable copy, 0-d kept
            out.append(local.to(device=dev, dtype=t.dtype))
        return unflatten(template, out)


class RequestJournal:
    """Append-only journal of in-flight serving requests (crash recovery)."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def record_submit(self, request_id: str, adapter_id: str,
                      prompt: tuple, max_new_tokens: int) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps({
                "event": "submit", "rid": request_id, "adapter": adapter_id,
                "prompt": list(prompt), "max_new": max_new_tokens,
            }) + "\n")

    def record_finish(self, request_id: str) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps({"event": "finish", "rid": request_id}) + "\n")

    def replay(self) -> list[dict]:
        """Requests submitted but not finished (to re-enqueue on restart)."""
        if not self.path.exists():
            return []
        pending: dict[str, dict] = {}
        with self.path.open() as f:
            for line in f:
                if not line.strip():
                    continue
                ev = json.loads(line)
                if ev["event"] == "submit":
                    pending[ev["rid"]] = ev
                elif ev["event"] == "finish":
                    pending.pop(ev["rid"], None)
        return list(pending.values())
