"""Run a function on N ranks of one process group: the port's own launcher
of multi-rank work, for the tests (CPU processes over gloo) and for
``chip_smoke.py`` (one process a card over NCCL); ``torchrun`` does the
same for the train launcher.

:func:`run_ranks` spawns the ranks (start method ``spawn``), each joining a
process group over a ``FileStore`` in a directory the caller gives, so two
runs at once (xdist workers) share no port. A CPU rank computes with one
intra-op thread. The first rank to fail has its traceback raised in the
caller and the other ranks are killed; so are all of them when the run
outlasts its timeout, which also bounds every collective, so a hung
collective fails in seconds. :func:`single_rank` is the one-rank group of a
process that runs alone.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import queue
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

_RUNS = itertools.count()


def _rank_main(fn, rank: int, world: int, store: str, backend: str, args: tuple,
               timeout: float, results) -> None:
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, store_dir, *, backend: str = "gloo", args: tuple = (),
              timeout: float = 60.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one process
    group; the ranks' return values (picklable), in rank order. ``fn`` is a
    module-level function (it is pickled by name)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    store = str(Path(store_dir) / f"store-{os.getpid()}-{next(_RUNS)}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, store, backend, args, timeout, results))
             for r in range(world)]
    for p in procs:
        p.start()
    done: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(done))} did not "
                                   f"finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.2))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if not dead:
                    continue
                try:  # its report may still be on the way
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            done[rank] = out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
    return [done[r] for r in range(world)]


@contextlib.contextmanager
def single_rank(backend: str):
    """The default process group of a process that runs alone (rank 0 of
    1, over an in-process store)."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
