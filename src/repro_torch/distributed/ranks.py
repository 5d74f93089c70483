"""Run a function on ``N`` ranks of one host, each in its own process.

A small in-process ``torchrun`` for the multi-rank checks (the CPU tests
over gloo, ``chip_smoke.py``'s ranks on the card): :func:`run_ranks`
spawns ``N`` processes, each joins a fresh process group through a
rendezvous file (never a fixed port, so that runs side by side do not
collide), calls ``fn(mesh_device, *args)`` and hands its result back.
Every run has a time limit: on expiry, or as soon as one rank fails, the
others are killed and the call raises, so a hung collective cannot hang
the caller.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable


def _rank_main(fn: Callable, rank: int, world: int, init_method: str,
               device_type: str, args: tuple, out: Any) -> None:
    import torch

    from repro_torch.distributed import comm

    # The ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        device = comm.init(rank, world, init_method, device_type=device_type)
        try:
            result = fn(device, *args)
        finally:
            comm.shutdown()
        # Plain pickle bytes: the queue's own pickler would share tensor
        # storage with a process that is about to exit.
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:  # report every failure, then exit non-zero
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *args: Any,
              device_type: str = "cpu", timeout_s: float = 120.0,
              workdir: str | os.PathLike | None = None) -> list[Any]:
    """``[fn(device, *args) on rank r for r in range(world)]``.  ``fn``
    must be importable by name (the ranks start from a fresh
    interpreter); it may read the group through
    :mod:`repro_torch.distributed.comm`.  Raises ``RuntimeError`` with the
    rank's traceback when a rank fails, ``TimeoutError`` when the ranks
    do not all finish within ``timeout_s``."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-", dir=workdir)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_method, device_type, args,
                               out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} did "
                    f"not finish in {timeout_s:.0f} s (done: "
                    f"{sorted(results)})")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
