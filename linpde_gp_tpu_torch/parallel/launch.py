"""Spawn a world of P ranks on this machine: the process-model counterpart
of ``jax.devices()`` for the parallel layer's tests and dry run.

:func:`spawn` starts P processes by the ``spawn`` start method (never
``fork``: the caller may hold threads and JAX), each with a process group
of its own backend whose store is a file in a fresh temporary directory
(no TCP port to race for under parallel test workers).  Each rank calls
``fn(*args)``; the call returns every rank's result, in rank order.  A rank
that raises fails the call with its traceback, the other ranks are
stopped, and so are all of them when ``timeout`` passes: ranks that drift
apart wait in a collective forever, and a hang must fail, not stall.

``fn`` must be importable by name in a fresh process (a module-level
function of a module that does not import JAX, such as
``parallel/dryrun.py``), and its arguments and result picklable.  On a
machine with several cards, ``backend="nccl", device="cuda"`` gives each
rank ``cuda:{rank}``; ``torchrun`` does the same for a script that calls
``make_mesh()``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(rank: int, world: int, tmp: str, backend: str, device: str, threads: int, fn, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    from ..config import config

    out = Path(tmp)
    try:
        torch.set_num_threads(threads)
        if device == "cpu":
            config.set(device="cpu")
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank, world_size=world)
        result = fn(*args)
        with open(out / f"{rank}.tmp", "wb") as fh:
            pickle.dump(result, fh)
        os.replace(out / f"{rank}.tmp", out / f"{rank}.out")
    except BaseException:  # noqa: BLE001 - the parent reports it and stops the world
        (out / f"{rank}.err").write_text(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)  # not through destroy_process_group: the other ranks may wait in a collective
    dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), *, timeout: float = 300.0, backend: str = "gloo",
          device: str = "cpu", threads: int = 1) -> list:
    """Run ``fn(*args)`` on ``nprocs`` spawned ranks of one process group
    and return their results in rank order.  ``device="cpu"`` asks each
    rank for the CPU (``config.device``); ``threads`` is each rank's torch
    thread count.  Raises ``RuntimeError`` with the first failed rank's
    traceback, or ``TimeoutError`` after ``timeout`` seconds; either way
    every rank is stopped before the call returns."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lgt_world_")
    procs = [
        ctx.Process(target=_rank_main, args=(r, nprocs, tmp, backend, device, threads, fn, args))
        for r in range(nprocs)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish {getattr(fn, '__name__', fn)} in {timeout} s")
            time.sleep(0.02)
        if failed:
            err = Path(tmp) / f"{failed[0]}.err"
            detail = err.read_text() if err.exists() else f"exit code {codes[failed[0]]}"
            raise RuntimeError(f"rank {failed[0]} of {nprocs} failed:\n{detail}")
        results = []
        for r in range(nprocs):
            with open(Path(tmp) / f"{r}.out", "rb") as fh:
                results.append(pickle.load(fh))  # written by this call's own ranks
        return results
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
