"""Per-stage wall-clock timers and ``torch.profiler`` traces.

Port of ``linpde_gp_tpu/utils/profiling.py``: :class:`StageTimer` keeps
its interface, and :func:`trace` runs ``torch.profiler`` where the JAX
package runs ``jax.profiler``.  Work on the card is asynchronous, so a
stage synchronizes the card before each clock read once CUDA is
initialized; without it a stage would time the enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulating named-stage wall-clock timer.

    >>> timer = StageTimer()
    >>> with timer("solve"):
    ...     _ = sum(range(10))
    >>> list(timer.summary())
    ['solve']
    """

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def __call__(self, name: str):
        return self.stage(name)

    def summary(self) -> dict[str, float]:
        return {k: round(v, 6) for k, v in self.stages.items()}


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` trace of the block, CPU and (with a card) CUDA
    activities, exported as a Chrome trace ``trace.json`` into ``logdir``
    (created if missing); a no-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
