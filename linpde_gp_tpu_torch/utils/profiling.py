"""Per-stage wall-clock timers, ``torch.profiler`` traces and the program's
spans.

Port of ``linpde_gp_tpu/utils/profiling.py``: :class:`StageTimer` keeps
its interface, and :func:`trace` runs ``torch.profiler`` where the JAX
package runs ``jax.profiler``.  Work on the card is asynchronous, so a
stage synchronizes the card before each clock read once CUDA is
initialized; without it a stage would time the enqueue.

:func:`span` marks the program's own work on the profiler's trace, as a
``user_annotation`` event on the host.  Each device operation of the trace
(kernel, copy, set) names by its ``correlation`` the host call that
launched it, and that launch lies inside the spans open at the time, so
the device's work can be charged to the span that caused it.  Run any call
under ``torch.profiler.profile()`` to see them; with no profiler running a
span is one flag check.  The spans:

- ``lgt.nystrom.build``: the Nyström preconditioner's build
  (``models/iterative.py::_preconditioner``), when it builds;
  ``lgt.nystrom.panels``: the build's two products in column panels
  (``ops/linalg/pcg.py::nystrom_products``), once a build that takes that
  route (rank 1,024 and up), inside ``lgt.nystrom.build``;
- ``lgt.nystrom.apply``: one Woodbury apply
  (``ops/linalg/pcg.py::NystromPreconditioner.__call__``);
- ``lgt.pcg``, ``lgt.pcg_block``: one whole solve of :func:`pcg_ff`, of
  :func:`pcg_block_ff`;
- ``lgt.pcg.matvec``: the matvec of one CG iteration, in either;
- ``lgt.host_read``: each read of the device by the host in either CG
  (``pcg_ff``: ``||b||`` and one per iteration; ``pcg_block_ff``: the
  loop's flag per iteration and the final residual);
- ``lgt.chol.factor``: one Cholesky with its jitter retries
  (``ops/linalg/chol.py::_factor``); ``lgt.chol.extend``: one
  :func:`chol_extend`; ``lgt.chol.panel_inv``: one build of a factor's
  inverted diagonal panels (``panel_inverses``); ``lgt.chol.panel_solve``:
  one blocked substitution (``panel_solve_sumsq``);
- ``lgt.anchor.setup``: the anchor batch's blocks of one regressor
  (``models/iterative.py::_setup_anchors``: ``A11``, its factor, ``W``);
  ``lgt.anchor.schur``: the Schur correction ``W A11^{-1} W^T v`` of one
  CG matvec (``_cg_matvec``, one or many columns), inside
  ``lgt.pcg.matvec``; ``lgt.anchor.precond``: the Schur term of one
  Nyström block (``_precond_block_fn``), inside ``lgt.nystrom.build``;
  ``lgt.anchor.weights``: the right-hand side's anchor term and the
  anchor weights (``_weights_ff``); ``lgt.anchor.mean``: the mean's
  anchor term ``k(xq, X1) w1``;
- ``lgt.gp.mean``, ``lgt.gp.var``: the dense posterior's mean and
  variance (``models/gp.py``); ``lgt.gp.var.solve``: the variance's
  triangular (or refined) solve; ``lgt.gp.crosscov``: the cross-covariance
  that either evaluates.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


#: The span's stand-in when no profiler runs: one shared, reusable no-op.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named span of the program on the profiler's trace
    (``torch.profiler.record_function``), or, with no profiler running,
    the shared no-op :data:`_OFF`: it creates no ``RecordFunction``."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


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
