"""What the four loops share: the run's context, data streams, the window's
steps, and the comparisons' bookkeeping.

A loop (``benchmark/loops/<name>.py``, class ``Loop``, named by the
workload file's ``"loop"``) has ``setup()`` (data and warm-up, timed as
set-up), ``step(i)`` (one step of the closed loop, synchronized; returns
the step's work record), ``release()`` (frees the program's state once the
window has closed) and ``check()`` (the comparisons with the reference:
``{name: (value, limit)}``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import catalog, data, device as dev

#: Draw keys of :func:`data.stream`.
SETUP, WARM, STEP, CHECK, ORDER = range(5)


@dataclass
class Context:
    cell: str
    cfg: dict
    wl: dict
    seed: int
    device: object  # torch.device
    lgt: object  # the program's package
    control: bool = False  # run the control in the program's place
    sizes: dict = field(default_factory=dict)  # overrides of cfg / params (tests)

    def size(self, key: str):
        """A size of the configuration or the workload's parameters, or its
        override."""
        if key in self.sizes:
            return self.sizes[key]
        return self.wl["params"][key] if key in self.wl["params"] else self.cfg[key]


class BaseLoop:
    """The configuration's problem (``problems/<cfg["problem"]>.py``): the
    program's prior and operator (``prior``, ``L``), the reference's kernels
    (``kern``) and the observations' noise."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.cfg, self.params = ctx.cfg, ctx.wl["params"]
        self.device = ctx.device
        self.problem = catalog.problem(ctx.cfg["problem"])
        self.kern = self.problem.reference_kernels(ctx.cfg)
        self.noise = self.problem.noise_variance(ctx.cfg)
        self.prior, self.L = self.problem.program(ctx.lgt, ctx.cfg, ctx.device)
        self.mode = ctx.cfg["mode"]

    def stream(self, *key: int):
        return data.stream(self.device, self.ctx.seed, *key)

    def points(self, g, n: int):
        """``n`` points uniform on the configuration's domain."""
        return data.uniform_points(g, n, self.cfg["domain"])

    def rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng([int(self.ctx.seed) % 2**128, *key])

    def sync(self) -> None:
        dev.sync(self.device)

    def release(self) -> None:
        import gc

        import torch

        for name in self.program_state:
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    program_state: tuple = ("prior", "L")

    def picks(self, n: int, k: int) -> list[int]:
        """``k`` of ``n`` answers, drawn from the seed."""
        return sorted(self.rng(CHECK).choice(n, size=min(k, n), replace=False).tolist())

    def limits(self) -> dict:
        return self.ctx.wl["check"]["limits"]

    @staticmethod
    def rel_gap(a, b) -> float:
        """max |a - b| / max |b|, in float64."""
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())
