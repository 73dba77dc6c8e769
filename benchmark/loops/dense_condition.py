"""Closed loop, one caller: each step conditions the dense engine on the
anchored heat IBVP with fresh collocation points, then takes its posterior
mean at fresh queries.

Step ``i``: ``n`` collocation points and ``queries`` query points uniform on
the domain from the stream ``(seed, STEP, i)``; ``prior`` conditioned on each
of the problem's anchor sets in turn (the initial condition's, each
boundary's; values from u*, noise ``anchor_noise``) and on ``H u = 0`` at the
points (noise ``noise_rel`` of ``(H k H*)(x, x)``): four
``condition_on_observations`` calls; then ``mean``.  The window keeps every step's mean.

Correct: for ``check.steps`` steps drawn from the seed, the reference's
posterior (one float64 Cholesky of the joint Gram) gives the mean at the same
queries; ``mean_gap`` is the largest gap, of the largest |mean|.  Control:
the reference in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..harness.loop import STEP, WARM, BaseLoop
from ..harness.trace import span
from ..reference.linalg import DensePosterior


class DenseBase(BaseLoop):
    program_state = ("prior", "L", "post")

    def __init__(self, ctx):
        super().__init__(ctx)
        self.anchors = self.problem.anchors(self.cfg, ctx.device)
        self.cuts = [x.shape[0] for x, _ in self.anchors]
        self.xa = torch.cat([x for x, _ in self.anchors])
        self.ya = torch.cat([y for _, y in self.anchors])

    def condition(self, X):
        """One conditioning call per anchor set (IC, BC x = -1, BC x = 1), then
        the PDE's."""
        lgt, post = self.ctx.lgt, self.prior
        an = self.cfg["anchor_noise"]
        for xa, ya in self.anchors:
            m = xa.shape[0]
            with span("bench.condition_on_observations"):
                noise = lgt.Normal(np.zeros(m), np.full(m, an))
                post = post.condition_on_observations(ya, X=xa, b=noise)
        n = X.shape[0]
        with span("bench.condition_on_observations"):
            noise = lgt.Normal(np.zeros(n), np.full(n, self.noise))
            return post.condition_on_observations(np.zeros(n), X=X, L=self.L, b=noise)

    def reference(self, X, dtype):
        return DensePosterior(self.kern, X.to(dtype), self.xa.to(dtype), self.ya.to(dtype),
                              torch.zeros(X.shape[0], dtype=dtype, device=self.device), self.noise,
                              self.cfg["anchor_noise"])


class Loop(DenseBase):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.outputs = {}

    def data(self, *key):
        g = self.stream(*key)
        return self.points(g, self.ctx.size("n")), self.points(g, self.ctx.size("queries"))

    def _run(self, X, xq):
        post = self.condition(X)
        with span("bench.mean"):
            mu = post.mean(xq)
        self.sync()
        return mu

    def setup(self):
        self._run(*self.data(WARM))

    def step(self, i: int) -> dict:
        X, xq = self.data(STEP, i)
        self.outputs[i] = self._run(X, xq)
        return {"work": 1, "n": X.shape[0], "cuts": self.cuts, "queries": xq.shape[0]}

    def check(self, n_steps: int) -> dict:
        outputs, self.outputs = self.outputs, {}
        self.release()
        gap = 0.0
        for i in self.picks(n_steps, self.ctx.wl["check"]["steps"]):
            X, xq = self.data(STEP, i)
            mu = outputs[i]
            if self.ctx.control:
                mu = self.reference(X, torch.float32).mean(xq.float())
            ref = self.reference(X, torch.float64)
            gap = max(gap, self.rel_gap(mu, ref.mean(xq)))
            del ref
        return {"mean_gap": (gap, self.limits()["mean_gap"])}
