"""Closed loop, one caller that waits for each reply: the set-up conditions one
dense IBVP posterior; each request is its mean and std at a fresh batch.

Set-up: ``n`` collocation points from ``(seed, SETUP)``, the four
conditioning calls (as ``dense_condition``), and one warm request at the
smallest and at the largest batch.  Request ``i``: ``sizes[i % count]``
points uniform on the domain from ``(seed, STEP, i)``, ``post.mean``
and ``post.std``.  The batch sizes are the ``count`` quantiles of a
log-uniform law on [``batch_min``, ``batch_max``], the same multiset for every
seed, shuffled by the seed.

Correct: ``check.requests`` requests drawn from the seed, the largest batch
of the window among them; the reference's posterior (float64) gives mean and
std at their points: ``mean_gap`` of the largest |mean|, ``std_gap`` per
query relative to the reference's std.  Control: the reference in float32.
"""

from __future__ import annotations

import torch

from ..harness import data
from ..harness.loop import ORDER, SETUP, STEP
from ..harness.trace import span
from .dense_condition import DenseBase


class Loop(DenseBase):
    def __init__(self, ctx):
        super().__init__(ctx)
        p = self.params
        sizes = data.log_uniform_sizes(p["batch_min"], p["batch_max"], p["count"])
        self.sizes = [sizes[j] for j in self.rng(ORDER).permutation(len(sizes))]
        self.outputs = {}

    def batch(self, i: int):
        return self.points(self.stream(STEP, i), self.sizes[i % len(self.sizes)])

    def _request(self, xq):
        with span("bench.mean"):
            mu = self.post.mean(xq)
        with span("bench.std"):
            sd = self.post.std(xq)
        self.sync()
        return mu, sd

    def setup(self):
        self.X = self.points(self.stream(SETUP), self.ctx.size("n"))
        self.post = self.condition(self.X)
        g = self.stream(SETUP, 1)
        for b in (min(self.sizes), max(self.sizes)):
            self._request(self.points(g, b))

    def step(self, i: int) -> dict:
        xq = self.batch(i)
        self.outputs[i] = self._request(xq)
        return {"work": xq.shape[0]}

    def check(self, n_steps: int) -> dict:
        outputs, self.outputs = self.outputs, {}
        self.release()
        picks = set(self.picks(n_steps, self.ctx.wl["check"]["requests"] - 1))
        picks.add(max(range(n_steps), key=lambda i: self.sizes[i % len(self.sizes)]))
        ref = self.reference(self.X, torch.float64)
        ctl = self.reference(self.X, torch.float32) if self.ctx.control else None
        mean_gap = std_gap = 0.0
        for i in sorted(picks):
            xq = self.batch(i)
            mu, sd = outputs[i]
            if ctl is not None:
                mu, sd = ctl.mean(xq.float()), ctl.std(xq.float())
            mean_gap = max(mean_gap, self.rel_gap(mu, ref.mean(xq)))
            sd_ref = ref.std(xq)
            std_gap = max(std_gap, float(((sd.double() - sd_ref).abs() / sd_ref).max()))
        lim = self.limits()
        return {"mean_gap": (mean_gap, lim["mean_gap"]), "std_gap": (std_gap, lim["std_gap"])}
