"""Closed loop, one caller: each step conditions the gram-free regressor on
the anchored heat IBVP at a point set no earlier step used, then takes its
posterior mean at fresh queries.

A point set: ``n`` collocation points and ``queries`` query points uniform
on the domain, the pool of :mod:`gramfree_condition` (its ``Y`` replaced by
``H u = 0``), visited in an order drawn from the seed.  The anchors are the
problem's (initial condition, then the boundaries x = -1 and x = 1; values
from u*, noise ``anchor_noise``), the same in every step.  Step ``i``:
``IterativeGPRegressor(prior, X, 0, L=H, ..., anchor_X=X1, anchor_Y=u*(X1),
anchor_noise=...)`` (a new regressor, so the anchor blocks, the Schur
kernel's Nyström build and the CG on the Schur complement run every step),
``representer_weights``, ``anchor_weights``, ``mean``.  The window keeps
every step's weights and mean.

Correct: for ``check.steps`` steps drawn from the seed, in float64 with the
program's weights ``(w, w1)``: the joint system's residual over ``||[Y1;
Y]||`` (``relres``, :func:`~benchmark.reference.anchored.joint_residual`),
the mean's gap to the weights' mean (``mean_gap``, of the largest |mean|,
:func:`~benchmark.reference.anchored.anchored_mean`) and the mean's RMSE
against u* at the queries (``u_err``, independent of both).  Control: the
program in mode ``plain`` (float32).
"""

from __future__ import annotations

import torch

from ..harness.trace import span
from ..reference.anchored import anchored_mean, joint_residual
from . import gramfree_condition


class Loop(gramfree_condition.Loop):
    def __init__(self, ctx):
        super().__init__(ctx)
        anchors = self.problem.anchors(self.cfg, ctx.device)
        self.xa = torch.cat([x for x, _ in anchors])
        self.ya = torch.cat([y for _, y in anchors])

    def data(self, *key):
        X, Y, xq = super().data(*key)
        return X, torch.zeros_like(Y), xq

    def _run(self, X, Y, xq):
        cfg = self.cfg
        with span("bench.regressor"):
            reg = self.ctx.lgt.IterativeGPRegressor(
                self.prior, X, Y, L=self.L, noise_variance=self.noise, tol=cfg["tol"], maxiter=cfg["maxiter"],
                precond_rank=self.ctx.size("rank"), mode=self.mode, device=self.device, anchor_X=self.xa,
                anchor_Y=self.ya, anchor_noise=cfg["anchor_noise"])
        with span("bench.representer_weights"):
            w = reg.representer_weights
            w1 = reg.anchor_weights
        with span("bench.mean"):
            mu = reg.mean(xq)
        self.sync()
        return reg, (w, w1), mu

    def step(self, i: int) -> dict:
        info = super().step(i)
        return dict(info, anchors=self.xa.shape[0])

    def check(self, n_steps: int) -> dict:
        outputs, self.outputs = self.outputs, {}
        self.release()
        worst = {"relres": 0.0, "mean_gap": 0.0, "u_err": 0.0}
        for i in self.picks(n_steps, self.ctx.wl["check"]["steps"]):
            X, Y, xq = self.pooled(i)
            (w, w1), mu = outputs[i]
            r1, r = joint_residual(self.kern, X, self.xa, Y, self.ya, w, w1, self.noise, self.cfg["anchor_noise"])
            rel = torch.cat([r1, r]).norm() / torch.cat([self.ya, Y]).norm()
            worst["relres"] = max(worst["relres"], float(rel))
            ref = anchored_mean(self.kern, xq, X, self.xa, w, w1)
            worst["mean_gap"] = max(worst["mean_gap"], self.rel_gap(mu, ref))
            err = mu.double() - self.problem.u_star(xq)
            worst["u_err"] = max(worst["u_err"], float(err.square().mean().sqrt()))
            del r1, r
        lim = self.limits()
        return {k: (v, lim[k]) for k, v in worst.items()}
