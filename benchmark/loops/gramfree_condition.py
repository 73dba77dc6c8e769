"""Closed loop, one caller: each step conditions the gram-free regressor on a
data set no earlier step used, then takes its posterior mean at fresh queries.

A data set: ``n`` points uniform on the domain and standard normal ``Y``
(as ``bench.py`` draws them) and ``queries`` query points.  The steps take the
``pool`` data sets of the streams ``(0, STEP, j)`` in an order drawn from the
seed, so that every seed does the same work in another order (the CG's
iterations follow the data: fresh data sets per seed moved ``condition_s`` by
~2.6 % from seed to seed).  Step ``i``: ``IterativeGPRegressor(prior, X, Y,
L=H, ...)`` (a new regressor, so the Nyström build runs every step),
``representer_weights``, ``mean``.  The window keeps every step's weights and
mean.

Correct: for ``check.steps`` steps drawn from the seed, the reference
evaluates ``(H k H* + sigma^2 I) w - Y`` in float64 and ``(k H*)(xq, X) w``
with the program's weights: the true relative residual of the solve
(``relres``) and the mean's gap to the weights' mean (``mean_gap``, of the
largest |mean|).  Control: the program in mode ``plain`` (float32).
"""

from __future__ import annotations

from ..harness import data
from ..harness.loop import ORDER, STEP, WARM, BaseLoop
from ..harness.trace import span
from ..reference.linalg import block_matvec


class Loop(BaseLoop):
    program_state = ("prior", "L", "outputs")

    def __init__(self, ctx):
        super().__init__(ctx)
        self.outputs = {}
        if ctx.control:
            self.mode = "plain"
        self.order = self.rng(ORDER).permutation(self.params["pool"]).tolist()

    def data(self, *key):
        """A data set of the pool (``(STEP, j)``) or the warm-up's, the same for every seed."""
        g = data.stream(self.device, 0, *key)
        n, nq = self.ctx.size("n"), self.ctx.size("queries")
        return self.points(g, n), data.normal(g, n), self.points(g, nq)

    def _run(self, X, Y, xq):
        cfg = self.cfg
        with span("bench.regressor"):
            reg = self.ctx.lgt.IterativeGPRegressor(
                self.prior, X, Y, L=self.L, noise_variance=self.noise, tol=cfg["tol"], maxiter=cfg["maxiter"],
                precond_rank=self.ctx.size("rank"), mode=self.mode, device=self.device)
        with span("bench.representer_weights"):
            w = reg.representer_weights
        with span("bench.mean"):
            mu = reg.mean(xq)
        self.sync()
        return reg, w, mu

    def setup(self):
        self._run(*self.data(WARM))

    def pooled(self, i: int):
        return self.data(STEP, self.order[i % len(self.order)])

    def step(self, i: int) -> dict:
        X, Y, xq = self.pooled(i)
        reg, w, mu = self._run(X, Y, xq)
        self.outputs[i] = (w, mu)
        iters, relres = reg.solve_info
        return {"work": 1, "iters": iters, "solver_relres": relres, "n": X.shape[0], "rank": reg.precond_rank,
                "queries": xq.shape[0]}

    def check(self, n_steps: int) -> dict:
        outputs, self.outputs = self.outputs, {}
        self.release()
        worst = {"relres": 0.0, "mean_gap": 0.0}
        for i in self.picks(n_steps, self.ctx.wl["check"]["steps"]):
            X, Y, xq = self.pooled(i)
            w, mu = (t.double() for t in outputs[i])
            r = block_matvec(self.kern.hk_hs, X, X, w) + self.noise * w - Y
            worst["relres"] = max(worst["relres"], float(r.norm() / Y.norm()))
            worst["mean_gap"] = max(worst["mean_gap"], self.rel_gap(mu, block_matvec(self.kern.k_hs, xq, X, w)))
            del r
        lim = self.limits()
        return {k: (v, lim[k]) for k, v in worst.items()}

