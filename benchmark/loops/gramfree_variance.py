"""Closed loop, one caller: the set-up conditions one gram-free posterior;
each step is its variance at fresh queries.

Set-up: ``n`` points and ``Y`` from the stream ``(0, SETUP)``, the same data
set for every seed (so that every seed does the same work: the CG's
iterations follow the posterior), the regressor and its solve, and one warm
``var`` call on the window's shapes at CG tol :data:`WARM_TOL`.  Step ``i``:
``reg.var(xq, block_size=block_size)`` at the regressor's own tol, the
configuration's, on a block of ``queries`` points uniform on the domain.  The
steps take the ``pool`` blocks of the streams ``(0, STEP, j)`` in an order
drawn from the seed, so that every seed does the same work in another order
(a block's CG takes 9 or 10 iterations: fresh blocks per step moved a
step's time by 10 %).

Correct: ``check.queries`` of the window's queries, drawn from the seed; the
reference solves ``(H k H* + sigma^2 I) s = (H k)(X, xq)`` for them by its own
Nyström-preconditioned CG in float64 to ``check.tol``, on the observation
operator's lower block triangle, and ``var_gap`` is the largest ``|var -
var_ref|`` over them, of the largest ``var_ref``.  Control: the program in
mode ``plain`` (float32).
"""

from __future__ import annotations

import torch

from ..harness import data
from ..harness.loop import ORDER, SETUP, STEP, WARM, BaseLoop
from ..harness.trace import span
from ..reference.linalg import Nystrom, SymmetricOperator, block_matrix, pcg

#: The warm-up's CG tolerance: the window's shapes, a few iterations.
WARM_TOL = 1e-2


class Loop(BaseLoop):
    program_state = ("prior", "L", "reg")

    def __init__(self, ctx):
        super().__init__(ctx)
        if ctx.control:
            self.mode = "plain"
        self.outputs = {}
        self.order = self.rng(ORDER).permutation(self.params["pool"]).tolist()

    def queries(self, g):
        return self.points(g, self.ctx.size("queries"))

    def pooled(self, i: int):
        """Step ``i``'s queries: a block of the pool, the same for every seed."""
        return self.queries(data.stream(self.device, 0, STEP, self.order[i % len(self.order)]))

    def _var(self, xq, tol=None):
        with span("bench.var"):
            v = self.reg.var(xq, block_size=self.params["block_size"], tol=tol)
        self.sync()
        return v

    def setup(self):
        g = data.stream(self.device, 0, SETUP)
        n, cfg = self.ctx.size("n"), self.cfg
        self.X, self.Y = self.points(g, n), data.normal(g, n)
        with span("bench.regressor"):
            self.reg = self.ctx.lgt.IterativeGPRegressor(
                self.prior, self.X, self.Y, L=self.L, noise_variance=self.noise, tol=cfg["tol"],
                maxiter=cfg["maxiter"], precond_rank=self.ctx.size("rank"), mode=self.mode, device=self.device)
        with span("bench.representer_weights"):
            self.reg.representer_weights
        self._var(self.queries(self.stream(WARM)), WARM_TOL)

    def step(self, i: int) -> dict:
        xq = self.pooled(i)
        self.outputs[i] = self._var(xq)
        info = self.reg.var_info
        return {"work": xq.shape[0], "block_iters": [it for it, _ in info], "n": self.X.shape[0],
                "block_size": self.params["block_size"]}

    def check(self, n_steps: int) -> dict:
        outputs, self.outputs = self.outputs, {}
        self.release()
        q = self.ctx.size("queries")
        k = self.ctx.wl["check"]["queries"]
        flat = self.picks(n_steps * q, k)
        xs, vs = [], []
        for i in sorted({j // q for j in flat}):
            cols = [j % q for j in flat if j // q == i]
            xs.append(self.pooled(i)[cols])
            vs.append(outputs[i].double()[cols])
        xq, v = torch.cat(xs), torch.cat(vs)
        del outputs
        chk = self.ctx.wl["check"]
        op = SymmetricOperator(self.kern.hk_hs, self.X, self.noise)
        M = Nystrom(self.kern.hk_hs, self.X, min(chk["rank"], self.X.shape[0]), self.noise)
        B = block_matrix(self.kern.k_hs, xq, self.X).T.contiguous()
        S, _ = pcg(op, B, M, chk["tol"], chk["maxiter"])
        v_ref = self.kern.k_diag(xq) - (B * S).sum(0)
        return {"var_gap": (float((v - v_ref).abs().max() / v_ref.abs().max()), self.limits()["var_gap"])}
