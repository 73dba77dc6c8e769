"""The ff posterior variance carries no float32 rounding between the
kernels and the CG (ROADMAP Queue 3): the Wendland cell's problem
(``chip_smoke.py::wendland_data``: 2 Wendland(k=2, l=0.05), sorted uniform
points of [0, 1] from seed 0, Y = sin(8 X), noise 1e-3) at N = 2,000 with
a rank-128 Nystrom preconditioner, here on the CPU through the kernels'
plain versions and the banded route.  Its variance sits ~1e-4 below the
prior variance 2, so the quadratic form must be accurate far beyond the
CG tolerance relative to the right-hand side.

With K2's ff output, the preconditioner's output and ``kxX`` each rounded
to float32, ff CG at tol 1e-9 stalled at a true relres of 7.6e-8 with a
quadratic-form error of 1.6e-7 (about 1e-3 of var).
"""

import numpy as np
import torch

from linpde_gp_tpu_torch import GaussianProcess
from linpde_gp_tpu_torch.models.functions import Zero
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.ops.ff import ff_split
from linpde_gp_tpu_torch.ops.gram import gram_matrix
from linpde_gp_tpu_torch.ops.kernels import WendlandCovarianceFunction
from linpde_gp_tpu_torch.ops.linalg.pcg import pcg_block_ff
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

N, NQ, RANK, NOISE, TOL = 2000, 32, 128, 1e-3, 1e-9


def _wendland_data():
    """``chip_smoke.py::wendland_data(N, NQ)``: the same draws in order."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, N))
    rng.standard_normal(N)
    return X, np.sin(8.0 * X), rng.uniform(0.0, 1.0, NQ)


def test_ff_var_at_tol_1e9_reaches_f64_accuracy():
    prior = GaussianProcess(Zero(()), 2.0 * WendlandCovarianceFunction((), k=2, lengthscales=0.05))
    X, Y, xq = _wendland_data()
    errs = {}
    for mode in ("ff", "f64"):
        reg = IterativeGPRegressor(prior, X, Y, noise_variance=NOISE, tol=1e-5, maxiter=2000, precond_rank=RANK,
                                   mode=mode, device="cpu")
        assert reg._banded is not None
        var = reg.var(xq, block_size=NQ, tol=TOL).double()
        # The float64 dense posterior on the points as the regressor holds them.
        X64, xq64 = reg.X.double(), reg._queries(xq).double()
        G = gram_matrix(prior.cov, X64, X64, "f64") + NOISE * torch.eye(N, dtype=torch.float64)
        Kq = gram_matrix(prior.cov, xq64, X64, "f64")
        ref = prior.cov(xq64[:, 0]) - torch.sum(Kq * torch.cholesky_solve(Kq.T, torch.linalg.cholesky(G)).T, 1)
        errs[mode] = ((var - ref).abs() / ref).max().item()
        if mode == "ff":
            # The variance's solve as var runs it: kxX in f64 handed over as
            # an ff pair, the CG operator and the preconditioner of var.
            B = Kq.T.contiguous()
            res = pcg_block_ff(reg._cg_matvec, reg._preconditioner(), ff_split(B), NOISE, tol=TOL, maxiter=2000)
            S = res.x.double() + res.x_lo.double()
            true_relres = (torch.linalg.vector_norm(G @ S - B, dim=0) / torch.linalg.vector_norm(B, dim=0)).max()
            print(f"ff true relres {true_relres.item():.3e}")
            assert true_relres.item() <= 1e-8
    print(f"var error per query, relative to var: {errs}")
    assert errs["ff"] <= 10 * errs["f64"], errs
