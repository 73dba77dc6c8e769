"""The anchored heat IBVP on the port's gram-free engine (block elimination:
CG on the Schur complement of ``k(X1, X1) + tau I``) against the benchmark's
plain reference, on the CPU in float64.

The configuration ``benchmark/configs/ibvp_gramfree_1e5.json`` at a small
size with its proportions: N = 1,024 collocation points with H u = 0, 24
initial-condition and 2 x 12 boundary anchors with values from u*, Nyström
rank 128, CG tol 1e-11 (the cell's 1e-5 would leave the solver's truncation
in every comparison).  The reference is
``benchmark/reference/linalg.py``'s dense anchored posterior (one float64
Cholesky of the joint Gram) and ``benchmark/reference/anchored.py``'s joint
residual and mean, which only multiply.
"""

import numpy as np
import pytest
import torch

import linpde_gp_tpu_torch as lgt
from benchmark.harness import catalog, data
from benchmark.reference.anchored import anchored_mean, joint_residual
from benchmark.reference.linalg import DensePosterior
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
config.set(device="cpu")

N, N_IC, N_BC, RANK, NQ = 1024, 24, 12, 128, 256
ANCHOR_NOISE = 1e-5
#: The joint residual of the port's weights, of ||[Y1; Y]||: the CG stops at
#: 1e-11 of the Schur system's right-hand side (read: ~5e-12), so 1e-8 leaves
#: three orders of room; the weights rounded to float32 read ~5e-6.
JOINT_RTOL = 1e-8
#: The port's mean against the dense posterior's, of max |mean|: both solve
#: the same system to ~1e-11 (read: ~1e-12); the mean of the weights rounded
#: to float32 is ~2.5e-6 off.
MEAN_RTOL = 1e-9
#: The reference against itself (its dense weights): float64 round-off of a
#: joint Gram whose largest entries are ~50 (read: ~3e-14 and ~6e-14).
ROUNDOFF = 1e-11


@pytest.fixture(scope="module")
def solved():
    cfg = dict(catalog.config("ibvp_gramfree_1e5"), n_ic=N_IC, n_bc=N_BC)
    prob = catalog.problem(cfg["problem"])
    kern, noise = prob.reference_kernels(cfg), prob.noise_variance(cfg)
    prior, H = prob.program(lgt, cfg, "cpu")
    anchors = prob.anchors(cfg, "cpu")
    xa, ya = torch.cat([x for x, _ in anchors]), torch.cat([y for _, y in anchors])
    g = data.stream("cpu", 20, 1)
    X, xq = data.uniform_points(g, N, cfg["domain"]), data.uniform_points(g, NQ, cfg["domain"])
    Y = torch.zeros(N, dtype=torch.float64)
    reg = lgt.IterativeGPRegressor(prior, X, Y, L=H, noise_variance=noise, tol=1e-11, maxiter=1000,
                                   precond_rank=RANK, mode="f64", device="cpu", anchor_X=xa, anchor_Y=ya,
                                   anchor_noise=ANCHOR_NOISE)
    dense = DensePosterior(kern, X, xa, ya, Y, noise, ANCHOR_NOISE)
    na = xa.shape[0]

    def relres(w, w1):
        r1, r = joint_residual(kern, X, xa, Y, ya, w, w1, noise, ANCHOR_NOISE)
        return float(torch.cat([r1, r]).norm() / torch.cat([ya, Y]).norm())

    def mean_gap(mu, ref):
        return float((mu.double() - ref).abs().max() / ref.abs().max())

    return dict(kern=kern, X=X, xa=xa, xq=xq, reg=reg, w=reg.representer_weights, w1=reg.anchor_weights,
                mu=reg.mean(xq), dense=dense, dw=dense.w[na:], dw1=dense.w[:na], dmu=dense.mean(xq),
                relres=relres, mean_gap=mean_gap)


def _port_joint(s):
    return s["relres"](s["w"], s["w1"]), JOINT_RTOL


def _port_mean(s):
    return s["mean_gap"](s["mu"], s["dmu"]), MEAN_RTOL


def _reference_weights(s):
    return s["relres"](s["dw"], s["dw1"]), ROUNDOFF


def _reference_mean(s):
    return s["mean_gap"](anchored_mean(s["kern"], s["xq"], s["X"], s["xa"], s["dw"], s["dw1"]), s["dmu"]), ROUNDOFF


CASES = {"port_joint_residual": _port_joint, "port_mean_vs_dense": _port_mean,
         "reference_joint_residual_of_dense_weights": _reference_weights,
         "reference_mean_of_dense_weights": _reference_mean}


@pytest.mark.parametrize("case", list(CASES))
def test_anchored_gramfree_against_reference(case, solved):
    value, bound = CASES[case](solved)
    assert np.isfinite(value) and value <= bound, (case, value, bound)


@pytest.mark.parametrize("check", ["relres", "mean_gap"])
def test_float32_weights_fail_the_bounds(check, solved):
    """The bounds are tight enough that the port's weights rounded to
    float32 (the nearest precision below the configuration's) fail them."""
    s = solved
    w, w1 = s["w"].float(), s["w1"].float()
    if check == "relres":
        assert s["relres"](w, w1) > JOINT_RTOL
    else:
        mu = anchored_mean(s["kern"], s["xq"], s["X"], s["xa"], w, w1).float()
        assert s["mean_gap"](mu, s["dmu"]) > MEAN_RTOL
