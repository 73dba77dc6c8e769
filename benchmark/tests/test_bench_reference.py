"""``benchmark/reference`` against ``linpde_gp_tpu_torch`` on the CPU in
float64 at a small size, for each cell's entry: the kernel forms, the
gram-free weights, mean and variance, and the dense posterior's mean and std.
The reference's own algebra (the block-triangle operator, the Nyström CG)
against dense solves."""

import numpy as np
import pytest
import torch

from benchmark.harness import catalog, data
from benchmark.reference.linalg import DensePosterior, Nystrom, SymmetricOperator, block_matrix, block_matvec, pcg

HEAT = catalog.problem("heat")
noise_variance, program_problem, reference_kernels = HEAT.noise_variance, HEAT.program, HEAT.reference_kernels

CFG = catalog.config("heat_gramfree_1e5")
DENSE = catalog.config("ibvp_dense_32k")
DEV = torch.device("cpu")


def _points(n, key):
    return data.uniform_points(data.stream(DEV, 20261017, key), n, CFG["domain"])


def test_kernel_forms_match_the_program(cpu):
    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops.gram import gram_matrix
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

    prior, H = program_problem(lgt, CFG, cpu)
    kern = reference_kernels(CFG)
    x0, x1 = _points(50, 1), _points(70, 2)
    k_hs = apply_operator_to_kernel(H, prior.cov, argnum=1)
    hk_hs = apply_operator_to_kernel(H, k_hs, argnum=0)
    for ref, prog in ((kern.k, prior.cov), (kern.k_hs, k_hs), (kern.hk_hs, hk_hs)):
        torch.testing.assert_close(ref(x0, x1), gram_matrix(prog, x0, x1, "f64"), rtol=1e-12, atol=1e-12)
    assert kern.diag_hk_hs() == pytest.approx(float(gram_matrix(hk_hs, x0[:1], x0[:1], "f64")), rel=1e-14)


def test_gram_free_entry_matches_a_dense_reference(cpu):
    import linpde_gp_tpu_torch as lgt

    n, nq = 400, 64
    prior, H = program_problem(lgt, CFG, cpu)
    kern, noise = reference_kernels(CFG), noise_variance(CFG)
    g = data.stream(DEV, 5, 0)
    X, Y = data.uniform_points(g, n, CFG["domain"]), data.normal(g, n)
    xq = data.uniform_points(g, nq, CFG["domain"])
    reg = lgt.IterativeGPRegressor(prior, X, Y, L=H, noise_variance=noise, tol=1e-12, maxiter=2000,
                                   precond_rank=64, mode="f64", device=cpu)
    A = block_matrix(kern.hk_hs, X, X, rows=37) + noise * torch.eye(n, dtype=torch.float64)
    L = torch.linalg.cholesky(A)
    w = torch.cholesky_solve(Y[:, None], L)[:, 0]
    torch.testing.assert_close(reg.representer_weights, w, rtol=1e-7, atol=1e-7 * float(w.abs().max()))
    mean = block_matvec(kern.k_hs, xq, X, w, rows=17)
    torch.testing.assert_close(reg.mean(xq), mean, rtol=0, atol=1e-9 * float(mean.abs().max()))
    B = block_matrix(kern.k_hs, xq, X).T
    var = 1.0 - (B * torch.cholesky_solve(B, L)).sum(0)
    torch.testing.assert_close(reg.var(xq, block_size=32, tol=1e-12), var, rtol=0, atol=1e-9)


def test_reference_algebra_against_dense_solves():
    n, m = 700, 96
    kern, noise = reference_kernels(CFG), noise_variance(CFG)
    X = _points(n, 3)
    A = block_matrix(kern.hk_hs, X, X) + noise * torch.eye(n, dtype=torch.float64)
    op = SymmetricOperator(kern.hk_hs, X, noise, block=128)
    v = torch.randn(n, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(op @ v, A @ v, rtol=1e-12, atol=1e-12)
    M = Nystrom(kern.hk_hs, X, m, noise)
    S, iters = pcg(op, v, M, 1e-12, 2000)
    assert iters < 2000
    torch.testing.assert_close(S, torch.linalg.solve(A, v), rtol=1e-8, atol=1e-8 * float(S.abs().max()))


def test_dense_entry_matches_the_reference(cpu):
    import linpde_gp_tpu_torch as lgt

    n, nq = 500, 128
    cfg = dict(DENSE, n_ic=12, n_bc=6)
    prior, H = program_problem(lgt, cfg, cpu)
    kern, noise = reference_kernels(cfg), noise_variance(cfg)
    sets = HEAT.anchors(cfg, DEV)
    xa, ya = torch.cat([x for x, _ in sets]), torch.cat([y for _, y in sets])
    X, xq = _points(n, 4), _points(nq, 5)
    post, a = prior, 0
    for m in (12, 6, 6):
        post = post.condition_on_observations(ya[a:a + m], X=xa[a:a + m],
                                              b=lgt.Normal(np.zeros(m), np.full(m, cfg["anchor_noise"])))
        a += m
    post = post.condition_on_observations(np.zeros(n), X=X, L=H, b=lgt.Normal(np.zeros(n), np.full(n, noise)))
    ref = DensePosterior(kern, X, xa, ya, torch.zeros(n, dtype=torch.float64), noise, cfg["anchor_noise"])
    mean = ref.mean(xq)
    torch.testing.assert_close(post.mean(xq), mean, rtol=0, atol=1e-8 * float(mean.abs().max()))
    torch.testing.assert_close(post.std(xq), ref.std(xq), rtol=1e-7, atol=0)
