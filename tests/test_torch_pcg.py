"""Float-float CG, the Nyström preconditioner and the robust Cholesky of
the PyTorch port, against the JAX package and dense solves.

Ports of ``tests/test_pcg_r5.py::test_ff_scalar_helpers`` and
``::test_pcg_ff_with_preconditioner`` (same inputs and bounds), plus
agreement with the JAX package's ``landmark_indices``,
``nystrom_preconditioner_device`` and ``cholesky``.  The zero right-hand
side is checked against the dense answer (0), not against the JAX
package, which returns NaN there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from linpde_gp_tpu.ops.linalg.chol import cholesky as jax_cholesky
from linpde_gp_tpu.ops.linalg.pcg import (
    landmark_indices as jax_landmark_indices,
    nystrom_preconditioner_device as jax_nystrom_device,
)
from linpde_gp_tpu_torch.ops.linalg.chol import cho_solve, cholesky, solve_triangular
from linpde_gp_tpu_torch.ops.linalg.pcg import (
    ff_div,
    ff_dot,
    landmark_indices,
    nystrom_preconditioner_device,
    pcg_ff,
)

torch.set_num_threads(1)


def _spd_system(n=512, cond=1e6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0.0, -np.log10(cond), n)
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    b = rng.standard_normal(n)
    return A.astype(dtype), b.astype(dtype), lam


def test_ff_scalar_helpers():
    a = (torch.tensor(1.0), torch.tensor(1e-9))
    b = (torch.tensor(3.0), torch.tensor(-2e-9))
    q = ff_div(a, b)
    got = float(q[0]) + float(q[1])
    want = (1.0 + 1e-9) / (3.0 - 2e-9)
    assert abs(got - want) < 1e-13

    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000).astype(np.float32)
    y = rng.standard_normal(1000).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    d = ff_dot((xt, torch.zeros_like(xt)), (yt, torch.zeros_like(yt)))
    want = float(x.astype(np.float64) @ y.astype(np.float64))
    assert abs((float(d[0]) + float(d[1])) - want) <= 1e-4 * abs(want) + 1e-5


def _index_block_fn(A):
    """Kernel block of a fixed matrix, with the row index as the point."""
    At = torch.from_numpy(A)
    return lambda x0, x1: At[x0[:, 0].long()][:, x1[:, 0].long()]


def test_pcg_ff_with_preconditioner():
    n = 512
    A, b, _ = _spd_system(n=n, cond=1e5, seed=3)
    sigma = 1e-3
    X = torch.arange(n, dtype=torch.float32)[:, None]
    idx = landmark_indices(n, 64)
    M = nystrom_preconditioner_device(_index_block_fn(A), X, X[idx], sigma)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    res = pcg_ff(lambda v: At @ v[0], M, bt, sigma, tol=1e-6, maxiter=1000)
    res_plain = pcg_ff(lambda v: At @ v[0], None, bt, sigma, tol=1e-6, maxiter=1000)
    assert res.relative_residual <= 2e-6
    assert res.iterations < res_plain.iterations
    x_ref = np.linalg.solve(A.astype(np.float64) + sigma * np.eye(n), b.astype(np.float64))
    assert np.linalg.norm(res.x.double().numpy() - x_ref) <= 1e-4 * (1.0 + np.linalg.norm(x_ref))


def test_pcg_ff_f64_matches_dense_solve():
    n = 300
    A, b, _ = _spd_system(n=n, cond=1e4, seed=4, dtype=np.float64)
    sigma = 1e-3
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    res = pcg_ff(lambda v: At @ v[0], None, bt, sigma, tol=1e-12, maxiter=5000)
    x_ref = np.linalg.solve(A + sigma * np.eye(n), b)
    assert res.relative_residual <= 1e-12
    true_res = np.linalg.norm((A + sigma * np.eye(n)) @ res.x.numpy() - b) / np.linalg.norm(b)
    assert true_res <= 1e-10
    assert np.linalg.norm(res.x.numpy() - x_ref) <= 1e-6 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_ff_zero_rhs(dtype):
    A, _, _ = _spd_system(n=64, seed=5, dtype=np.float64)
    At = torch.from_numpy(A).to(dtype)
    res = pcg_ff(lambda v: At @ v[0], None, torch.zeros(64, dtype=dtype), 1e-3, tol=1e-8)
    assert torch.equal(res.x, torch.zeros(64, dtype=dtype))
    assert res.iterations == 0 and res.relative_residual == 0.0


@pytest.mark.parametrize("n,m", [(512, 64), (600, 128), (1000, 7), (100_000, 8192), (99_991, 4096)])
def test_landmark_indices_match_jax(n, m):
    want = np.asarray(jax_landmark_indices(n, m))
    got = landmark_indices(n, m).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) > 0) and got[-1] < n


def test_nystrom_device_matches_jax_f64():
    """Same build as the JAX package in float64 on one input: the damping
    delta within 1e-6 relative, and the same preconditioner apply."""
    rng = np.random.default_rng(17)
    n, m, sigma = 640, 96, 1e-4
    X = np.sort(rng.uniform(-1, 1, n))[:, None]

    def kfun_jax(x0, x1):
        t = jnp.abs(x0[:, None, 0] - x1[None, :, 0]) * 6.0
        return 3.0 * (1.0 + t + t * t / 3.0) * jnp.exp(-t)

    def kfun(x0, x1):
        t = torch.abs(x0[:, None, 0] - x1[None, :, 0]) * 6.0
        return 3.0 * (1.0 + t + t * t / 3.0) * torch.exp(-t)

    idx = np.asarray(jax_landmark_indices(n, m))
    M_j = jax_nystrom_device(kfun_jax, jnp.asarray(X), jnp.asarray(X[idx]), sigma)
    Xt = torch.from_numpy(X)
    M_t = nystrom_preconditioner_device(kfun, Xt, Xt[landmark_indices(n, m)], sigma)
    assert abs(float(M_t.delta) - float(M_j.delta)) <= 1e-6 * float(M_j.delta)
    r = rng.standard_normal(n)
    want = np.asarray(M_j(jnp.asarray(r)))
    got = M_t(torch.from_numpy(r)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_cholesky_escalates_jitter_like_jax():
    """A singular PSD matrix: the first factorization fails and both
    packages retry on the same jitter ladder."""
    rng = np.random.default_rng(6)
    G = rng.standard_normal((40, 8))
    K = G @ G.T  # rank 8
    got = cholesky(torch.from_numpy(K)).numpy()
    want = np.asarray(jax_cholesky(jnp.asarray(K), jitter=0.0))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got @ got.T, K, atol=1e-8 * np.abs(K).max())
    # The factor's null-space part is round-off, so compare the jitter
    # each factor absorbed: the same rung of the ladder.
    jit_got = np.mean(np.diag(got @ got.T - K))
    jit_want = np.mean(np.diag(want @ want.T - K))
    assert jit_want > 0 and abs(jit_got - jit_want) <= 0.01 * jit_want


def test_cholesky_raises_when_every_rung_fails():
    K = -np.eye(4)
    with pytest.raises(torch.linalg.LinAlgError):
        cholesky(torch.from_numpy(K))


def test_triangular_solves_match_scipy():
    A, b, _ = _spd_system(n=50, cond=1e3, seed=7, dtype=np.float64)
    L = cholesky(torch.from_numpy(A))
    Ln = L.numpy()
    bt = torch.from_numpy(b)
    np.testing.assert_allclose(
        solve_triangular(L, bt).numpy(), scipy.linalg.solve_triangular(Ln, b, lower=True), rtol=1e-12
    )
    np.testing.assert_allclose(
        solve_triangular(L, bt, trans=True).numpy(),
        scipy.linalg.solve_triangular(Ln, b, lower=True, trans=1),
        rtol=1e-12,
    )
    np.testing.assert_allclose(cho_solve(L, bt).numpy(), np.linalg.solve(A, b), rtol=1e-9)


def test_pcg_ff_stops_on_breakdown_without_nan():
    """Asked for more than float32 resolves, preconditioned CG on the heat
    Gram reaches r.z <= 0 (near relres 3e-7 here); it must stop there with
    the last finite iterate instead of dividing by it."""
    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.specs import load_specs

    specs = load_specs()
    rng = np.random.default_rng(2)
    X = np.stack([rng.uniform(0, 5, 600), rng.uniform(-1, 1, 600)], -1)
    reg = IterativeGPRegressor.from_specs(
        specs["obs"], specs["cross"], X, rng.standard_normal(600), noise_variance=1e-4, tol=1e-12,
        precond_rank=128, mode="plain", device="cpu",
    )
    w = reg.representer_weights
    it, rr = reg.solve_info
    assert torch.isfinite(w).all()
    assert it < 512 and 1e-12 < rr < 1e-5
