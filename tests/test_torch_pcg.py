"""Float-float CG, the Nyström preconditioner and the robust Cholesky of
the PyTorch port, against the JAX package and dense solves.

Ports of ``tests/test_pcg_r5.py::test_ff_scalar_helpers``,
``::test_pcg_ff_with_preconditioner`` and
``tests/test_linalg.py::test_pcg_block_matches_direct_solve`` (same inputs
and bounds), plus agreement with the JAX package's ``landmark_indices``,
``nystrom_preconditioner_device``, ``cholesky``, ``pcg_block`` and
``ff_dot_cols``.  Zero right-hand sides are checked against the dense
answer (0), not against the JAX package, which returns NaN there; the
blocked CG's frozen, non-finite and cancelling columns against what the
port fixes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from linpde_gp_tpu.ops.ff import ff_const as jax_ff_const
from linpde_gp_tpu.ops.linalg.chol import cholesky as jax_cholesky
from linpde_gp_tpu.ops.linalg.pcg import (
    ff_dot_cols as jax_ff_dot_cols,
    landmark_indices as jax_landmark_indices,
    make_pcg_block_ff_programs as jax_block_ff_programs,
    nystrom_preconditioner_device as jax_nystrom_device,
    pcg_block as jax_pcg_block,
)
from linpde_gp_tpu_torch.ops.linalg import pcg
from linpde_gp_tpu_torch.ops.linalg.chol import cho_solve, cholesky, solve_triangular
from linpde_gp_tpu_torch.ops.linalg.pcg import (
    ff_div,
    ff_dot,
    ff_dot_cols,
    ff_norm2_cols,
    landmark_indices,
    nystrom_panel_width,
    nystrom_preconditioner_device,
    nystrom_products,
    pcg_block,
    pcg_block_ff,
    pcg_ff,
)
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


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


def _matern52_2d(x0, x1):
    """Matérn 5/2 at length scale 1/20 on 2-D points: a well-conditioned
    ``K_ZZ`` at 1,024 landmarks in [-1, 1]^2, so ``B`` carries no
    cancellation beyond its products' rounding."""
    d = torch.sqrt(((x0[:, None] - x1[None]) ** 2).sum(-1)) * 20.0
    return 2.0 * (1.0 + d + d * d / 3.0) * torch.exp(-d)


def _matern52_2d_jax(x0, x1):
    d = jnp.sqrt(((x0[:, None] - x1[None]) ** 2).sum(-1)) * 20.0
    return 2.0 * (1.0 + d + d * d / 3.0) * jnp.exp(-d)


def _nystrom_case(n, m, seed=23):
    """Points, landmarks, ``K_XZ`` and ``L^{-T}`` as the device build forms them."""
    X = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (n, 2)))
    Z = X[landmark_indices(n, m)]
    K_ZZ = _matern52_2d(Z, Z)
    K_ZZ = 0.5 * (K_ZZ + K_ZZ.T)
    eye = torch.eye(m, dtype=torch.float64)
    L = cholesky(K_ZZ + 8.0 * torch.finfo(torch.float64).eps * float(torch.linalg.eigvalsh(K_ZZ)[-1]) * eye)
    return X, Z, _matern52_2d(X, Z), torch.linalg.solve_triangular(L, eye, upper=False).T


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m,want", [(96, 96), (1000, 1000), (1024, 128), (4096, 512), (8192, 1024), (8000, 1024)])
def test_nystrom_panel_width(m, want):
    """Eight panels, each a multiple of 128 wide, from rank 1,024 on; one below."""
    assert nystrom_panel_width(m) == want


@pytest.mark.parametrize("n,m,nb", [(4096, 1024, None), (4096, 1000, 128)])
def test_nystrom_panels_match_single_product(n, m, nb, monkeypatch):
    """The panelled products against the single ones on the same inputs (the
    default eight panels at rank 1,024; a ragged last panel at 1,000): ``B``
    and ``C0`` at rounding level, ``C0`` exactly symmetric, and the build's
    ``delta`` and Woodbury apply the same."""
    X, Z, K_XZ, L_inv_T = _nystrom_case(n, m)
    assert torch.equal(torch.tril(L_inv_T, -1), torch.zeros_like(L_inv_T))
    B1, C1 = nystrom_products(K_XZ, L_inv_T, nb=m)
    B2, C2 = nystrom_products(K_XZ, L_inv_T, nb=nb)
    assert _rel(B2, B1) <= 1e-12 and _rel(C2, C1) <= 1e-12
    assert torch.equal(C2, C2.T)
    sigma, width = 1e-2, nb or nystrom_panel_width(m)
    monkeypatch.setattr(pcg, "nystrom_panel_width", lambda m: m)
    M1 = nystrom_preconditioner_device(_matern52_2d, X, Z, sigma)
    monkeypatch.setattr(pcg, "nystrom_panel_width", lambda m: width)
    M2 = nystrom_preconditioner_device(_matern52_2d, X, Z, sigma)
    assert abs(float(M2.delta) - float(M1.delta)) <= 1e-9 * float(M1.delta)
    r = torch.from_numpy(np.random.default_rng(5).standard_normal(n))
    assert _rel(M2(r), M1(r)) <= 1e-10


@pytest.mark.parametrize("m,spans", [(1024, 1), (1000, 0)])
def test_nystrom_panels_span_once_per_build(m, spans):
    """``lgt.nystrom.panels`` marks each build that takes the panelled route."""
    X, Z, _, _ = _nystrom_case(1100, m)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        nystrom_preconditioner_device(_matern52_2d, X, Z, 1e-2)
    assert sum(e.name == "lgt.nystrom.panels" for e in prof.events()) == spans


def test_nystrom_panels_match_jax_f64():
    """The build at rank 1,024, where the panels engage by default, against
    the JAX package's single products: ``delta`` within 1e-6 relative and
    the same preconditioner apply."""
    n, m, sigma = 2048, 1024, 1e-2
    X, Z, _, _ = _nystrom_case(n, m, seed=29)
    Xj = jnp.asarray(X.numpy())
    M_j = jax_nystrom_device(_matern52_2d_jax, Xj, Xj[np.asarray(jax_landmark_indices(n, m))], sigma)
    M_t = nystrom_preconditioner_device(_matern52_2d, X, Z, sigma)
    assert abs(float(M_t.delta) - float(M_j.delta)) <= 1e-6 * float(M_j.delta)
    r = np.random.default_rng(31).standard_normal(n)
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


# -- blocked CG -------------------------------------------------------------------


def _block_system():
    """test_linalg.py::test_pcg_block_matches_direct_solve's input."""
    rng = np.random.default_rng(5)
    A0 = rng.standard_normal((60, 60))
    return A0 @ A0.T + 60 * np.eye(60), rng.standard_normal((60, 7))


def test_pcg_block_matches_direct_solve():
    """Port of test_linalg.py::test_pcg_block_matches_direct_solve (same
    input and bounds), also held against the JAX pcg_block's solution."""
    A, B = _block_system()
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    res = pcg_block(lambda v: At @ v, Bt, tol=1e-12, maxiter=300)
    X_ref = np.linalg.solve(A, B)
    np.testing.assert_allclose(res.x.numpy(), X_ref, rtol=1e-8, atol=1e-9)
    assert res.relative_residual < 1e-10
    want = jax_pcg_block(lambda v: jnp.asarray(A) @ v, jnp.asarray(B), tol=1e-12, maxiter=300)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_block_ff_matches_direct_solve(dtype):
    """The same system through pcg_block_ff, shifted by sigma^2 = 1e-3.  In
    float64 at tol 1e-12 the bounds of the test above; in float32 with ff
    state and an f32 matvec, tol 1e-6 and 1e-5 of max|X| (the f32 matvec
    leaves ~eps32 cond ~ 1e-6 relative error)."""
    A, B = _block_system()
    At, Bt = torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    lo_planes = []

    def mv(p):
        lo_planes.append(bool((p[1] != 0).any()))
        return At @ p[0]

    res = pcg_block_ff(mv, None, Bt, 1e-3, tol=tol, maxiter=300)
    assert any(lo_planes)  # the matvec is handed the ff pair (P_hi, P_lo)
    X_ref = np.linalg.solve(A + 1e-3 * np.eye(60), B)
    X = res.x.double().numpy() + res.x_lo.double().numpy()
    assert res.relative_residual <= tol and 0 < res.iterations < 300
    if dtype == torch.float64:
        np.testing.assert_allclose(X, X_ref, rtol=1e-8, atol=1e-9)
    else:
        assert np.max(np.abs(X - X_ref)) <= 1e-5 * np.abs(X_ref).max()


def test_pcg_block_ff_with_preconditioner():
    """test_pcg_ff_with_preconditioner's system with 5 right-hand sides in
    float32: the Nystrom apply takes (n, r), cuts the iterations, and each
    column meets the single-vector test's bound."""
    n = 512
    A, b, _ = _spd_system(n=n, cond=1e5, seed=3)
    sigma = 1e-3
    X = torch.arange(n, dtype=torch.float32)[:, None]
    M = nystrom_preconditioner_device(_index_block_fn(A), X, X[landmark_indices(n, 64)], sigma)
    B = np.stack([b, np.roll(b, 7), b[::-1], np.sin(np.arange(n, dtype=np.float32)), np.ones(n, np.float32)], 1)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B.astype(np.float32))
    res = pcg_block_ff(lambda v: At @ v[0], M, Bt, sigma, tol=1e-6, maxiter=1000)
    res_plain = pcg_block_ff(lambda v: At @ v[0], None, Bt, sigma, tol=1e-6, maxiter=1000)
    assert res.relative_residual <= 1e-6 and res.iterations < res_plain.iterations
    X_ref = np.linalg.solve(A.astype(np.float64) + sigma * np.eye(n), B.astype(np.float64))
    err = np.linalg.norm(res.x.double().numpy() - X_ref, axis=0)
    assert np.all(err <= 1e-4 * (1.0 + np.linalg.norm(X_ref, axis=0)))


def test_pcg_block_ff_freezes_zero_and_converged_columns():
    """Float64: a zero column returns exactly 0 (not NaN) and its search
    direction stays 0; a unit vector of a diagonal system converges at
    iteration 1 and is frozen after it, bit for bit, while the random
    columns run on."""
    n = 32
    d = np.linspace(1.0, 4.0, n)
    rng = np.random.default_rng(9)
    B = np.zeros((n, 4))
    B[3, 1] = 1.0
    B[:, 2:] = rng.standard_normal((n, 2))
    dt, Bt = torch.from_numpy(d)[:, None], torch.from_numpy(B)
    seen = []

    def mv(p):
        seen.append(p[0].clone())
        return dt * p[0]

    one = pcg_block_ff(mv, None, Bt, 1e-3, tol=1e-12, maxiter=1)
    full = pcg_block_ff(mv, None, Bt, 1e-3, tol=1e-12, maxiter=200)
    assert full.iterations > 2 and full.relative_residual <= 1e-12
    zero = torch.zeros(n, dtype=torch.float64)
    assert torch.equal(full.x[:, 0], zero) and torch.equal(full.x_lo[:, 0], zero)
    assert torch.equal(full.x[:, 1], one.x[:, 1]) and torch.equal(full.x_lo[:, 1], one.x_lo[:, 1])
    assert all(torch.equal(p[:, 0], zero) for p in seen)
    X_ref = B / (d[:, None] + 1e-3)
    np.testing.assert_allclose(full.x.numpy(), X_ref, rtol=0, atol=1e-11 * np.abs(X_ref).max())


def test_pcg_block_ff_nonfinite_column_keeps_last_iterate():
    """A column whose matvec turns non-finite at iteration 3 stops with its
    iterate from iteration 2; the other columns converge."""
    A, B = _block_system()
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    calls = []

    def mv(p):
        calls.append(None)
        out = At @ p[0]
        if len(calls) == 3:
            out[:, 4] = float("nan")
        return out

    two = pcg_block_ff(lambda p: At @ p[0], None, Bt, 1e-3, tol=1e-12, maxiter=2)
    res = pcg_block_ff(mv, None, Bt, 1e-3, tol=1e-12, maxiter=300)
    assert torch.isfinite(res.x).all()
    assert torch.equal(res.x[:, 4], two.x[:, 4])
    X_ref = np.linalg.solve(A + 1e-3 * np.eye(60), B)
    keep = [0, 1, 2, 3, 5, 6]
    np.testing.assert_allclose(res.x.numpy()[:, keep], X_ref[:, keep], rtol=1e-8, atol=1e-9)


def test_pcg_block_ff_cancelling_planes_do_not_converge():
    """The JAX pcg_block_ff tests ``ff_dot_cols(R, R)[0]``: once a column's
    residual planes cancel (|lo| > |hi| / 2, opposite signs) that hi plane
    reads <= 0 and the column counts as converged.  Two CG steps of JAX's
    programs on a 2 x 2 float32 system leave such columns with a true
    residual ~1e-8 of ||b||, above tol = 1e-10; the port's measure,
    ``||hi + lo||^2``, reads them unconverged, and its CG runs on."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((2, 2)))
    A = ((Q * np.logspace(0, -1, 2)) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    B = rng.standard_normal((2, 64)).astype(np.float32)
    tol, r = 1e-10, B.shape[1]
    step_a, step_b = jax_block_ff_programs(lambda aux, v: aux @ v, None)
    Bj = jnp.asarray(B)
    zero = jnp.zeros_like(Bj)
    sigma = tuple(jnp.asarray(c, jnp.float32) for c in jax_ff_const(1e-3, jnp.float32))
    active = jnp.ones(r, bool)
    P, rz = step_b(None, (Bj, zero), (zero, zero), (zero, zero),
                   (jnp.ones(r, jnp.float32), jnp.zeros(r, jnp.float32)), active)
    X, R = (zero, zero), (Bj, zero)
    for _ in range(2):
        R_old = R
        X, R, _ = step_a(jnp.asarray(A), sigma, X, P, R, rz, active)
        P, rz = step_b(None, R, R_old, P, rz, active)
    threshold2 = tol**2 * np.sum(B.astype(np.float64) ** 2, 0)
    jax_hi = np.asarray(jax_ff_dot_cols(R, R)[0], np.float64)
    R_t = tuple(torch.from_numpy(np.array(c)) for c in R)
    port = ff_norm2_cols(R_t).double().numpy()
    cancelled = jax_hi <= 0
    assert cancelled.sum() >= 5  # 23 of the 64 columns on this input
    assert np.all(port[cancelled] > threshold2[cancelled])
    # ff_dot_cols itself is the port of JAX's, plane for plane.
    hi, lo = ff_dot_cols(R_t, R_t)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jax_ff_dot_cols(R, R)[0]))
    # The port's CG on the same system does not stop there.
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    res = pcg_block_ff(lambda p: At @ p[0], None, Bt, 1e-3, tol=tol, maxiter=3)
    assert res.iterations == 3 and res.relative_residual > tol
