"""The port's dense linear algebra against the JAX package.

Ports of ``tests/test_linalg.py`` (``chol_extend``, triangular solves,
``Kronecker``, block operators, ``Covariance`` views, the Cholesky jitter
ladder, the linop solve surface, the plain ``pcg`` and the posterior
checkpoint): each keeps the JAX original's check and tolerance and holds
the port's result to the JAX function's on the same seeded numpy inputs.
The variance's blocked substitution (``panel_inverses``,
``panel_solve_sumsq``), which the JAX package leaves to XLA, is held to
``torch.linalg.solve_triangular`` at small panels.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import linpde_gp_tpu.ops.linalg as jla
from linpde_gp_tpu.ops.linalg.pcg import pcg as jpcg
from linpde_gp_tpu_torch.ops.linalg import (
    Block,
    BlockDiagonal,
    Covariance,
    Dense,
    Diagonal,
    Kronecker,
    cho_solve,
    chol_extend,
    cholesky,
    logdet_from_chol,
    solve_triangular,
)
from linpde_gp_tpu_torch.ops.linalg import chol as chol_ops
from linpde_gp_tpu_torch.ops.linalg.chol import panel_inverses, panel_solve_sumsq
from linpde_gp_tpu_torch.ops.linalg.pcg import pcg
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def T(a):
    return torch.as_tensor(np.asarray(a))


def test_chol_extend_matches_direct(rng):
    n, m = 10, 4
    K = random_spd(rng, n + m)
    A, B, D = K[:n, :n], K[:n, n:], K[n:, n:]
    chol_A = cholesky(T(A))
    D_t = T(D).clone()
    ext = chol_extend(chol_A, T(B), D_t)
    c = np.linalg.solve(np.linalg.cholesky(A), B)
    np.testing.assert_allclose(D_t.numpy(), D - c.T @ c, atol=1e-12)  # the block holds the Schur complement
    direct = cholesky(T(K))
    np.testing.assert_allclose(ext.numpy(), direct.numpy(), atol=1e-9)
    b = rng.standard_normal(n + m)
    x = cho_solve(ext, T(b))
    np.testing.assert_allclose(K @ x.numpy(), b, atol=1e-8)
    jext = jla.chol_extend(jla.cholesky(jnp.asarray(A)), jnp.asarray(B), jnp.asarray(D))
    np.testing.assert_allclose(ext.numpy(), np.asarray(jext), atol=1e-12)
    np.testing.assert_allclose(float(logdet_from_chol(ext)), float(jla.logdet_from_chol(jext)), rtol=1e-12)


def test_triangular_solve_trans(rng):
    K = random_spd(rng, 8)
    chol = cholesky(T(K))
    b = rng.standard_normal((8, 3))
    y = solve_triangular(chol, T(b))
    np.testing.assert_allclose(chol.numpy() @ y.numpy(), b, atol=1e-10)
    z = solve_triangular(chol, T(b), trans=True)
    np.testing.assert_allclose(chol.numpy().T @ z.numpy(), b, atol=1e-10)
    jchol = jla.cholesky(jnp.asarray(K))
    np.testing.assert_allclose(z.numpy(), np.asarray(jla.solve_triangular(jchol, jnp.asarray(b), trans=True)),
                               atol=1e-12)


def test_kronecker_matmul(rng):
    A = rng.standard_normal((3, 4))
    B = rng.standard_normal((5, 2))
    op = Kronecker(Dense(A), Dense(B))
    x = rng.standard_normal((8, 6))
    expected = np.kron(A, B) @ x
    np.testing.assert_allclose((op @ x).numpy(), expected, atol=1e-12)
    np.testing.assert_allclose(op.todense().numpy(), np.kron(A, B), atol=1e-12)
    np.testing.assert_allclose((op @ x[:, 0]).numpy(), expected[:, 0], atol=1e-12)
    jop = jla.Kronecker(jla.Dense(A), jla.Dense(B))
    np.testing.assert_allclose((op @ x).numpy(), np.asarray(jop @ x), atol=1e-12)
    np.testing.assert_allclose(op.diagonal().numpy(), np.asarray(jop.diagonal()), atol=1e-12)


def test_block_ops(rng):
    blocks = [[rng.standard_normal((2, 3)), rng.standard_normal((2, 4))],
              [rng.standard_normal((5, 3)), rng.standard_normal((5, 4))]]
    op = Block(blocks)
    dense = np.block(blocks)
    np.testing.assert_allclose(op.todense().numpy(), dense, atol=1e-12)
    np.testing.assert_allclose(op.T.todense().numpy(), dense.T, atol=1e-12)
    d0 = rng.standard_normal((2, 2))
    bd = BlockDiagonal([Dense(d0), Diagonal(np.asarray([1.0, 2.0]))])
    d = bd.todense().numpy()
    assert d.shape == (4, 4)
    np.testing.assert_allclose(d[2:, 2:], np.diag([1.0, 2.0]))
    np.testing.assert_allclose(d[:2, 2:], 0.0)
    jbd = jla.BlockDiagonal([jla.Dense(d0), jla.Diagonal(jnp.asarray([1.0, 2.0]))])
    np.testing.assert_array_equal(d, np.asarray(jbd.todense()))
    np.testing.assert_array_equal(op.todense().numpy(), np.asarray(jla.Block(blocks).todense()))


def test_covariance_views():
    arr = np.arange(24.0).reshape(2, 3, 4)
    cov = Covariance(T(arr), (2, 3), (4,))
    assert cov.matrix.shape == (6, 4)
    np.testing.assert_allclose(cov.matrix.numpy(), np.arange(24.0).reshape(6, 4))
    covT = cov.T
    assert covT.shape0 == (4,)
    np.testing.assert_allclose(covT.matrix.numpy(), np.arange(24.0).reshape(6, 4).T)
    jcov = jla.Covariance(jnp.asarray(arr), (2, 3), (4,))
    np.testing.assert_array_equal(covT.array.numpy(), np.asarray(jcov.T.array))
    # The diagonal form has the dense form's views and arithmetic.
    d = np.asarray([1.0, 2.0, 3.0, 4.0])
    diag = Covariance.from_diagonal(T(d), (2, 2))
    dense = Covariance(T(np.diag(d)), (2, 2), (2, 2))
    np.testing.assert_array_equal(diag.array.numpy(), dense.array.numpy())
    np.testing.assert_array_equal((2.0 * diag + diag).matrix.numpy(), (2.0 * dense + dense).matrix.numpy())
    np.testing.assert_array_equal((diag + dense).matrix.numpy(), 2.0 * np.diag(d))
    g = torch.ones(4, 4, dtype=torch.float64)
    np.testing.assert_array_equal(diag.add_to_(g.clone()).numpy(), dense.add_to_(g.clone()).numpy())


def test_cholesky_auto_jitter_on_singular():
    """A rank-deficient SPD matrix still yields a finite factor (JAX retries
    on NaNs, the port on cholesky_ex's info); one that no rung of the ladder
    rescues raises."""
    gram = T(np.ones((6, 6)))
    chol = cholesky(gram)
    assert not bool(torch.isnan(chol).any())
    jchol = jla.cholesky(jnp.asarray(np.ones((6, 6))))
    np.testing.assert_allclose(chol.numpy(), np.asarray(jchol), atol=1e-7)
    with pytest.raises(torch.linalg.LinAlgError):
        cholesky(T(-np.eye(3)))


def test_linop_solve_surface(rng):
    K = random_spd(rng, 7)
    op = Dense(T(K))
    b = rng.standard_normal(7)
    np.testing.assert_allclose(K @ op.solve(b).numpy(), b, atol=1e-9)
    L = op.cholesky().numpy()
    np.testing.assert_allclose(L @ L.T, K, atol=1e-9)
    np.testing.assert_allclose((op.inv() @ T(K)).numpy(), np.eye(7), atol=1e-8)
    jop = jla.Dense(jnp.asarray(K))
    np.testing.assert_allclose(op.solve(b).numpy(), np.asarray(jop.solve(b)), atol=1e-12)
    np.testing.assert_allclose(L, np.asarray(jop.cholesky()), atol=1e-12)


def test_pcg_matches_dense_solve():
    rng_ = np.random.default_rng(7)
    A0 = rng_.standard_normal((40, 40))
    A = A0 @ A0.T + 40 * np.eye(40)
    b = rng_.standard_normal(40)
    res = pcg(lambda v: T(A) @ v, T(b), tol=1e-12, maxiter=200)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b), atol=1e-9)
    assert int(res.iterations) <= 200
    assert float(res.relative_residual) < 1e-11
    jres = jpcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12, maxiter=200)
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-12)


def test_pcg_zero_rhs():
    A = torch.eye(5, dtype=torch.float64)
    res = pcg(lambda v: A @ v, torch.zeros(5, dtype=torch.float64), tol=1e-10, maxiter=10)
    np.testing.assert_allclose(res.x.numpy(), np.zeros(5))
    assert int(res.iterations) == 0
    jres = jpcg(lambda v: jnp.eye(5) @ v, jnp.zeros(5), tol=1e-10, maxiter=10)
    assert int(jres.iterations) == 0


def test_posterior_checkpoint_roundtrip(rng, tmp_path):
    """save_posterior / load_posterior round-trip a dense posterior (plain
    Cholesky solver), and conditioning goes on from the restored state."""
    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.utils.serialization import load_posterior, save_posterior

    prior = lgt.GaussianProcess(lgt.functions.Zero(()), 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.7))
    X = rng.uniform(-1, 1, 6)
    post = prior.condition_on_observations(np.sin(X), X=X, L=lgt.diffops.Derivative(2))
    path = tmp_path / "posterior.pt"
    save_posterior(path, post)
    restored = load_posterior(path, device="cpu")
    assert restored.device == torch.device("cpu") and restored.prior.device == torch.device("cpu")
    xq = np.linspace(-1, 1, 9)
    np.testing.assert_allclose(restored.mean(xq).numpy(), post.mean(xq).numpy(), atol=1e-12)
    np.testing.assert_allclose(restored.std(xq).numpy(), post.std(xq).numpy(), atol=1e-12)
    more = restored.condition_on_observations(np.asarray([0.0]), X=np.asarray([0.5]))
    assert np.isfinite(float(more.mean(np.asarray(0.3))))
    ref = post.condition_on_observations(np.asarray([0.0]), X=np.asarray([0.5]))
    np.testing.assert_allclose(more.mean(xq).numpy(), ref.mean(xq).numpy(), atol=1e-12)


def _factor(rng, n):
    return torch.linalg.cholesky(T(random_spd(rng, n) / n))


@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("b", [1, 7, 67])
@pytest.mark.parametrize("refine", [False, True])
def test_panel_solve_sumsq_matches_substitution(rng, monkeypatch, n, b, refine):
    """Panels of 64 rows, n a multiple of them and not, each panel's solve
    refined or not: the column norms of L^-1 u within 1e-12 of the
    substitution's; u is left as it was."""
    monkeypatch.setattr(chol_ops, "_REFINE_COND", 0.0 if refine else math.inf)
    L = _factor(rng, n)
    u = T(rng.standard_normal((n, b)))
    u0 = u.clone()
    panels = panel_inverses(L, 64)
    assert all((p is not None) == refine for p in panels.refine)
    sumsq = panel_solve_sumsq(L, panels, u)
    norm = torch.linalg.vector_norm(torch.linalg.solve_triangular(L, u, upper=False), dim=0)
    assert sumsq.shape == (b,) and torch.equal(u, u0)
    assert torch.all((sumsq.sqrt() - norm).abs() <= 1e-12 * norm)


def test_panel_inverses_match_per_panel_solves(rng):
    """Each panel's inverse as its own triangular solve against I, the
    ragged last one padded with I; a panel is kept for refinement where its
    condition number exceeds the bound, and only there."""
    n, nb = 250, 64
    L = _factor(rng, n)
    L[nb:2 * nb, nb:2 * nb].diagonal().mul_(torch.logspace(0, -4, nb, dtype=torch.float64))
    panels = panel_inverses(L, nb)
    assert panels.inverses.shape == (4, nb, nb) and panels.inverses.dtype == torch.float64
    for k, k0 in enumerate(range(0, n, nb)):
        r = min(nb, n - k0)
        block = L[k0:k0 + r, k0:k0 + r]
        ref = torch.linalg.solve_triangular(block, torch.eye(r, dtype=torch.float64), upper=False)
        inv = panels.inverses[k]
        assert (inv[:r, :r] - ref).abs().max() <= 1e-12 * ref.abs().max()
        assert torch.equal(inv[r:, r:], torch.eye(nb - r, dtype=torch.float64))
        assert not inv[r:, :r].any() and not inv[:r, r:].any()
        cond = torch.linalg.cond(block, p=math.inf)
        assert (panels.refine[k] is not None) == bool(cond > chol_ops._REFINE_COND)
        if panels.refine[k] is not None:
            assert torch.equal(panels.refine[k][:r, :r], block)
    assert [p is not None for p in panels.refine] == [False, True, False, False]


def test_posterior_checkpoint_without_panel_inverses(rng, tmp_path, monkeypatch):
    """A posterior whose std built its panel inverses (panels of 8 rows, a
    factor of 20) is written without them, and std after loading, which
    builds them again, equals std before."""
    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.utils.serialization import load_posterior, save_posterior

    monkeypatch.setattr(chol_ops, "PANEL_ROWS", 8)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5, lengthscales=0.7))
    X = np.sort(rng.uniform(-1, 1, 20))
    post = prior.condition_on_observations(np.sin(X), X=X, b=lgt.Normal(np.zeros(20), np.full(20, 1e-4)))
    xq = np.linspace(-1, 1, 9)
    sd = post.std(xq)
    assert post._panels.inverses.shape == (3, 8, 8)
    assert "_panels" not in post.__getstate__()
    path = tmp_path / "posterior.pt"
    save_posterior(path, post)
    restored = load_posterior(path, device="cpu")
    assert restored._panels is None
    assert torch.equal(restored.std(xq), sd)
    assert torch.equal(restored._panels.inverses, post._panels.inverses)
