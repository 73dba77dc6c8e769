"""The port's parametric kernels and parametric GPs against the JAX package.

``ParametricCovarianceFunction`` (``phi(x0)^T Sigma phi(x1)``),
``GalerkinCovarianceFunction`` (the FEM-projected process's kernel, with
its cached ``k P*`` and ``P k P*``; the JAX suite has no test of it) and
``ParametricGaussianProcess``, float64 on the CPU, on the same seeded
inputs, within 1e-12 of the values' scale (closed forms through the same
float64 arithmetic in another order).  The Galerkin kernel's ``P k P*``
and matrix within ``GALERKIN_TOL``: ``M^-1 G M^-T`` of the double-projection
Gram ``G``, whose primitive differences cancel, reads 1.4e-12 off the JAX
package's at nu = 3/2, and the JAX package's own matrix is symmetric only
to 4.8e-13 of its scale (both measured on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.kernels import GalerkinCovarianceFunction, ParametricCovarianceFunction

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

TOL = 1e-12
GALERKIN_TOL = 1e-11


def _close(port, ref, tol=TOL):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * np.max(np.abs(ref)))


def _sigma(m, seed=3):
    a = np.random.default_rng(seed).standard_normal((m, m))
    return a @ a.T + 0.1 * np.eye(m)


def _basis(pkg, zero_boundary=False):
    return pkg.functions.UnivariateLinearInterpolationBasis(np.linspace(-1.0, 1.0, 8), zero_boundary=zero_boundary)


@pytest.mark.parametrize("zero_boundary", [False, True])
def test_parametric_covariance_function(zero_boundary):
    basis, jbasis = _basis(lgt, zero_boundary), _basis(jlgt, zero_boundary)
    S = _sigma(len(basis))
    k = ParametricCovarianceFunction(basis, lgt.ops.linalg.Covariance(S, basis.output_shape, basis.output_shape))
    jk = jlgt.kernels.ParametricCovarianceFunction(
        jbasis, jlgt.ops.linalg.Covariance(jnp.asarray(S), jbasis.output_shape, jbasis.output_shape)
    )
    rng = np.random.default_rng(0)
    x0, x1 = rng.uniform(-1.2, 1.2, 9), rng.uniform(-1.2, 1.2, 7)
    G = k.matrix(torch.from_numpy(x0), torch.from_numpy(x1))
    _close(G, jk.matrix(jnp.asarray(x0), jnp.asarray(x1)))
    # phi(x0)^T Sigma phi(x1) by hand.
    phi0, phi1 = basis(x0).numpy(), basis(x1).numpy()
    np.testing.assert_allclose(G.numpy(), phi0 @ S @ phi1.T, rtol=0, atol=1e-13 * np.abs(G.numpy()).max())
    with pytest.raises(ValueError):
        ParametricCovarianceFunction(basis, lgt.ops.linalg.Covariance(np.eye(3), (3,), (3,)))


@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_galerkin_covariance_function(nu):
    """The Galerkin kernel of a Matérn prior under the trial basis's L2
    projection: its cached ``P k P*`` (the exact double-projection Gram),
    ``k P*`` at points, and the kernel's matrix, against the JAX package."""
    def make(pkg):
        proj = _basis(pkg).l2_projection()
        return GalerkinCovarianceFunction if pkg is lgt else pkg.kernels.GalerkinCovarianceFunction, proj, (
            1.3 * pkg.kernels.Matern((), nu=nu, lengthscales=0.6)
        )

    cls, proj, k = make(lgt)
    jcls, jproj, jk = make(jlgt)
    g, jg = cls(k, proj), jcls(jk, jproj)
    assert g.P is proj and g.input_shape == () and g.output_shape_0 == ()
    _close(g.PkP.matrix, jg.PkP.matrix, GALERKIN_TOL)
    x = np.random.default_rng(1).uniform(-1.0, 1.0, 11)
    _close(g.kPa(torch.from_numpy(x)), jg.kPa(jnp.asarray(x)))
    G = g.matrix(torch.from_numpy(x))
    _close(G, jg.matrix(jnp.asarray(x)), GALERKIN_TOL)
    np.testing.assert_allclose(G.numpy(), G.numpy().T, rtol=0, atol=GALERKIN_TOL * np.abs(G.numpy()).max())


def test_parametric_gaussian_process():
    """A parametric GP on the hat basis with Gaussian weights: mean, std and
    covariance against the JAX package's, and on the weights' device."""
    m = len(_basis(lgt))
    mean, S = np.random.default_rng(2).standard_normal(m), _sigma(m, 4)
    gp = lgt.ParametricGaussianProcess(weights=lgt.Normal(mean, S), feature_fn=_basis(lgt))
    jgp = jlgt.models.ParametricGaussianProcess(weights=jlgt.Normal(mean, S), feature_fn=_basis(jlgt))
    assert gp.device == torch.device("cpu") and gp.feature_fn.output_shape == (m,)
    x = np.linspace(-1.0, 1.0, 17)
    _close(gp.mean(x), jgp.mean(jnp.asarray(x)))
    _close(gp.std(x), jgp.std(jnp.asarray(x)))
    _close(gp.cov.matrix(torch.from_numpy(x)), jgp.cov.matrix(jnp.asarray(x)))
    # A scalar feature function takes the scalar weight.
    f = lgt.functions.Polynomial((0.0, 1.0))
    sgp = lgt.ParametricGaussianProcess(weights=lgt.Normal(np.asarray(2.0), np.asarray(0.25)), feature_fn=f)
    np.testing.assert_allclose(sgp.mean(x).numpy(), 2.0 * x, rtol=1e-15)
    np.testing.assert_allclose(sgp.std(x).numpy(), 0.5 * np.abs(x), rtol=1e-15)
