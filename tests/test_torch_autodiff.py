"""Operators on functions and the autodiff kernel route of the PyTorch port,
against the JAX package's ``apply_operator`` (on the CPU, float64, points
from numpy seeds).

- Each exact shortcut of ``apply_diffop_to_function`` returns the JAX
  package's class with the same data: ``Zero`` stays zero, a ``Constant``
  keeps its order-0 terms (or becomes zero), a 1-D ``Polynomial`` and a
  ``Piecewise`` of polynomials are differentiated symbolically
  (coefficients equal to 1e-15 relative); output selection on a
  ``StackedFunction`` returns its component.
- Everything else is a ``DiffopFunction`` of nested ``torch.func.jvp``:
  the heat operator (its second-order ``d^2/dx^2`` nests two jvps), the
  Laplacian, a mixed partial, a directional derivative, and scaled, summed
  and composite operators, on ``LambdaFunction``\\ s and a sum of functions;
  values within 1e-12 of the JAX package's (relative to max |value|), in
  float64.
- ``AutodiffTransformedKernel`` (ExpQuad in 2-D with the autodiff route
  forced) against the JAX package's off the diagonal within 1e-12, and
  against the port's own closed form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.transforms import AutodiffTransformedKernel as JaxAutodiffKernel
from linpde_gp_tpu.ops.transforms import as_coefficients as jax_as_coefficients
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.transforms import (
    AutodiffTransformedKernel,
    DiffopFunction,
    apply_operator_to_kernel,
    as_coefficients,
)

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

X2 = np.random.default_rng(31).uniform(-1.0, 1.0, (17, 2))
X1 = np.random.default_rng(32).uniform(-1.0, 1.0, 17)


def _lam2(pkg, xp):
    return pkg.functions.LambdaFunction(
        lambda x: xp.exp(-0.3 * x[..., 0]) * xp.sin(xp.pi * (x[..., 1] + 1.0) / 2.0) + x[..., 0] ** 3 * x[..., 1], (2,)
    )


def _lam1(pkg, xp):
    return pkg.functions.LambdaFunction(lambda x: xp.cos(2.0 * x) * xp.exp(x), ())


OPERATORS_2D = {
    "heat": lambda d: d.HeatOperator((2,), alpha=0.1),
    "laplacian": lambda d: d.Laplacian((2,)),
    "mixed": lambda d: d.PartialDerivative(np.array([1, 1])),
    "directional": lambda d: d.DirectionalDerivative(np.array([0.6, -0.8])),
    "scaled": lambda d: 2.5 * d.Laplacian((2,)),
    "sum": lambda d: d.Laplacian((2,)) + d.PartialDerivative(np.array([2, 0])),
    "composite": lambda d: d.PartialDerivative(np.array([1, 0])) @ d.Laplacian((2,)),
}


def _values(f, x):
    return np.asarray(f(x if isinstance(f, jlgt.functions.Function) else torch.from_numpy(x)))


@pytest.mark.parametrize("name", list(OPERATORS_2D))
def test_diffop_function_matches_jax(name):
    op, jop = OPERATORS_2D[name](diffops), OPERATORS_2D[name](jdiffops)
    for build in (_lam2, lambda pkg, xp: _lam2(pkg, xp) + _lam2(pkg, xp) * 0.5):
        f, jf = build(lgt, torch), build(jlgt, jnp)
        g, jg = op(f), jop(jf)
        assert isinstance(g, DiffopFunction) or type(g).__name__ == type(jg).__name__
        got, want = _values(g, X2), np.asarray(jg(jnp.asarray(X2)))
        assert got.dtype == np.float64 and got.shape == (17,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_heat_operator_nests_two_jvps_exactly():
    """H m for m = exp(-0.3 t) sin(pi (x + 1) / 2): the closed form
    (-0.3 + alpha pi^2 / 4) m, through the LambdaFunction's tensor
    conversion inside the nested jvps."""
    m = lgt.functions.LambdaFunction(
        lambda x: torch.exp(-0.3 * x[..., 0]) * torch.sin(torch.pi * (x[..., 1] + 1.0) / 2.0), (2,)
    )
    x = torch.from_numpy(X2)
    got = diffops.HeatOperator((2,), alpha=0.1)(m)(x)
    torch.testing.assert_close(got, (-0.3 + 0.1 * np.pi**2 / 4.0) * m(x), rtol=0, atol=1e-15)


def test_univariate_operators_on_a_lambda_match_jax():
    for op, jop in ((diffops.Derivative(3), jdiffops.Derivative(3)), (-1.0 * diffops.Laplacian(()), -1.0 * jdiffops.Laplacian(()))):
        got = _values(op(_lam1(lgt, torch)), X1)
        want = np.asarray(jop(_lam1(jlgt, jnp))(jnp.asarray(X1)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_zero_stays_zero():
    for op in (diffops.HeatOperator((2,), alpha=0.1), diffops.SelectOutput(((2,), (3,)), 1)):
        g = op(lgt.functions.Zero((2,), op.input_codomain_shape))
        assert isinstance(g, lgt.functions.Zero) and g.input_shape == (2,) and g.output_shape == ()


@pytest.mark.parametrize("with_order_0", [True, False])
def test_constant_shortcut_matches_jax(with_order_0):
    def op(d):
        lap = d.Laplacian((2,))
        return d.Identity((2,)) * 3.0 + lap if with_order_0 else lap

    g = op(diffops)(lgt.functions.Constant((2,), 1.5))
    jg = op(jdiffops)(jlgt.functions.Constant((2,), 1.5))
    assert type(g).__name__ == type(jg).__name__ == ("Constant" if with_order_0 else "Zero")
    if with_order_0:
        assert float(g.value) == float(jg.value) == 4.5


def test_polynomial_shortcut_matches_jax():
    coeffs = [0.5, -1.0, 2.0, 0.25, -0.125]
    for build in (lambda d: d.Derivative(2), lambda d: -1.0 * d.Laplacian(()), lambda d: d.Derivative(1) + 2.0 * d.Derivative(3)):
        g = build(diffops)(lgt.functions.Polynomial(coeffs))
        jg = build(jdiffops)(jlgt.functions.Polynomial(coeffs))
        assert isinstance(g, lgt.functions.Polynomial) and type(g).__name__ == type(jg).__name__
        np.testing.assert_allclose(g.coefficients, jg.coefficients, rtol=1e-15, atol=0)


def test_piecewise_polynomial_shortcut_matches_jax():
    def f(pkg):
        P = pkg.functions.Polynomial
        return pkg.functions.Piecewise([-1.0, 0.0, 0.5, 1.0], [P([1.0, 2.0, 3.0]), P([0.0, -1.0, 0.0, 4.0]), P([2.0])])

    g, jg = diffops.Derivative(1)(f(lgt)), jdiffops.Derivative(1)(f(jlgt))
    assert isinstance(g, lgt.functions.Piecewise) and np.array_equal(g.xs, jg.xs)
    for p, jp in zip(g.pieces, jg.pieces):
        np.testing.assert_allclose(p.coefficients, jp.coefficients, rtol=1e-15, atol=0)
    np.testing.assert_allclose(_values(g, X1), np.asarray(jg(jnp.asarray(X1))), rtol=0, atol=1e-14)


def test_select_output_matches_jax():
    def stacked(pkg, xp):
        return pkg.functions.StackedFunction(_lam2(pkg, xp), pkg.functions.Constant((2,), 2.0))

    sel, jsel = diffops.SelectOutput(((2,), (2,)), 0), jdiffops.SelectOutput(((2,), (2,)), 0)
    f = stacked(lgt, torch)
    assert sel(f) is f.fns[0]
    # On a function that is not a stack: a LambdaFunction selecting the entry.
    lam = lgt.functions.LambdaFunction(lambda x: torch.stack([x[..., 0] ** 2, x[..., 1]], -1), (2,), (2,))
    jlam = jlgt.functions.LambdaFunction(lambda x: jnp.stack([x[..., 0] ** 2, x[..., 1]], -1), (2,), (2,))
    got, want = _values(sel(lam), X2), np.asarray(jsel(jlam)(jnp.asarray(X2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    # A derivative after the selection.
    op = diffops.PartialDerivative(np.array([1, 0])) @ sel
    jop = jdiffops.PartialDerivative(np.array([1, 0])) @ jsel
    np.testing.assert_allclose(_values(op(lam), X2), np.asarray(jop(jlam)(jnp.asarray(X2))), rtol=0, atol=1e-14)


@pytest.mark.parametrize("ops", [("laplacian", "laplacian"), ("heat", None), ("mixed", "directional")])
def test_autodiff_kernel_matches_jax_off_the_diagonal(ops):
    """ExpQuad in 2-D with the autodiff route forced, off the diagonal,
    against the JAX package's autodiff kernel and the port's closed form."""
    n0, n1 = ops
    c = [None if n is None else as_coefficients(OPERATORS_2D[n](diffops)) for n in ops]
    jc = [None if n is None else jax_as_coefficients(OPERATORS_2D[n](jdiffops)) for n in ops]
    k = lgt.kernels.ExpQuad((2,), lengthscales=np.array([0.7, 1.3]))
    jk = jlgt.kernels.ExpQuad((2,), lengthscales=np.array([0.7, 1.3]))
    kk, jkk = AutodiffTransformedKernel(k, *c), JaxAutodiffKernel(jk, *jc)
    rng = np.random.default_rng(33)
    x0, x1 = rng.uniform(-1, 1, (6, 1, 2)), rng.uniform(-1, 1, (1, 5, 2))
    got = kk(torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
    want = np.asarray(jkk(jnp.asarray(x0), jnp.asarray(x1)))
    assert got.shape == (6, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    closed = k
    if n1 is not None:
        closed = apply_operator_to_kernel(OPERATORS_2D[n1](diffops), closed, argnum=1)
    closed = apply_operator_to_kernel(OPERATORS_2D[n0](diffops), closed, argnum=0)
    assert not isinstance(closed, AutodiffTransformedKernel)
    np.testing.assert_allclose(got, closed(torch.from_numpy(x0), torch.from_numpy(x1)).numpy(), rtol=0,
                               atol=1e-12 * np.abs(want).max())
