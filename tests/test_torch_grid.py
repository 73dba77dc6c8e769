"""Grid mode of the PyTorch port: structured Grams on tensor-product grids
and the gram-free regressor's sum-of-Kronecker routing, against the JAX
package (on the CPU, float64 unless a mode says otherwise).

- The ``linop``s of ``TensorProduct``, ``SumOfProductsKernel``, scaled and
  summed kernels on a 12 x 8 grid: ``todense()`` within 1e-12 of JAX's and
  of ``matrix(X)``; the dense fallback off the grid.
- The C-order flattening convention of ``TensorProductGrid``.
- ``test_regressor_engages_kron_ff_on_grids`` (port of the JAX test of that
  name): the structured operator in every mode (float64 in ff and f64,
  float32 in plain); the JAX package's ff grid matvec, ``KronFFMatvec``, is
  no longer the regressor's (its float32 chunk sums set a floor on the grid
  variance, PERF.md).
- Mode ff's grid CG operator is the float64 Kronecker operator's ff split,
  and its variance on an anchored 24 x 16 grid matches f64's.
- A 24 x 16 heat grid with 24 anchors, f64, tol 1e-10: the mean within 1e-6
  of max |mean| of the JAX regressor and of the port's own K2 route on the
  same points passed as a plain tensor, ``var`` within 1e-5 of max var.
- ``refit`` and a pickle round trip of a grid regressor.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu.models.domains.grid import TensorProductGrid as JaxGrid
from linpde_gp_tpu.models.iterative import IterativeGPRegressor as JaxRegressor
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as jax_apply
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.models.domains import TensorProductGrid, grid_factors
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.ff import ff_split
from linpde_gp_tpu_torch.ops.kron_ff import kron_linop
from linpde_gp_tpu_torch.ops.linalg.linops import Dense, Kronecker, SumOperator
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

TG12 = np.linspace(0.1, 5.0, 12)
XG8 = np.linspace(-1.0, 1.0, 10)[1:-1]


def _tp(pkg, scale=1.0):
    k = pkg.kernels
    return scale * k.TensorProduct(k.Matern((), nu=1.5, lengthscales=2.5), k.Matern((), nu=2.5, lengthscales=2.0))


def _kernels(case):
    """``(port, jax)`` kernels of each structured case."""
    if case == "tensor_product":
        return _tp(lgt).covfunc, _tp(jlgt).covfunc
    if case == "sum_of_products":
        H, jH = diffops.HeatOperator((2,), alpha=0.1), jdiffops.HeatOperator((2,), alpha=0.1)
        return (apply_operator_to_kernel(H, apply_operator_to_kernel(H, _tp(lgt), argnum=1), argnum=0),
                jax_apply(jH, jax_apply(jH, _tp(jlgt), argnum=1), argnum=0))
    if case == "scaled":
        return _tp(lgt, 1.3), _tp(jlgt, 1.3)
    return _tp(lgt) + _tp(lgt, 0.5), _tp(jlgt) + _tp(jlgt, 0.5)


@pytest.mark.parametrize("case", ["tensor_product", "sum_of_products", "scaled", "sum"])
def test_structured_linop_matches_jax_and_matrix(case):
    port_k, jax_k = _kernels(case)
    op = port_k.linop(TensorProductGrid(TG12, XG8))
    assert isinstance(op, (Kronecker, SumOperator)), type(op)
    dense = op.todense().numpy()
    ref = np.asarray(jax_k.linop(JaxGrid(TG12, XG8)).todense())
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dense, ref, rtol=0, atol=1e-12 * scale)
    X = torch.from_numpy(np.asarray(TensorProductGrid(TG12, XG8)).reshape(-1, 2))
    np.testing.assert_allclose(dense, port_k.matrix(X).numpy(), rtol=0, atol=1e-12 * scale)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((96, 3)))
    np.testing.assert_allclose((op @ v).numpy(), dense @ v.numpy(), rtol=0, atol=1e-12 * scale * 96)


@pytest.mark.parametrize("case", ["tensor_product", "sum_of_products"])
def test_linop_off_the_grid_is_dense(case):
    port_k, jax_k = _kernels(case)
    X = np.random.default_rng(1).uniform(-1.0, 1.0, (30, 2))
    op = port_k.linop(X)
    assert isinstance(op, Dense)
    ref = np.asarray(jax_k.linop(X).todense())
    np.testing.assert_allclose(op.todense().numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_zero_kernel_linop():
    k = lgt.kernels.ZeroCovarianceFunction((2,))
    op = k.linop(np.zeros((5, 2)), np.zeros((3, 2)))
    assert op.shape == (5, 3) and not op.todense().any()


def test_grid_flattening_is_c_order():
    """Row ``t * n_x + x`` of the flattened grid is ``(tg[t], xg[x])``, and
    the Kronecker operator's vec convention matches it."""
    G = TensorProductGrid(TG12, XG8)
    assert G.shape == (12, 8, 2) and grid_factors(G) is G.factors and grid_factors(np.asarray(G)) is None
    flat = np.asarray(G).reshape(-1, 2)
    t, x = np.divmod(np.arange(96), 8)
    np.testing.assert_array_equal(flat, np.stack([TG12[t], XG8[x]], -1))
    np.testing.assert_array_equal(flat, np.asarray(JaxGrid(TG12, XG8)).reshape(-1, 2))
    port_k, _ = _kernels("tensor_product")
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(96))
    dense = port_k.matrix(torch.from_numpy(flat))
    np.testing.assert_allclose((port_k.linop(G) @ v).numpy(), (dense @ v).numpy(), rtol=0, atol=1e-13)


def _heat_priors():
    port = lgt.GaussianProcess(lgt.functions.Zero((2,)), _tp(lgt))
    ref = jlgt.GaussianProcess(jlgt.functions.Zero((2,)), _tp(jlgt))
    return port, ref


@pytest.mark.parametrize("mode", ["ff", "f64", "plain"])
def test_regressor_engages_kron_ff_on_grids(mode):
    """tests/test_kron_ff.py::test_regressor_engages_kron_ff_on_grids: the
    regressor on a 24 x 16 grid takes the structured operator in every mode
    (in ff the float64 one, split into the CG's pair, where the JAX package
    takes its compensated matvec); the ff solve converges."""
    port, _ = _heat_priors()
    tg = np.linspace(1e-3, 5.0, 24).astype(np.float32)
    xg = np.linspace(-0.9, 0.9, 16).astype(np.float32)
    reg = IterativeGPRegressor(
        port, TensorProductGrid(tg, xg), np.zeros(24 * 16, np.float32), L=diffops.HeatOperator((2,), alpha=0.1),
        noise_variance=1e-3, precond_rank=64, tol=1e-5, maxiter=400, mode=mode,
    )
    assert isinstance(reg._gram_linop, SumOperator) and reg._banded is None
    assert reg._gram_linop.dtype == (torch.float32 if mode == "plain" else torch.float64)
    assert not hasattr(reg, "_kron_ff")
    rng = np.random.default_rng(1)
    reg.refit(rng.standard_normal(24 * 16).astype(np.float32))
    assert torch.isfinite(reg.representer_weights).all()
    _it, rr = reg.solve_info
    assert rr <= 1e-4


def _anchored_grid_problem():
    tg = np.linspace(1e-3, 5.0, 24)
    xg = np.linspace(-1.0, 1.0, 18)[1:-1]
    rng = np.random.default_rng(3)
    Y = rng.standard_normal(24 * 16)
    Xa = np.concatenate([
        np.stack([np.zeros(12), np.linspace(-1.0, 1.0, 12)], -1),
        np.stack([np.linspace(0.0, 5.0, 6), np.full(6, -1.0)], -1),
        np.stack([np.linspace(0.0, 5.0, 6), np.full(6, 1.0)], -1),
    ])
    Ya = np.sin(np.pi * (Xa[:, 1] + 1.0) / 2.0) * np.exp(-0.1 * (np.pi / 2.0) ** 2 * Xa[:, 0])
    xq = np.stack([rng.uniform(0.0, 5.0, 40), rng.uniform(-1.0, 1.0, 40)], -1)
    kw = dict(noise_variance=1e-3, tol=1e-10, precond_rank=64, maxiter=2000, anchor_X=Xa, anchor_Y=Ya,
              anchor_noise=1e-6)
    return tg, xg, Y, xq, kw


@pytest.fixture(scope="module")
def anchored_grid():
    tg, xg, Y, xq, kw = _anchored_grid_problem()
    port, ref = _heat_priors()
    jreg = JaxRegressor(ref, JaxGrid(tg, xg), Y, L=jdiffops.HeatOperator((2,), alpha=0.1), device_cg=True,
                        precond_build="device", compensated=False, **kw)
    assert jreg._gram_linop is not None
    reg = IterativeGPRegressor(port, TensorProductGrid(tg, xg), Y, L=diffops.HeatOperator((2,), alpha=0.1),
                               mode="f64", **kw)
    return dict(reg=reg, xq=xq, mean=reg.mean(xq).numpy(), var=reg.var(xq).numpy(),
                jax_mean=np.asarray(jreg.mean(jnp.asarray(xq))), jax_var=np.asarray(jreg.var(jnp.asarray(xq))))


def test_anchored_grid_f64_matches_jax(anchored_grid):
    g = anchored_grid
    assert isinstance(g["reg"]._gram_linop, SumOperator) and g["reg"].solve_info[1] <= 1e-10
    np.testing.assert_allclose(g["mean"], g["jax_mean"], rtol=0, atol=1e-6 * np.abs(g["jax_mean"]).max())
    np.testing.assert_allclose(g["var"], g["jax_var"], rtol=0, atol=1e-5 * g["jax_var"].max())


def test_anchored_grid_f64_matches_the_k2_route(anchored_grid):
    """The same points as a plain tensor take K2 (here its plain version):
    the two routes give the same posterior."""
    g = anchored_grid
    tg, xg, Y, xq, kw = _anchored_grid_problem()
    port, _ = _heat_priors()
    X = torch.from_numpy(np.asarray(TensorProductGrid(tg, xg)).reshape(-1, 2))
    reg = IterativeGPRegressor(port, X, Y, L=diffops.HeatOperator((2,), alpha=0.1), mode="f64", **kw)
    assert reg._gram_linop is None
    np.testing.assert_allclose(reg.mean(xq).numpy(), g["mean"], rtol=0, atol=1e-6 * np.abs(g["mean"]).max())
    np.testing.assert_allclose(reg.var(xq).numpy(), g["var"], rtol=0, atol=1e-5 * g["var"].max())


@pytest.mark.parametrize("mode", ["ff", "f64"])
def test_grid_refit_and_pickle_roundtrip(mode):
    """refit on a grid matches a fresh solve; a pickled grid regressor
    rebuilds its grid operators and gives the same weights and mean."""
    tg, xg, Y, xq, kw = _anchored_grid_problem()
    kw = dict(kw, tol=1e-9)
    port, _ = _heat_priors()
    H = diffops.HeatOperator((2,), alpha=0.1)
    grid = TensorProductGrid(tg, xg)
    reg = IterativeGPRegressor(port, grid, Y, L=H, mode=mode, **kw)
    w = reg.representer_weights.clone()
    Y2 = np.cos(np.arange(Y.size))
    fresh = IterativeGPRegressor(port, grid, Y2, L=H, mode=mode, **kw).representer_weights
    refit = reg.refit(Y2).representer_weights
    np.testing.assert_allclose(refit.numpy(), fresh.numpy(), rtol=0, atol=1e-9 * fresh.abs().max().item())
    restored = pickle.loads(pickle.dumps(reg))
    assert type(restored._gram_linop) is type(reg._gram_linop)
    assert torch.equal(restored.representer_weights, refit)
    assert torch.equal(restored.mean(xq), reg.mean(xq))
    np.testing.assert_allclose(restored.refit(Y).representer_weights.numpy(), w.numpy(), rtol=0,
                               atol=1e-9 * w.abs().max().item())


def test_anchored_three_factor_grid_ff_matches_f64():
    """On a (t, x, y) grid KronFF does not apply: mode ff takes the float64
    Kronecker operator, split into the ff pair the CG and the anchors' Schur
    correction expect, and gives mode f64's posterior.  The points are dyadic,
    so both modes see them unrounded."""
    k = lgt.kernels
    prior = lgt.GaussianProcess(lgt.functions.Zero((3,)), k.TensorProduct(
        k.Matern((), nu=1.5, lengthscales=2.5), k.Matern((), nu=2.5, lengthscales=2.0),
        k.Matern((), nu=2.5, lengthscales=2.0)))
    grid = TensorProductGrid(np.arange(1, 9) * 0.5, np.arange(-3, 3) * 0.25 + 0.125, np.arange(-2, 3) * 0.375)
    rng = np.random.default_rng(4)
    Y = rng.standard_normal(8 * 6 * 5)
    s = np.arange(-4, 5) * 0.25
    Xa = np.concatenate([np.stack([np.zeros(9), s, s[::-1]], -1), np.stack([s + 2.0, np.ones(9), s], -1)])
    xq = np.round(rng.uniform(-1.0, 1.0, (24, 3)) * 64) / 64 + np.array([2.0, 0.0, 0.0])
    kw = dict(L=diffops.HeatOperator((3,), alpha=0.1), noise_variance=1e-3, tol=1e-10, precond_rank=32,
              maxiter=2000, anchor_X=Xa, anchor_Y=np.cos(Xa).prod(-1), anchor_noise=1e-6)
    regs = {mode: IterativeGPRegressor(prior, grid, Y, mode=mode, **kw) for mode in ("ff", "f64")}
    assert isinstance(regs["ff"]._gram_linop, SumOperator)
    mean, var = ({m: r.mean(xq).double().numpy() for m, r in regs.items()},
                 {m: r.var(xq).double().numpy() for m, r in regs.items()})
    assert regs["ff"].solve_info[1] <= 1e-10
    np.testing.assert_allclose(mean["ff"], mean["f64"], rtol=0, atol=1e-6 * np.abs(mean["f64"]).max())
    np.testing.assert_allclose(var["ff"], var["f64"], rtol=0, atol=1e-5 * var["f64"].max())


def test_ff_grid_cg_is_the_f64_operator_split():
    """The repair of the grid's ff variance floor: mode ff's CG operator on
    a 2-factor grid is the float64 Kronecker operator's ff split (built here
    from the spec and the float32-rounded factors), and ff's variance on the
    anchored 24 x 16 grid at CG tol 1e-10 is f64's within 1e-7 of max var
    (on the CPU: 8.6e-11).  The JAX package's route, the compensated
    KronFFMatvec, reads 4.3e-6 here on the CPU (and 1.6e-4 on the 500 x 200
    grid on an H100), so the unfixed regressor fails this test."""
    tg, xg, Y, xq, kw = _anchored_grid_problem()
    # float32 points, so that both modes see the same ones.
    tg, xg, xq = tg.astype(np.float32), xg.astype(np.float32), xq.astype(np.float32)
    port, _ = _heat_priors()
    H = diffops.HeatOperator((2,), alpha=0.1)
    grid = TensorProductGrid(tg, xg)
    regs = {mode: IterativeGPRegressor(port, grid, Y, L=H, mode=mode, **kw) for mode in ("ff", "f64")}
    reg = regs["ff"]
    factors = [np.asarray(g).astype(np.float64) for g in grid_factors(grid)]
    f64 = kron_linop(reg._obs_spec, factors, device="cpu")
    v = torch.from_numpy(np.random.default_rng(9).standard_normal((24 * 16, 3)))
    v_ff = ff_split(v)
    ref = f64 @ (v_ff[0].double() + v_ff[1].double())
    hi, lo = reg._gram_matvec_raw(v_ff)
    want = ff_split(ref)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    assert ((hi.double() + lo.double() - ref).norm() / ref.norm()).item() <= 1e-15
    var = {mode: r.var(xq, tol=1e-10).double() for mode, r in regs.items()}
    err = ((var["ff"] - var["f64"]).abs().max() / var["f64"].max()).item()
    assert err <= 1e-7, err
