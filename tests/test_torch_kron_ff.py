"""The compensated sum-of-Kronecker grid matvec of the PyTorch port
(``ops/kron_ff.py``) against the JAX package.

Port of ``tests/test_kron_ff.py::test_kron_ff_matches_f64_oracle``: the heat
``H k H*`` spec from both packages, the port's ff matvec (on the CPU, taking
the ff pair of ``v``) against JAX's float64 ``k_hh.linop(X) @ v`` on a 96 x
48 grid, within 5e-5 ||v|| (the JAX test's gate) and no worse than JAX's own
``KronFFMatvec`` (x 1.05 + 1e-7) or the port's plain float32 Kronecker
operator; the port's float64 Kronecker operator within 1e-12 of JAX's; the
host factor tables against the port's symbolic layer and JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu.models.domains.grid import TensorProductGrid as JaxGrid
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.kron_ff import KronFFMatvec as JaxKronFFMatvec
from linpde_gp_tpu.ops.kron_ff import eval_factor_np as jax_eval_factor_np
from linpde_gp_tpu.ops.pallas_gram import kernel_term_specs as jax_kernel_term_specs
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as jax_apply
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.models.domains import TensorProductGrid
from linpde_gp_tpu_torch.ops import diffops
from linpde_gp_tpu_torch.ops.ff import ff_split
from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
from linpde_gp_tpu_torch.ops.kron_ff import KronFFMatvec, eval_factor_np, kron_linop
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu_torch.ops.transforms.univariate import UnivariateFactor

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

NT, NX = 96, 48
TG = np.linspace(1e-3, 5.0, NT)
XG = np.linspace(-1.0, 1.0, NX + 2)[1:-1]


def _jax_heat():
    prior_cov = 1.0 * jlgt.kernels.TensorProduct(
        jlgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        jlgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = jdiffops.HeatOperator((2,), alpha=0.1)
    k_hh = jax_apply(H, jax_apply(H, prior_cov, argnum=1), argnum=0)
    return k_hh, jax_kernel_term_specs(k_hh)


def _port_heat():
    prior_cov = 1.0 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5), lgt.kernels.Matern((), nu=2.5, lengthscales=2.0)
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    k_hh = apply_operator_to_kernel(H, apply_operator_to_kernel(H, prior_cov, argnum=1), argnum=0)
    return k_hh, kernel_term_specs(k_hh)


@pytest.fixture(scope="module")
def heat():
    jax_k, jax_spec = _jax_heat()
    port_k, port_spec = _port_heat()
    return dict(jax_k=jax_k, jax_spec=jax_spec, port_k=port_k, port_spec=port_spec,
                jax_lin=jax_k.linop(JaxGrid(TG, XG)))


def test_heat_spec_matches_jax(heat):
    assert heat["port_spec"] == heat["jax_spec"]


@pytest.mark.parametrize("r", [1, 3])
def test_kron_ff_matches_f64_oracle(heat, r):
    """ff within 5e-5 ||v|| of JAX's float64 linop, and no worse than JAX's
    own KronFFMatvec (float32 v) or the port's plain float32 operator."""
    mv = KronFFMatvec(heat["port_spec"], (TG, XG))
    jax_mv = JaxKronFFMatvec(heat["jax_spec"], (TG, XG))
    plain = kron_linop(heat["port_spec"], (TG, XG), dtype=torch.float32)
    rng = np.random.default_rng(0)
    worst = dict(ff=0.0, jax=0.0, plain=0.0)
    for _ in range(4):
        v = rng.standard_normal(NT * NX if r == 1 else (NT * NX, r))
        y64 = np.asarray(heat["jax_lin"] @ jnp.asarray(v), np.float64)
        hi, lo = mv(ff_split(torch.from_numpy(v)))
        assert hi.dtype == lo.dtype == torch.float32 and hi.shape == v.shape
        ys = dict(
            ff=(hi.double() + lo.double()).numpy(),
            jax=np.asarray(jax_mv(jnp.asarray(v, jnp.float32)), np.float64),
            plain=(plain @ torch.from_numpy(v).float()).double().numpy(),
        )
        for name, y in ys.items():
            worst[name] = max(worst[name], np.linalg.norm(y - y64) / np.linalg.norm(v))
    assert worst["ff"] < 5e-5, worst
    assert worst["ff"] < 1.05 * worst["jax"] + 1e-7, worst
    assert worst["ff"] < 1.05 * worst["plain"] + 1e-7, worst


def test_kron_ff_hi_is_the_rounding_of_the_pair(heat):
    """The result's hi plane is its float32 rounding (the CG's ff contract)."""
    mv = KronFFMatvec(heat["port_spec"], (TG, XG))
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(NT * NX)).float()
    hi, lo = mv(v)
    assert torch.equal(hi, (hi.double() + lo.double()).float())


def test_f64_kronecker_matches_jax_linop(heat):
    """The port's float64 Kronecker operators (from the kernel and from the
    spec) within 1e-12 of JAX's float64 linop."""
    ref = np.asarray(heat["jax_lin"].todense())
    scale = np.abs(ref).max()
    for op in (heat["port_k"].linop(TensorProductGrid(TG, XG)), kron_linop(heat["port_spec"], (TG, XG))):
        assert op.dtype == torch.float64
        np.testing.assert_allclose(op.todense().numpy(), ref, rtol=0, atol=1e-12 * scale)
    v = np.random.default_rng(2).standard_normal((NT * NX, 2))
    y = kron_linop(heat["port_spec"], (TG, XG)) @ torch.from_numpy(v)
    y_ref = np.asarray(heat["jax_lin"] @ jnp.asarray(v))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-12 * np.abs(y_ref).max())


def _factor_specs(spec):
    return sorted({f for _c, fs in spec[1] for f in fs})


@pytest.mark.parametrize("case", ["heat", "expquad", "wendland"])
def test_factor_tables_match_the_symbolic_layer(heat, case):
    """``eval_factor_np`` against the port's closed-form factors (and JAX's
    ``eval_factor_np`` for the kinds it has) at seeded differences."""
    if case == "heat":
        spec = heat["port_spec"]
    elif case == "expquad":
        k = lgt.kernels.TensorProduct(lgt.kernels.ExpQuad((), lengthscales=0.7), lgt.kernels.ExpQuad((), lengthscales=1.3))
        H = diffops.HeatOperator((2,), alpha=0.3)
        spec = kernel_term_specs(apply_operator_to_kernel(H, apply_operator_to_kernel(H, k, argnum=1), argnum=0))
    else:
        k = lgt.kernels.TensorProduct(
            lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
        )
        spec = kernel_term_specs(k)
    d = np.random.default_rng(3).uniform(-1.2, 1.2, 200)
    d[:3] = 0.0, 0.5, -0.5
    for f in _factor_specs(spec):
        got = eval_factor_np(f, d)
        ref = UnivariateFactor(*f)(torch.from_numpy(d), torch.zeros(())).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * max(np.abs(ref).max(), 1.0))
        if f[0] != "wendland":
            np.testing.assert_array_equal(got, jax_eval_factor_np(f, d))


def test_kron_ff_error_grows_with_the_chunk(heat):
    """KronFF's error is the float32 sum inside each chunk's GEMM: it grows
    with the chunk (8, the regressor's 32, one chunk per contraction), and
    even one chunk (with the lo planes and the terms kept apart) beats the
    plain float32 operator.  This floor holds the grid's ff variance above
    the f64 one (ROADMAP Queue 3)."""
    f64 = kron_linop(heat["port_spec"], (TG, XG))
    plain = kron_linop(heat["port_spec"], (TG, XG), dtype=torch.float32)
    rng = np.random.default_rng(4)
    vs = [torch.from_numpy(rng.standard_normal((NT * NX, 3))) for _ in range(4)]

    def worst(mv):
        return max(((lambda y: y[0].double() + y[1].double())(mv(ff_split(v))) - f64 @ v).norm().item()
                   / v.norm().item() for v in vs)

    errs = [worst(KronFFMatvec(heat["port_spec"], (TG, XG), chunk=c)) for c in (8, 32, NT)]
    e_plain = max(((plain @ v.float()).double() - f64 @ v).norm().item() / v.norm().item() for v in vs)
    assert errs[0] < errs[1] < errs[2] < e_plain, (errs, e_plain)
