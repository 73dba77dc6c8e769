"""The port's g++ host engine (``linpde_gp_tpu_torch/native``) against the
JAX package's engine and Gram, and the port's routing to it.

Ports ``tests/test_native_engine.py``'s four tests (each held to the JAX
package's Gram or engine, float64, 1e-13 / 1e-12 relative) and adds the
mode routing (f64 CPU calls from the threshold go to the engine, plain and
ff stay plain), the plain version without a toolchain, and a failed build
that raises instead of falling back.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu import native as jnative
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.pallas_gram import gram_matrix as jgram_matrix
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as japply
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch import native
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.native import engine as engine_mod
from linpde_gp_tpu_torch.ops import gram as gram_mod
from linpde_gp_tpu_torch.ops.gram import gram_matrix, gram_matvec, kernel_term_specs
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions (or the host engine) there.
config.set(device="cpu")

pytestmark = pytest.mark.skipif(not native.available(), reason="no host C++ toolchain")


def _heat_kernel(pkg, diffops, apply):
    prior = 1.7 * pkg.kernels.TensorProduct(
        pkg.kernels.Matern((), nu=1.5, lengthscales=2.5),
        pkg.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    return apply(H, apply(H, prior, argnum=1), argnum=0)


def _kernels(pkg, diffops, apply):
    return {
        "expquad1d": (pkg.kernels.ExpQuad((), lengthscales=0.8), 1),
        "matern3d": (pkg.kernels.ExpQuad((3,), lengthscales=1.3), 3),
        "heat_LkL": (_heat_kernel(pkg, diffops, apply), 2),
    }


@pytest.fixture
def threshold():
    """Restores the routing settings a test changes."""
    old = (config.native_gram_threshold, config.use_native_host_engine)
    yield
    config.set(native_gram_threshold=old[0], use_native_host_engine=old[1])


@pytest.mark.parametrize("name", ["expquad1d", "matern3d", "heat_LkL"])
def test_native_gram_matches_jax(name):
    kernel, dim = _kernels(lgt, lgt.diffops, apply_operator_to_kernel)[name]
    jkernel, _ = _kernels(jlgt, jdiffops, japply)[name]
    eng = native.engine_for(kernel)
    assert eng is not None
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-1.0, 1.0, (37, dim)).squeeze()
    X1 = rng.uniform(-1.0, 1.0, (23, dim)).squeeze()
    shape = (-1,) + jkernel.input_shape
    expected = np.asarray(jgram_matrix(jkernel, X0.reshape(shape), X1.reshape(shape)))
    got = eng.gram(X0, X1)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, expected, rtol=1e-13, atol=1e-13)
    # The JAX engine generates the same source, so the two agree to round-off.
    np.testing.assert_allclose(got, jnative.engine_for(jkernel).gram(X0, X1), rtol=1e-15, atol=0)
    # A CPU tensor in, a tensor out.
    got_t = eng.gram(torch.from_numpy(X0), torch.from_numpy(X1))
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), got)


def test_native_matvec_matches_gram():
    kernel = _heat_kernel(lgt, lgt.diffops, apply_operator_to_kernel)
    eng = native.engine_for(kernel)
    rng = np.random.default_rng(1)
    X0 = rng.uniform(0.0, 1.0, (19, 2))
    X1 = rng.uniform(0.0, 1.0, (31, 2))
    v = rng.standard_normal(31)
    V = rng.standard_normal((31, 4))
    G = eng.gram(X0, X1)
    np.testing.assert_allclose(eng.matvec(X0, X1, v), G @ v, rtol=1e-12)
    np.testing.assert_allclose(eng.matvec(X0, X1, V), G @ V, rtol=1e-12)
    out = eng.matvec(torch.from_numpy(X0), torch.from_numpy(X1), torch.from_numpy(V))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), G @ V, rtol=1e-12)


def test_gram_matrix_routes_to_native(threshold, monkeypatch):
    """``gram_matrix`` routes a float64 CPU Gram from the threshold through
    the engine and agrees with the JAX package's dense Gram."""
    kernel = _heat_kernel(lgt, lgt.diffops, apply_operator_to_kernel)
    jkernel = _heat_kernel(jlgt, jdiffops, japply)
    X = np.random.default_rng(2).uniform(0.0, 1.0, (64, 2))
    calls = []
    real = gram_mod._native
    monkeypatch.setattr(gram_mod, "_native", lambda *a: calls.append(a) or real(*a))
    config.set(native_gram_threshold=1)
    routed = gram_matrix(kernel, torch.from_numpy(X), mode="f64")
    assert calls and calls[-1][0][1] == kernel_term_specs(kernel)[1]
    dense = np.asarray(jkernel.matrix(jnp.asarray(X), jnp.asarray(X)))
    np.testing.assert_allclose(routed.numpy(), dense, rtol=1e-12, atol=1e-13)


def test_gram_matvec_router_native_path(threshold):
    kernel = _heat_kernel(lgt, lgt.diffops, apply_operator_to_kernel)
    jkernel = _heat_kernel(jlgt, jdiffops, japply)
    spec = kernel_term_specs(kernel)
    assert spec is not None
    rng = np.random.default_rng(3)
    X = rng.uniform(0.0, 1.0, (48, 2))
    v = rng.standard_normal(48)
    config.set(native_gram_threshold=1)
    got = gram_matvec(spec, torch.from_numpy(X), torch.from_numpy(X), torch.from_numpy(v), "f64")
    expected = np.asarray(jkernel.matrix(jnp.asarray(X), jnp.asarray(X))) @ v
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("mode", ["plain", "ff", "f64"])
@pytest.mark.parametrize("size", ["below", "at"])
def test_mode_routing(mode, size, threshold, monkeypatch):
    """Only mode f64 from the threshold takes the engine; below it, and in
    modes plain and ff at any size, the plain versions run."""
    kernel = _heat_kernel(lgt, lgt.diffops, apply_operator_to_kernel)
    spec = kernel_term_specs(kernel)
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.uniform(0.0, 1.0, (40, 2)))
    v = torch.from_numpy(rng.standard_normal(40))
    config.set(native_gram_threshold=40 * 40 + (1 if size == "below" else 0))
    used = []
    monkeypatch.setattr(engine_mod.NativeGramEngine, "gram", lambda self, *a: used.append("gram") or torch.zeros(()))
    monkeypatch.setattr(engine_mod.NativeGramEngine, "matvec",
                        lambda self, *a: used.append("matvec") or torch.zeros((40, 1)))
    G = gram_matrix(kernel, X, mode=mode)
    mv = gram_matvec(spec, X, X, v, mode)
    engine = mode == "f64" and size == "at"
    assert used == (["gram", "matvec"] if engine else [])
    if not engine:
        plain = gram_mod.gram_plain(spec[1], X, X, mode) * spec[0]
        np.testing.assert_array_equal(G.numpy(), plain.numpy())
        ref = gram_mod.gram_matvec_plain(spec, X, X, v, mode)
        for a, b in zip(mv if mode == "ff" else (mv,), ref if mode == "ff" else (ref,)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_no_toolchain_keeps_the_plain_version(threshold, monkeypatch):
    monkeypatch.setattr(engine_mod, "_GXX", None)
    monkeypatch.setattr(engine_mod, "_ENGINES", {})
    assert not native.available()
    assert native.engine_for_spec(1.0, kernel_term_specs(lgt.kernels.ExpQuad((), lengthscales=0.5))[1]) is None
    kernel = _heat_kernel(lgt, lgt.diffops, apply_operator_to_kernel)
    spec = kernel_term_specs(kernel)
    X = torch.from_numpy(np.random.default_rng(5).uniform(0.0, 1.0, (30, 2)))
    config.set(native_gram_threshold=1)
    G = gram_matrix(kernel, X, mode="f64")
    np.testing.assert_array_equal(G.numpy(), (gram_mod.gram_plain(spec[1], X, X, "f64") * spec[0]).numpy())


def test_failed_build_raises(threshold, monkeypatch):
    """A toolchain that fails to build raises; the JAX package would
    return ``None`` and fall back to the plain evaluation silently."""
    monkeypatch.setattr(engine_mod, "_GXX", "false")  # a compiler that always fails
    monkeypatch.setattr(engine_mod, "_ENGINES", {})
    # A spec no other test builds, so no cached library answers for it.
    spec = kernel_term_specs(0.123456789 * lgt.kernels.ExpQuad((), lengthscales=0.987654321))
    with pytest.raises(subprocess.CalledProcessError):
        native.engine_for_spec(*spec)
    config.set(native_gram_threshold=1)
    X = torch.linspace(0.0, 1.0, 12, dtype=torch.float64)
    with pytest.raises(subprocess.CalledProcessError):
        gram_matvec(spec, X, X, torch.ones(12, dtype=torch.float64), "f64")
