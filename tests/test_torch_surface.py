"""The port's last public surface against the JAX package: the public
names, ``ops.linalg.pcg.nystrom_preconditioner``, ``utils.profiling`` and
``entry()`` (``__graft_entry__.entry()``), on the CPU in float64."""

import functools
import inspect
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as tlgt
from linpde_gp_tpu.ops.linalg.pcg import nystrom_preconditioner as jax_nystrom
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.linalg.pcg import nystrom_preconditioner
from linpde_gp_tpu_torch.utils.profiling import StageTimer, trace

torch.set_num_threads(1)
config.set(device="cpu")

NAMES = [
    "linfuncops",
    "linfunctls",
    "randprocs",
    "randprocs.covfuncs",
    "randprocs.crosscov",
    "randprocs.GaussianProcess",
    "randprocs.ConditionalGaussianProcess",
    "randprocs.IterativeGPRegressor",
    "randprocs.ParametricGaussianProcess",
    "randprocs.DeterministicProcess",
    "randprocs.asrandproc",
    "kernels.TensorProductGrid",
    "utils.shapes",
    "utils.plotting",
    "ops.linalg.pcg.nystrom_preconditioner",
]


def _resolve(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("path", NAMES)
def test_public_name_resolves_as_in_jax(path):
    import linpde_gp_tpu.ops.linalg.pcg  # noqa: F401
    # The JAX package's lazy ``utils.plotting`` recurses in its module
    # ``__getattr__`` (``from . import plotting`` looks the name up there
    # first) unless the module was imported: import it.
    import linpde_gp_tpu.utils.plotting  # noqa: F401
    import linpde_gp_tpu_torch.ops.linalg.pcg  # noqa: F401

    want, got = _resolve(jlgt, path), _resolve(tlgt, path)
    assert _kind(got) == _kind(want)
    if _kind(want) != "module":
        assert got.__name__ == want.__name__
    else:
        assert got.__name__.replace("linpde_gp_tpu_torch", "linpde_gp_tpu") == want.__name__


def test_aliases_are_the_port_modules():
    assert tlgt.linfuncops is tlgt.diffops and tlgt.linfunctls is tlgt.functionals
    assert tlgt.randprocs.covfuncs is tlgt.kernels and tlgt.randprocs.GaussianProcess is tlgt.GaussianProcess
    assert tlgt.kernels.TensorProductGrid is tlgt.domains.TensorProductGrid
    assert "randprocs" in tlgt.__all__ and "linfuncops" in tlgt.__all__


@pytest.mark.parametrize("matplotlib", ["present", "absent"])
def test_plotting_loads_lazily_and_the_port_imports_without_matplotlib(matplotlib):
    """A fresh process: ``utils.plotting`` is not loaded by the package's
    import, loads on first access, and without matplotlib the package and
    the module import and plotting raises ``ImportError``."""
    block = "sys.modules['matplotlib'] = None\n" if matplotlib == "absent" else ""
    code = (
        "import sys\n" + block
        + "import linpde_gp_tpu_torch as t\n"
        "assert 'linpde_gp_tpu_torch.utils.plotting' not in sys.modules\n"
        "p = t.utils.plotting\n"
        "assert p is sys.modules['linpde_gp_tpu_torch.utils.plotting'] and hasattr(t.GaussianProcess, 'plot')\n"
        "try:\n    p.PDFWriter()\nexcept ImportError:\n    print('no matplotlib')\nelse:\n    print('matplotlib')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ("matplotlib" if matplotlib == "present" else "no matplotlib")


def test_nystrom_preconditioner_matches_jax():
    """The factors, the damping and the apply of one seeded float64 build
    within 1e-12 (relative to their largest entries; delta to lambda_max)."""
    rng = np.random.default_rng(12)
    n, m, sigma_sq = 300, 24, 0.1
    X = rng.uniform(-1.0, 1.0, n)
    Z = np.linspace(-1.0, 1.0, m)

    def k(a, b):
        t = np.abs(a[:, None] - b[None, :]) * 4.0
        return 2.0 * (1.0 + t + t * t / 3.0) * np.exp(-t)

    K_XZ, K_ZZ = k(X, Z), k(Z, Z)
    want = jax_nystrom(jnp.asarray(K_XZ), jnp.asarray(K_ZZ), sigma_sq)
    got = nystrom_preconditioner(torch.from_numpy(K_XZ), torch.from_numpy(K_ZZ), sigma_sq)
    for a, b in ((got.B, want.B), (got.chol_C, want.chol_C)):
        b = np.asarray(b)
        assert a.dtype == torch.float64
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * np.max(np.abs(b))
    # delta is C0's smallest eigenvalue plus sigma^2: eigvalsh resolves it to
    # eps of the largest, ||B||_2^2.
    lam_max = np.linalg.norm(np.asarray(want.B), 2) ** 2
    assert abs(float(got.delta) - float(want.delta)) <= 1e-12 * lam_max
    r = rng.standard_normal((n, 3))
    w = np.asarray(want(jnp.asarray(r)))
    assert np.max(np.abs(got(torch.from_numpy(r)).numpy() - w)) <= 1e-12 * np.max(np.abs(w))


def test_nystrom_preconditioner_raises_where_jax_returns_nan():
    K = -np.eye(4)
    assert np.isnan(np.asarray(jax_nystrom(jnp.asarray(K), jnp.asarray(K), 0.1).chol_C)).any()
    with pytest.raises(torch.linalg.LinAlgError):
        nystrom_preconditioner(torch.from_numpy(K), torch.from_numpy(K), 0.1)


def test_stage_timer_accumulates_named_stages():
    timer = StageTimer()
    with timer("a"):
        torch.ones(8).sum()
    with timer.stage("b"):
        pass
    with timer("a"):
        pass
    summary = timer.summary()
    assert list(summary) == ["a", "b"] and all(v >= 0.0 for v in summary.values())
    assert summary["a"] == round(timer.stages["a"], 6)


def test_trace_none_is_a_no_op_and_a_logdir_gets_a_chrome_trace(tmp_path):
    with trace(None):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert os.path.getsize(logdir / "trace.json") > 0


@functools.lru_cache(maxsize=None)
def _jax_entry():
    saved = jlgt.config.cholesky_jitter
    try:
        fn, (xq,) = __graft_entry__.entry()
        mean, std = fn(xq)
        return np.asarray(xq), np.asarray(mean), np.asarray(std)
    finally:
        jlgt.config.set(cholesky_jitter=saved)


def test_entry_matches_the_jax_entry():
    """Mean and std on the 16 x 16 grid within 1e-10 of max |mean| and of
    max std; neither package's global jitter is left changed."""
    from linpde_gp_tpu_torch.entry import entry

    xq, mean, std = _jax_entry()
    assert jlgt.config.cholesky_jitter == 0.0
    fn, (txq,) = entry(device="cpu")
    assert config.cholesky_jitter == 0.0 and config.device == "cpu"
    assert txq.dtype == torch.float64 and txq.device.type == "cpu"
    np.testing.assert_array_equal(txq.numpy(), xq)
    tmean, tstd = (t.numpy() for t in fn(txq))
    assert tmean.shape == mean.shape == (256,) and tstd.shape == std.shape
    assert np.max(np.abs(tmean - mean)) <= 1e-10 * np.max(np.abs(mean))
    assert np.max(np.abs(tstd - std)) <= 1e-10 * np.max(std)
