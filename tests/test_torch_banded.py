"""The banded Gram matvec of compactly supported (Wendland) kernels.

Ports of ``tests/test_wendland_fast.py::test_banded_matvec_matches_dense_1d``,
``::test_banded_matvec_diffop_transformed_2d`` and
``::test_banded_matvec_radius_covers_domain``: the port's banded matvec
(here on the CPU, its plain version; the CUDA kernel is checked against it
by ``chip_smoke.py``) against the JAX package's
``make_banded_matvec(..., interpret=True)`` on the same inputs, at r = 1
(the JAX package's K4 panel route) and r = 3 (its K3 route), with the JAX
tests' tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as lgt
from linpde_gp_tpu.config import config as jax_config
from linpde_gp_tpu.ops.pallas_gram import kernel_term_specs as jax_kernel_term_specs
from linpde_gp_tpu.ops.pallas_gram import make_banded_matvec as jax_make_banded_matvec
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops import _cuda
from linpde_gp_tpu_torch.ops import diffops, kernels
from linpde_gp_tpu_torch.ops.banded import band_windows, compact_support_radius, make_banded_matvec
from linpde_gp_tpu_torch.ops.gram import gram_matvec, kernel_term_specs
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


@pytest.fixture
def tile128():
    """Column tiles of 128 points in both packages, as the JAX 1-D test sets."""
    saved_jax, saved = jax_config.matvec_tile, config.matvec_tile
    jax_config.set(matvec_tile=128)
    config.matvec_tile = 128
    yield
    jax_config.set(matvec_tile=saved_jax)
    config.matvec_tile = saved


def _case_1d():
    rng = np.random.default_rng(7)
    k = 1.7 * kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.05)
    k_jax = 1.7 * lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.05)
    return kernel_term_specs(k), jax_kernel_term_specs(k_jax), rng.uniform(0.0, 1.0, 300), rng.uniform(0.0, 1.0, 1500)


def _case_2d():
    def build(K, D, apply):
        k = K.TensorProduct(
            K.WendlandCovarianceFunction((), k=2, lengthscales=0.08),
            K.WendlandCovarianceFunction((), k=2, lengthscales=0.3),
        )
        Dx = D.PartialDerivative((1, 0))
        return apply(Dx, apply(Dx, k, argnum=1), argnum=0)

    spec = kernel_term_specs(build(kernels, diffops, apply_operator_to_kernel))
    spec_jax = jax_kernel_term_specs(build(lgt.kernels, lgt.ops.diffops, lgt.ops.transforms.apply_operator_to_kernel))
    X = np.random.default_rng(8).uniform(0.0, 1.0, (256, 2))
    return spec, spec_jax, X, X


def _case_covers_domain():
    spec = kernel_term_specs(kernels.WendlandCovarianceFunction((), k=1, lengthscales=5.0))
    spec_jax = jax_kernel_term_specs(lgt.kernels.WendlandCovarianceFunction((), k=1, lengthscales=5.0))
    X = np.random.default_rng(9).uniform(0.0, 1.0, 150)
    return spec, spec_jax, X, X


CASES = {"1d": _case_1d, "2d": _case_2d, "covers_domain": _case_covers_domain}
# The JAX tests' tolerances (f64 end to end).
TOL = {"1d": dict(rtol=0, atol=1e-12), "2d": dict(rtol=1e-9, atol=1e-10), "covers_domain": dict(rtol=0, atol=1e-12)}


def _rhs(n, r, seed=10):
    v = np.random.default_rng(seed).standard_normal((n, r))
    return v[:, 0] if r == 1 else v


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_banded_matches_jax(case, r, tile128):
    spec, spec_jax, X0, X1 = CASES[case]()
    assert spec == spec_jax
    v = _rhs(X1.shape[0], r)
    want = np.asarray(jax_make_banded_matvec(spec_jax, X0, X1, interpret=True)(jnp.asarray(v)))
    mv = make_banded_matvec(spec, X0, X1, mode="f64")
    got = mv(torch.from_numpy(v))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL[case])
    # ... and against the dense matvec (the plain version of K2).
    dense = gram_matvec(spec, X0, X1, torch.from_numpy(v), "f64").numpy()
    np.testing.assert_allclose(got.numpy(), dense, **TOL[case])


def test_band_tiles_match_jax(tile128):
    """Same column tiles, same band: the routing rule carries over."""
    for case, skips in (("1d", True), ("covers_domain", False)):
        spec, spec_jax, X0, X1 = CASES[case]()
        jmv = jax_make_banded_matvec(spec_jax, X0, X1, interpret=True)
        mv = make_banded_matvec(spec, X0, X1, mode="f64")
        assert (mv.band_tiles, mv.total_tiles) == (jmv.band_tiles, jmv.total_tiles)
        assert (mv.band_tiles < mv.total_tiles) == skips


def test_radius_and_non_compact_kernels():
    spec, _, X0, _ = _case_2d()
    assert compact_support_radius(spec[1], 0) == pytest.approx(0.08)
    assert compact_support_radius(spec[1], 1) == pytest.approx(0.3)
    spec_m = kernel_term_specs(kernels.Matern((), nu=1.5, lengthscales=0.3))
    assert compact_support_radius(spec_m[1]) is None
    with pytest.raises(ValueError, match="not compactly supported"):
        make_banded_matvec(spec_m, X0[:, 0], X0[:, 0], mode="f64")
    # An explicit radius is taken as given.
    mv = make_banded_matvec(spec_m, X0[:, 0], X0[:, 0], radius=10.0, mode="f64")
    assert mv.band_tiles == mv.total_tiles


# Float32 modes against the f64 banded result on the same f32-rounded
# inputs (relative to max |K v|).  Measured on these cases (CPU): ff
# 7.9e-8 (1d), 3.2e-8 (2d), 4.1e-8 (covers_domain); plain 1.1e-6, 1.4e-4,
# 5.7e-7 (the 2-D derivative kernel's f32 Horner cancels).  The bounds
# keep 5x headroom over the largest.
_F32_TOL = {"ff": 4e-7, "plain": 7e-4}


@pytest.mark.parametrize("mode", ["ff", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_f32_modes_against_f64(case, mode):
    spec, _, X0, X1 = CASES[case]()
    X0, X1 = X0.astype(np.float32), X1.astype(np.float32)
    v = _rhs(X1.shape[0], 3).astype(np.float32)
    ref = make_banded_matvec(spec, X0.astype(np.float64), X1.astype(np.float64), mode="f64")(torch.from_numpy(v).double())
    mv = make_banded_matvec(spec, X0, X1, mode=mode)
    got = mv(torch.from_numpy(v))
    if mode == "ff":  # the ff pair; hi is the f32 rounding of the result
        got = got[0]
    assert got.dtype == torch.float32
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= _F32_TOL[mode]
    # An ff right-hand side (hi, lo) is taken in mode ff only.
    if mode == "ff":
        lo = torch.from_numpy((v.astype(np.float64) * 1e-9).astype(np.float32))
        got2 = mv((torch.from_numpy(v), lo))[0]
        ref2 = ref + make_banded_matvec(spec, X0.astype(np.float64), X1.astype(np.float64), mode="f64")(lo.double())
        assert (got2.double() - ref2).abs().max().item() / ref2.abs().max().item() <= _F32_TOL[mode]
    else:
        with pytest.raises(ValueError, match="ff pair"):
            mv((torch.from_numpy(v), torch.from_numpy(v)))


def _inside(c0, c1, scale, dtype):
    """Pairs whose scaled distance the ``dtype`` body rounds to <= 1."""
    a = torch.as_tensor(c0, dtype=dtype)[:, None]
    b = torch.as_tensor(c1, dtype=dtype)[None, :]
    return (torch.tensor(scale, dtype=dtype) * (a - b).abs() <= 1.0).numpy()


@pytest.mark.parametrize("mode", ["plain", "ff", "f64"])
def test_points_at_exactly_the_radius(mode):
    """Columns at exactly +-radius of a row, and a few ulps beyond: every
    pair the mode's body counts as inside lies in its block's window, and
    the banded product equals the dense one."""
    radius = 0.05
    spec = kernel_term_specs(2.0 * kernels.WendlandCovarianceFunction((), k=2, lengthscales=radius))
    dt = np.float64 if mode == "f64" else np.float32
    X0 = np.arange(0.0, 1.0, 1.0 / 97).astype(dt)
    offsets = radius * np.array([1.0, 1 - 1e-7, 1 + 3e-8, 1 + 1e-7, 1 + 1e-6])
    X1 = np.concatenate([X0 + o for o in offsets] + [X0 - o for o in offsets]).astype(dt)
    saved = config.matvec_tile
    config.matvec_tile = 32
    try:
        mv = make_banded_matvec(spec, X0, X1, mode=mode)
    finally:
        config.matvec_tile = saved
    c0 = mv.X0s[:, 0].double().numpy()
    c1 = mv.X1s[:, 0].double().numpy()
    for dtype in (torch.float32, torch.float64):
        inside = _inside(c0, c1, 20.0, dtype)
        for b, (lo, hi) in enumerate(mv.windows):
            rows = inside[b * 32:(b + 1) * 32]
            cols = np.nonzero(rows.any(axis=0))[0]
            assert cols.size and lo <= cols.min() and cols.max() < hi
    assert mv.windows.tolist() == band_windows(c0, c1, radius, 32).tolist()
    v = torch.from_numpy(_rhs(X1.shape[0], 1).astype(dt))
    got, dense = mv(v), gram_matvec(spec, X0, X1, v, mode)
    if mode == "ff":  # the f32 roundings of the two ff pairs
        got, dense = got[0], dense[0]
    got, dense = got.double(), dense.double()
    # Same pairs and values; only the summation order differs.
    bound = {"plain": 1e-6, "ff": 1e-15, "f64": 1e-15}[mode]
    assert (got - dense).abs().max().item() <= bound * dense.abs().max().item()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("CPU tensor routed to a CUDA wrapper")

    monkeypatch.setattr(_cuda, "banded_matvec", refuse)
    spec, _, X0, X1 = _case_1d()
    before = dict(_cuda.launches)
    mv = make_banded_matvec(spec, X0, X1, mode="f64")
    assert mv(torch.ones(X1.shape[0], dtype=torch.float64)).shape == (300,)
    assert _cuda.launches == before


def test_spec_table_holds_the_wendland_specs():
    """The kernels' 128-coefficient cap holds the 2-D Wendland k=2 spec
    under the heat operator (2 groups, 106 coefficients); a k=3 factor
    overflows it, and the table raises instead of truncating."""
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms

    def heat_spec(k):
        kern = kernels.TensorProduct(
            kernels.WendlandCovarianceFunction((), k=k, lengthscales=0.1),
            kernels.WendlandCovarianceFunction((), k=k, lengthscales=0.3),
        )
        H = diffops.HeatOperator((2,), alpha=0.1)
        return kernel_term_specs(apply_operator_to_kernel(H, apply_operator_to_kernel(H, kern, argnum=1), argnum=0))

    groups = _collapse_terms(heat_spec(2)[1])
    assert (len(groups), sum(np.asarray(C).size for _, _, C in groups)) == (2, 106)
    st = _cuda.structure_of(groups)
    assert (st.nd, len(st.groups), len(st.factors)) == (2, 2, 2)
    assert all(kind == "wendland" for _, kind in st.factors)
    packed = np.asarray(_cuda.spec_values(groups).coef)
    want = np.concatenate([np.asarray(C).reshape(-1) for _, _, C in groups])
    np.testing.assert_array_equal(np.sort(packed[:106]), np.sort(want))
    assert not packed[106:].any()
    with pytest.raises(ValueError, match="coefficients"):
        _cuda.structure_of(_collapse_terms(heat_spec(3)[1]))


@pytest.mark.parametrize("tile,r", [(96, 5), (32, 256), (160, 64)])
def test_multi_column_tile_is_checked_before_any_launch(tile, r, monkeypatch):
    """The multi-column route's 64-row blocks must tile the banded row
    blocks: a tile that is no multiple of them raises in Python, before a
    module is built or a kernel launched, and the narrow route (r <= 4)
    takes such a tile."""
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms

    assert tile % _cuda.MATMAT_ROWS != 0 and tile % 32 == 0
    groups = _collapse_terms(tuple(CASES["1d"]()[0][1]))
    X = torch.zeros((tile, 1), dtype=torch.float64)
    windows = torch.zeros((1, 2), dtype=torch.int32)
    before = dict(_cuda.launches)

    def refuse(*args, **kwargs):
        raise AssertionError("built a module for a refused tile")

    monkeypatch.setattr(_cuda, "module", refuse)
    with pytest.raises(ValueError, match="multiple of its 64-row blocks"):
        _cuda.banded_matvec(groups, X, X, torch.zeros((tile, r), dtype=torch.float64), windows, tile, "f64")
    with pytest.raises(AssertionError, match="built a module"):  # r <= 4 passes the check
        _cuda.banded_matvec(groups, X, X, torch.zeros((tile, 4), dtype=torch.float64), windows, tile, "f64")
    assert _cuda.launches == before
