"""Gram (K1) and Gram matvec (K2) of the PyTorch port against the JAX
package's Pallas kernels, on the heat-equation benchmark spec.

Here on the CPU the port routes to its plain PyTorch versions (the
kernels' counterparts on the card are checked by ``chip_smoke.py``);
the JAX side runs ``pallas_gram`` / ``pallas_gram_matvec`` in interpret
mode, as the JAX package's own tests do.  The error-bound tests are
ports of ``tests/test_compensated.py:92-205`` with the same inputs and
bounds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import linpde_gp_tpu as lgt
from linpde_gp_tpu.ops.pallas_gram import (
    _collapse_terms as jax_collapse_terms,
    _eval_groups as jax_eval_groups,
    kernel_term_specs,
    pallas_gram,
    pallas_gram_matvec,
)
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops import _cuda
from linpde_gp_tpu_torch.ops.gram import (
    _collapse_terms,
    _eval_groups_ff,
    gram,
    gram_matvec,
)
from linpde_gp_tpu_torch.specs import load_specs

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

SPECS = load_specs()
OBS = SPECS["obs"]
_NP = {"plain": np.float32, "ff": np.float32, "f64": np.float64}


def _points(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1).astype(dtype)


def _f64_gram(spec, X0, X1):
    """Float64 oracle: the JAX package's plain evaluator in f64."""
    scale, terms = spec
    x0 = jnp.asarray(X0, jnp.float64)
    x1 = jnp.asarray(X1, jnp.float64)
    acc = jax_eval_groups(jax_collapse_terms(tuple(terms)), lambda i: x0[:, None, i] - x1[None, :, i])
    return scale * np.asarray(acc, np.float64)


@pytest.mark.parametrize("name", ["obs", "cross"])
def test_collapse_terms_matches_jax(name):
    terms = SPECS[name][1]
    assert _collapse_terms(terms) == jax_collapse_terms(terms)


# Per-entry tolerances against the Pallas kernel (relative to k(0)):
# - plain: the two f32 exp implementations differ by an ulp or two,
#   amplified by the Horner cancellation: 1e-6;
# - ff: both sides run the same correctly rounded f32 operation sequence;
#   the bound allows one f32 rounding of the stored hi + lo: 1e-7;
# - f64: double rounding noise only: 1e-13.
_GRAM_TOL = {"plain": 1e-6, "ff": 1e-7, "f64": 1e-13}


@pytest.mark.parametrize("mode", ["plain", "ff", "f64"])
def test_gram_matches_pallas(mode):
    scale, terms = OBS
    X0 = _points(200, 10, _NP[mode])
    X1 = _points(264, 11, _NP[mode])
    want = np.asarray(
        pallas_gram(terms, jnp.asarray(X0), jnp.asarray(X1), interpret=True, compensated=mode == "ff"),
        np.float64,
    )
    got = gram(terms, torch.from_numpy(X0), torch.from_numpy(X1), mode)
    assert got.dtype == (torch.float64 if mode == "f64" else torch.float32)
    assert got.shape == (200, 264)
    k0 = _f64_gram(OBS, X0[:1], X0[:1])[0, 0]
    assert np.max(np.abs(got.double().numpy() - want)) <= _GRAM_TOL[mode] * k0


# K2 tolerance relative to max |K v|: f32 sums of 640 products in another
# order than the Pallas dot (sqrt(n) * eps32 * sum|K v| / max|K v|): 3e-6
# for the f32 modes; 1e-13 in f64.
_MATVEC_TOL = {"plain": 3e-6, "ff": 3e-6, "f64": 1e-13}


@pytest.mark.parametrize("r", [1, 3, 64, 256])
@pytest.mark.parametrize("mode", ["plain", "ff", "f64"])
def test_gram_matvec_matches_pallas(mode, r):
    scale, terms = OBS
    X0 = _points(384, 12, _NP[mode])
    X1 = _points(640, 13, _NP[mode])
    rng = np.random.default_rng(14)
    v = rng.standard_normal((640, r) if r > 1 else 640).astype(_NP[mode])
    want = scale * np.asarray(
        pallas_gram_matvec(
            terms, jnp.asarray(X0), jnp.asarray(X1), jnp.asarray(v), interpret=True, compensated=mode == "ff"
        ),
        np.float64,
    )
    got = gram_matvec(OBS, torch.from_numpy(X0), torch.from_numpy(X1), torch.from_numpy(v), mode)
    if mode == "ff":  # the ff pair; hi is the f32 rounding of the result
        got = got[0]
    assert got.shape == v.shape[:0] + ((384, r) if r > 1 else (384,))
    err = np.max(np.abs(got.double().numpy() - want)) / np.max(np.abs(want))
    assert err <= _MATVEC_TOL[mode]


def test_cross_spec_matvec_matches_pallas():
    scale, terms = SPECS["cross"]
    X0, X1 = _points(64, 15), _points(512, 16)
    v = np.random.default_rng(17).standard_normal(512).astype(np.float32)
    want = scale * np.asarray(
        pallas_gram_matvec(terms, jnp.asarray(X0), jnp.asarray(X1), jnp.asarray(v), interpret=True, compensated=True),
        np.float64,
    )
    got, _ = gram_matvec(SPECS["cross"], torch.from_numpy(X0), torch.from_numpy(X1), torch.from_numpy(v), "ff")
    assert np.max(np.abs(got.double().numpy() - want)) <= 3e-6 * np.max(np.abs(want))


# -- error bounds of the compensated mode (test_compensated.py ports) --------------


@pytest.mark.parametrize("n", [192, 1024])
def test_compensated_gram_entry_error(n):
    scale, terms = OBS
    X = _points(n, 2)
    ref = _f64_gram(OBS, X, X)
    Xt = torch.from_numpy(X)
    plain = scale * gram(terms, Xt, Xt, "plain").double().numpy()
    comp = scale * gram(terms, Xt, Xt, "ff").double().numpy()
    k0 = ref[0, 0]
    # The compensated chain is ~1e-13; the final f32 rounding of each
    # stored entry (~eps32/2, incoherent) dominates.
    assert np.max(np.abs(comp - ref)) / k0 < 1e-7
    # The coherent norm ||E||_2 never grows vs plain f32.
    assert np.linalg.norm(comp - ref, 2) <= 1.5 * np.linalg.norm(plain - ref, 2)
    assert np.max(np.abs(comp - comp.T)) == 0.0  # exactly symmetric


def test_compensated_matvec_full_precision():
    X = _points(768, 3)
    v = np.random.default_rng(3).standard_normal(768).astype(np.float32)
    ref = _f64_gram(OBS, X, X) @ v.astype(np.float64)
    Xt, vt = torch.from_numpy(X), torch.from_numpy(v)
    out = gram_matvec(OBS, Xt, Xt, vt, "ff")[0].double().numpy()
    err = np.max(np.abs(out - ref)) / np.max(np.abs(ref))
    # f32 product-sum rounding only: ~sqrt(n) * eps32.
    assert err < 3e-6
    err_plain = np.max(np.abs(gram_matvec(OBS, Xt, Xt, vt, "plain").double().numpy() - ref)) / np.max(np.abs(ref))
    assert err <= 2.0 * err_plain  # compensation never hurts
    # f64 mode against the same oracle: round-off only.
    out64 = gram_matvec(OBS, Xt.double(), Xt.double(), vt.double(), "f64").numpy()
    assert np.max(np.abs(out64 - ref)) / np.max(np.abs(ref)) < 1e-13


def test_compensated_gram_coherent_error_floor():
    """The ff planes themselves (no final f32 rounding) sit >=1e3 below
    the 1e-6 plain-f32 floor."""
    scale, terms = OBS
    X = _points(512, 4)
    ref = _f64_gram(OBS, X, X)
    x = torch.from_numpy(X)
    hi, lo = _eval_groups_ff(_collapse_terms(terms), lambda i: (x[:, None, i], x[None, :, i]))
    got = scale * (hi.double().numpy() + lo.double().numpy())
    assert np.max(np.abs(got - ref)) / ref[0, 0] < 1e-10


def test_wendland_compensated():
    """Compact-support cut-off stays exact in ff (mask reads hi and lo)."""
    spec = kernel_term_specs(lgt.kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5))
    scale, terms = spec
    X = np.random.default_rng(5).uniform(-1.0, 1.0, (256, 1)).astype(np.float32)
    ref = _f64_gram(spec, X, X)
    comp = scale * gram(terms, torch.from_numpy(X), torch.from_numpy(X), "ff").double().numpy()
    assert np.max(np.abs(comp - ref)) / ref[0, 0] < 1e-7
    np.testing.assert_array_equal(comp == 0.0, ref == 0.0)


# -- routing ------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches the CUDA wrappers, and their launch
    counters stay untouched."""

    def refuse(*args, **kwargs):
        raise AssertionError("CPU tensor routed to a CUDA wrapper")

    monkeypatch.setattr(_cuda, "gram", refuse)
    monkeypatch.setattr(_cuda, "gram_matvec", refuse)
    before = dict(_cuda.launches)
    X = torch.from_numpy(_points(40, 20))
    assert gram(OBS[1], X, X, "ff").shape == (40, 40)
    assert gram_matvec(OBS, X, X, torch.ones(40), "plain").shape == (40,)
    assert _cuda.launches == before


@pytest.mark.parametrize("fn", ["gram", "gram_matvec"])
def test_no_route_for_other_devices(fn):
    X = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="no route"):
        if fn == "gram":
            gram(OBS[1], X, X, "f64")
        else:
            gram_matvec(OBS, X, X, torch.empty(8, device="meta"), "f64")


# -- the kernels' generated modules ---------------------------------------------------


def test_spec_table_packs_the_heat_spec():
    """What the CUDA kernels compile in and read: one factor per distinct
    (dim, kind, scale), the groups sharing the heat spec's one envelope,
    C-order coefficient tensors in the structure's group order (times the
    outer scale), f32 hi/lo splits."""
    scale, terms = OBS
    groups = _collapse_terms(terms)
    st = _cuda.structure_of(groups)
    s = _cuda.spec_values(groups, scale)
    assert (st.nd, len(st.groups), len(st.factors)) == (2, len(groups), 2)
    assert st.factors == ((0, "matern"), (1, "matern")) and st.envelopes() == [(0, len(groups))]
    by_key = {(parity, np.asarray(C).shape): (dims_key, np.asarray(C)) for dims_key, parity, C in groups}
    off = 0
    for fac, parity, shape in st.groups:
        dims_key, C = by_key[(parity, shape)]
        for i, f in enumerate(fac):
            assert st.factors[f] == (i, dims_key[i][0]) and s.fac_scale[f] == dims_key[i][1]
        flat = scale * C.reshape(-1)
        np.testing.assert_array_equal(np.asarray(s.coef[off:off + flat.size]), flat)
        hi = np.asarray(s.coef_hi[off:off + flat.size], np.float64)
        lo = np.asarray(s.coef_lo[off:off + flat.size], np.float64)
        np.testing.assert_array_equal(hi, flat.astype(np.float32))
        assert np.max(np.abs(hi + lo - flat)) <= 1e-14 * np.max(np.abs(flat))
        off += flat.size
    src = _cuda.structure_source(st)
    assert "static constexpr int grp_deg[2][2] = {{2, 3}, {2, 3}};" in src and src.endswith('#include "module.cuh"\n')


@pytest.mark.parametrize("case", ["dims", "groups", "coefficients", "factors"])
def test_spec_table_rejects_specs_beyond_the_caps(case):
    """The generator raises on a spec beyond the kernels' caps instead of
    truncating it."""
    if case == "dims":
        bad = ((("matern", 1.0),) * 5, (0,) * 5, (((((1.0,),),),),))
        groups, match = (bad,), "input dimensions"
    elif case == "groups":
        groups = tuple(((("matern", float(k + 1)),), (0,), (1.0,)) for k in range(9))
        match = "groups"
    elif case == "coefficients":
        groups, match = (((("matern", 1.0),), (0,), (1.0,) * 129),), "coefficients"
    else:
        groups = tuple(((("matern", float(k + 1)), ("matern", float(k + 10))), (0, 0), ((1.0,),)) for k in range(5))
        match = "factors"
    with pytest.raises(ValueError, match=match):
        _cuda.structure_of(groups)


def test_heat_obs_and_cross_share_a_structure():
    """``H k H*`` and ``k H*`` compile to one module (their groups differ in
    coefficients, not in structure); the Wendland specs to others."""
    w1 = lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.05)
    w2 = lgt.kernels.TensorProduct(
        lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.08),
        lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.3),
    )
    keys = {name: _cuda.structure_of(_collapse_terms(SPECS[name][1])).key for name in ("obs", "cross")}
    assert keys["obs"] == keys["cross"]
    wkeys = {_cuda.structure_of(_collapse_terms(kernel_term_specs(k)[1])).key for k in (w1, w2)}
    assert len(wkeys) == 2 and keys["obs"] not in wkeys


@pytest.mark.parametrize("mode", ["plain", "ff", "f64"])
@pytest.mark.parametrize("wide", [False, True])
def test_pair_ops_are_positive(mode, wide):
    """The per-pair operation counts the bounds rest on: positive on the
    mode's pipe, none on the other precision's, growing with r.  On the
    multi-column route the product is r float64 FMAs on the FP64 tensor
    cores in every mode, and the evaluation stays on the mode's pipe."""
    st = _cuda.structure_of(_collapse_terms(OBS[1]))
    r = 256 if wide else 1
    ops = _cuda.pair_ops(st, mode, r, wide)
    main = "fp64" if mode == "f64" else "fp32"
    assert ops[main] > 0 and all(v >= 0 for v in ops.values())
    assert (ops["mufu"] > 0) == (mode == "plain")
    if not wide:
        assert ops["fp32" if mode == "f64" else "fp64"] == 0 and ops["fp64_tc"] == 0
        assert sum(_cuda.pair_ops(st, mode, 4).values()) > sum(ops.values())
    else:
        # The evaluation once (a narrow count at r = 0), the product on the tensor cores.
        evaluation = _cuda.pair_ops(st, mode, 0)
        assert ops == {**evaluation, "fp64_tc": r}
        if mode == "ff":
            assert ops["fp64"] == 0


@pytest.mark.parametrize("row_blocks,n1", [(1, 100_000), (16, 100_000), (391, 100_000), (782, 100_000),
                                           (3, 1000), (3, 129), (5, 128), (3, 0), (40, 12_345)])
def test_column_split_covers_each_column_once(row_blocks, n1):
    """The narrow route's column split: chunks of whole tiles, in order,
    covering [0, n1) exactly once; no split once the rows fill the card."""
    sms = 132
    splits, chunk = _cuda.column_split(row_blocks, n1, sms)
    ranges = [(z * chunk, min(n1, (z + 1) * chunk)) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n1
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges) or n1 == 0
    assert splits == 1 or chunk % _cuda.NARROW_TILE == 0
    if row_blocks >= _cuda.SPLIT_BLOCKS_PER_SM * sms:
        assert splits == 1
    elif n1 > _cuda.NARROW_TILE:
        # whole tiles per chunk: at least half the blocks aimed at
        assert splits > 1 and 2 * row_blocks * splits >= min(_cuda.SPLIT_BLOCKS_PER_SM * sms,
                                                              row_blocks * -(-n1 // _cuda.NARROW_TILE))


@pytest.mark.parametrize("r", [1, 3])
def test_ff_matvec_plain_returns_a_pair(r):
    """Mode ff's plain K2 returns the ff pair of the f64 product of the ff
    entries: hi + lo matches the JAX package's f64 ``_dense_terms_matvec``
    on the same (float32-representable) points within 1e-12 relative; hi
    alone is its f32 rounding."""
    from linpde_gp_tpu.ops.pallas_gram import _dense_terms_matvec
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain

    scale, terms = OBS
    X0, X1 = _points(96, 40), _points(160, 41)
    v = np.random.default_rng(42).standard_normal((160, r) if r > 1 else 160)
    want = scale * np.asarray(_dense_terms_matvec(terms, jnp.asarray(X0, jnp.float64), jnp.asarray(X1, jnp.float64),
                                                  jnp.asarray(v)))
    hi, lo = gram_matvec_plain(OBS, torch.from_numpy(X0), torch.from_numpy(X1),
                               (torch.from_numpy(v).float(), torch.from_numpy(v - v.astype(np.float32)).float()), "ff")
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (96,) + v.shape[1:]
    got = hi.double().numpy() + lo.double().numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    np.testing.assert_array_equal(hi.numpy(), got.astype(np.float32))


@pytest.mark.parametrize("shape", [(1000, 256), (777, 100), (5, 48), (1, 5)])
def test_wide_panel_is_the_exact_sum_of_an_ff_pair(shape):
    """The multi-column route's float64 panel of an ff right-hand side
    (hi, lo) = ff_split(x) is the pair's exact sum, element by element, and
    a plain or f64 right-hand side is only widened."""
    from linpde_gp_tpu_torch.ops.ff import ff_split

    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal(shape) * np.exp(rng.uniform(-20.0, 20.0, shape)))
    hi, lo = ff_split(x)
    panel = _cuda.wide_panel(hi, lo)
    assert panel.dtype == torch.float64 and panel.shape == shape and panel.is_contiguous()
    assert torch.equal(panel - hi.double(), lo.double())
    assert torch.equal(panel, x.float().double() + lo.double())
    assert torch.equal(_cuda.wide_panel(hi), hi.double())
    assert _cuda.wide_panel(x).data_ptr() == x.data_ptr()  # a contiguous f64 panel is taken as it is


def test_numpy_input_lands_on_the_default_device(monkeypatch):
    """Numpy points go to ``config.resolve_device()`` (here patched to the
    meta device, which has no route), a tensor stays on its device."""
    from linpde_gp_tpu_torch.ops.gram import _as_points, gram_matrix

    monkeypatch.setattr(config, "device", "meta")
    Xnp = _points(8, 3).astype(np.float64)
    assert _as_points(Xnp, "f64").device.type == "meta"
    assert _as_points(torch.from_numpy(Xnp), "f64").device.type == "cpu"
    with pytest.raises(ValueError, match="no route for device meta"):
        gram(OBS[1], Xnp, Xnp, "f64")
    with pytest.raises(ValueError, match="no route for device meta"):
        gram_matvec(OBS, Xnp, Xnp, np.ones(8), "f64")
    k = lgt_port_heat_kernel()
    with pytest.raises(ValueError, match="no route for device meta"):
        gram_matrix(k, Xnp, Xnp, "f64")
    X = torch.from_numpy(Xnp)
    assert gram(OBS[1], X, X, "f64").device.type == "cpu"
    assert gram_matrix(k, X, X, "f64").device.type == "cpu"


def lgt_port_heat_kernel():
    from linpde_gp_tpu_torch.ops import kernels

    return kernels.TensorProduct(
        kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5, lengthscales=2.0)
    )


@pytest.mark.parametrize("fn", ["gram_plain", "gram_matvec_plain"])
def test_plain_versions_check_the_points_width(fn):
    """The plain versions refuse points whose width is not the spec's, as
    the kernels do (a (4, 6) batch of (3, 2) queries read as 6 columns)."""
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain, gram_plain

    X = torch.from_numpy(_points(12, 4).astype(np.float64))
    wide = X.reshape(4, 6)
    with pytest.raises(ValueError, match="dims, the spec 2"):
        if fn == "gram_plain":
            gram_plain(OBS[1], wide, X, "f64")
        else:
            gram_matvec_plain(OBS, wide, X, torch.ones(12, dtype=torch.float64), "f64")


def _heat_prior_kernels():
    """``TensorProduct(Matern 3/2 l=2.5, Matern 5/2 l=2.0)`` (input shape
    (2,)) in both packages."""
    import linpde_gp_tpu_torch as tlgt

    def build(pkg):
        return pkg.kernels.TensorProduct(
            pkg.kernels.Matern((), nu=1.5, lengthscales=2.5), pkg.kernels.Matern((), nu=2.5, lengthscales=2.0)
        )

    return build(lgt), build(tlgt)


def test_host_engine_route_checks_the_points_width():
    """3-wide points for a 2-dim spec raise before ``gram`` and
    ``gram_matvec`` pick a route, the host engine's included (1024^2 pairs
    reach ``config.native_gram_threshold``), as the plain versions raise."""
    from linpde_gp_tpu_torch.ops.gram import kernel_term_specs as torch_term_specs

    _, kernel = _heat_prior_kernels()
    spec = torch_term_specs(kernel)
    assert 1024 * 1024 >= config.native_gram_threshold and config.use_native_host_engine
    X = torch.from_numpy(np.random.default_rng(0).uniform(-1.0, 1.0, (1024, 3)))
    with pytest.raises(ValueError, match="dims, the spec 2"):
        gram(spec[1], X, X, "f64")
    with pytest.raises(ValueError, match="dims, the spec 2"):
        gram_matvec(spec, X, X, torch.ones(1024, dtype=torch.float64), "f64")


def test_gram_matrix_checks_the_points_input_shape():
    """``gram_matrix`` refuses points whose trailing shape is not the
    kernel's input shape; the JAX package's fails on the same points."""
    from linpde_gp_tpu.ops.pallas_gram import gram_matrix as jax_gram_matrix
    from linpde_gp_tpu_torch.ops.gram import gram_matrix

    jax_kernel, kernel = _heat_prior_kernels()
    rng = np.random.default_rng(1)
    X0, X1 = rng.uniform(-1.0, 1.0, (8, 3)), rng.uniform(-1.0, 1.0, (4, 3))
    with pytest.raises(TypeError):
        jax_gram_matrix(jax_kernel, jnp.asarray(X0), jnp.asarray(X1))
    with pytest.raises(ValueError, match="input shape"):
        gram_matrix(kernel, X0, X1, mode="f64")
    with pytest.raises(ValueError, match="input shape"):
        gram_matrix(kernel, torch.from_numpy(X0), mode="f64")
    good = gram_matrix(kernel, X0[:, :2], X1[:, :2], mode="f64")
    assert tuple(good.shape) == (8, 4)
