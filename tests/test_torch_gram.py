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
from linpde_gp_tpu_torch.ops import _cuda
from linpde_gp_tpu_torch.ops.gram import (
    _collapse_terms,
    _eval_groups_ff,
    gram,
    gram_matvec,
)
from linpde_gp_tpu_torch.specs import load_specs

torch.set_num_threads(1)

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


@pytest.mark.parametrize("r", [1, 3])
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
    got = gram_matvec(SPECS["cross"], torch.from_numpy(X0), torch.from_numpy(X1), torch.from_numpy(v), "ff")
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
    out = gram_matvec(OBS, Xt, Xt, vt, "ff").double().numpy()
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


# -- the kernels' spec table ----------------------------------------------------------


def test_spec_table_packs_the_heat_spec():
    """The table the CUDA kernels read: one factor per distinct
    (dim, kind, scale), C-order coefficient tensors, f32 hi/lo splits."""
    groups = _collapse_terms(OBS[1])
    s = _cuda.spec_table(groups)
    assert (s.ndims, s.ngroups, s.nfactors) == (2, len(groups), 2)
    off = 0
    for g, (dims_key, parity, C) in enumerate(groups):
        C = np.asarray(C)
        assert list(s.grp_deg[g])[:2] == list(C.shape)
        assert list(s.grp_parity[g])[:2] == list(parity)
        assert s.grp_off[g] == off
        for i, (kind, sc) in enumerate(dims_key):
            f = s.grp_fac[g][i]
            assert (s.fac_dim[f], s.fac_kind[f], s.fac_scale[f]) == (i, 0, sc)
        flat = C.reshape(-1)
        np.testing.assert_array_equal(np.asarray(s.coef[off:off + flat.size]), flat)
        hi = np.asarray(s.coef_hi[off:off + flat.size], np.float64)
        lo = np.asarray(s.coef_lo[off:off + flat.size], np.float64)
        np.testing.assert_array_equal(hi, flat.astype(np.float32))
        assert np.max(np.abs(hi + lo - flat)) <= 1e-14 * np.max(np.abs(flat))
        off += flat.size


def test_spec_table_rejects_specs_beyond_the_caps():
    five_dims = ((("matern", 1.0),) * 5, (0,) * 5, (((((1.0,),),),),))
    with pytest.raises(ValueError, match="input dimensions"):
        _cuda.spec_table((five_dims,))
    many_groups = tuple(((("matern", float(k + 1)),), (0,), (1.0,)) for k in range(9))
    with pytest.raises(ValueError, match="groups"):
        _cuda.spec_table(many_groups)
