"""Float-float primitives of the PyTorch port (``linpde_gp_tpu_torch/
ops/ff.py``) against the JAX package's ``ops/ff.py``.

The first three tests are ports of ``tests/test_compensated.py``'s ff
tests with the same inputs and bounds.  The agreement tests feed the
same f32 (and f64) inputs to both packages: every function is a fixed
sequence of correctly rounded IEEE operations (plus floor and exponent
bit arithmetic in ``ff_exp``), so the two must agree bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linpde_gp_tpu.ops import ff as jff
from linpde_gp_tpu_torch.ops import ff
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_ff_exp_accuracy():
    rng = np.random.default_rng(0)
    x32 = rng.uniform(-40.0, 2.0, 4096).astype(np.float32)
    eh, el = ff.ff_exp((_t(x32), torch.zeros(4096, dtype=torch.float32)))
    got = eh.double().numpy() + el.double().numpy()
    ref = np.exp(x32.astype(np.float64))
    # degree-10 exp: ~2e-12 truncation; requirement is 1e-10.
    assert np.max(np.abs(got - ref) / ref) < 1e-11


def test_ff_mul_add_chain():
    rng = np.random.default_rng(1)
    a = rng.uniform(-3, 3, 4096).astype(np.float32)
    b = rng.uniform(-3, 3, 4096).astype(np.float32)
    d = ff.two_diff(_t(a), _t(b))
    exact = a.astype(np.float64) - b.astype(np.float64)
    got = d[0].double().numpy() + d[1].double().numpy()
    np.testing.assert_array_equal(got, exact)  # error-free

    s = ff.ff_scale(d, 1.7320508075688772)
    exact_s = exact * 1.7320508075688772
    got = s[0].double().numpy() + s[1].double().numpy()
    assert np.max(np.abs(got - exact_s) / np.abs(exact_s)) < 1e-13


def test_ff_exp_underflow_clamp():
    x = _t(np.float32([-100.0, -87.0, -50.0, 0.0]))
    eh, el = ff.ff_exp((x, torch.zeros_like(x)))
    out = (eh.double() + el.double()).numpy()
    assert np.all(np.isfinite(out))
    assert out[0] <= 1e-37
    assert abs(out[3] - 1.0) < 1e-13


def _pairs(dtype, seed):
    rng = np.random.default_rng(seed)
    hi = rng.uniform(-3.0, 3.0, 2048).astype(dtype)
    lo = (hi * rng.uniform(-1.0, 1.0, 2048) * np.finfo(dtype).eps / 2).astype(dtype)
    return hi, lo


_CASES = {
    "two_sum": lambda m, x, y: m.two_sum(x[0], y[0]),
    "quick_two_sum": lambda m, x, y: m.quick_two_sum(x[0], 1e-3 * y[0]),
    "two_diff": lambda m, x, y: m.two_diff(x[0], y[0]),
    "two_prod": lambda m, x, y: m.two_prod(x[0], y[0]),
    "ff_add": lambda m, x, y: m.ff_add(x, y),
    "ff_add_const": lambda m, x, y: m.ff_add_const(x, *m.ff_const(0.1, x[0].dtype)),
    "ff_mul": lambda m, x, y: m.ff_mul(x, y),
    "ff_sqr": lambda m, x, y: m.ff_sqr(x),
    "ff_abs": lambda m, x, y: m.ff_abs(x),
    "ff_scale": lambda m, x, y: m.ff_scale(x, 0.6928203230275509),
    "ff_exp": lambda m, x, y: m.ff_exp(m.ff_neg(m.ff_mul(x, x))),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_agrees_with_jax_bitwise(name, dtype):
    xh, xl = _pairs(dtype, 2)
    yh, yl = _pairs(dtype, 3)
    fn = _CASES[name]
    got = fn(ff, (_t(xh), _t(xl)), (_t(yh), _t(yl)))
    want = fn(jff, (jnp.asarray(xh), jnp.asarray(xl)), (jnp.asarray(yh), jnp.asarray(yl)))
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ff_const_splits_on_the_host():
    for c in (0.1, 1.0 / 3.0, 0.6928203230275509, 1e-3 * 0.495625):
        hi, lo = ff.ff_const(c, torch.float32)
        assert (hi, lo) == jff.ff_const(c, jnp.float32)
        assert abs((hi + lo) - c) <= 1e-14 * abs(c)
    assert ff.ff_const(0.1, torch.float64) == (0.1, 0.0)
