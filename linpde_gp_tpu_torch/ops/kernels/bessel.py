"""Modified Bessel function of the second kind and the general-``nu``
Matérn evaluation.

Port of ``linpde_gp_tpu/ops/kernels/bessel.py``.  ``K_nu`` comes from
``scipy.special.kv``: every call is a round trip to the host, as the
reference's ``jax.pure_callback`` is.  The values go back to the input's
device and dtype; nothing else changes device.  This is a parity path for
non-half-integer ``nu``, not a hot path: half-integer ``nu`` keeps the
closed form that the kernels evaluate on the card.

:class:`KV` is a ``torch.autograd.Function`` whose forward-mode rule
(``jvp``, for ``torch.func.jvp``) and reverse-mode rule (``backward``)
are both the recurrence ``K_v'(x) = -(K_{v-1}(x) + K_{v+1}(x)) / 2``
(DLMF 10.29.2) written as calls of the same Function, so derivatives of
any order nest, as the reference's ``custom_jvp`` does.  Nesting
``torch.func.jvp`` through it needs two of torch's functorch internals
(:meth:`KV.jvp`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch._C._functorch as _functorch
from torch.autograd.forward_ad import _set_fwd_grad_enabled


def _kv_host(v: float, x: torch.Tensor) -> torch.Tensor:
    """``K_v(x)`` by scipy on the host, returned on ``x``'s device and in its
    dtype."""
    import scipy.special

    vals = scipy.special.kv(v, x.detach().cpu().numpy().astype(np.float64))
    return torch.from_numpy(np.asarray(vals)).to(device=x.device, dtype=x.dtype)


class KV(torch.autograd.Function):
    """``K_v(x)`` elementwise, differentiable in ``x`` to any order."""

    @staticmethod
    def forward(v, x):
        return _kv_host(float(v), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, x = inputs
        ctx.v = float(v)
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def _derivative(v, x):
        return -0.5 * (KV.apply(v - 1.0, x) + KV.apply(v + 1.0, x))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return None, grad * KV._derivative(ctx.v, x)

    @staticmethod
    def jvp(ctx, v_tangent, x_tangent):
        (x,) = ctx.saved_tensors
        level = _functorch.maybe_current_level()
        if level is None:  # torch.autograd.forward_ad: a single level
            return KV._derivative(ctx.v, x) * x_tangent
        # Under torch.func.jvp the rule runs with forward AD off, so the
        # transforms around this one would see the derivative as a constant.
        # It is formed with forward AD on, on x without this level's tangent
        # (with it, every order would be formed at once, without end).
        if _functorch.maybe_get_level(x) == level:
            x = _functorch._unwrap_for_grad(x, level)
        with _set_fwd_grad_enabled(True):
            return KV._derivative(ctx.v, x) * x_tangent


def kv(v: float, x) -> torch.Tensor:
    """``K_v(x)`` elementwise (float64 for non-tensor input)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, dtype=np.float64))
    return KV.apply(float(v), x)


def matern_bessel(nu: float, t: torch.Tensor) -> torch.Tensor:
    r"""``2^{1-nu}/Gamma(nu) t^nu K_nu(t)``, with its limit 1 at ``t = 0``,
    where ``t = sqrt(2 nu) ||x0 - x1|| / l``."""
    nu = float(nu)
    norm = math.exp((1.0 - nu) * math.log(2.0) - math.lgamma(nu))
    t = torch.as_tensor(t)
    one = torch.ones_like(t)
    # Both branches finite, so that derivatives at t = 0 are not NaN.
    t_safe = torch.where(t > 0, t, one)
    return torch.where(t > 0, norm * t_safe**nu * kv(nu, t_safe), one)
