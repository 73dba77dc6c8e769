"""Plain PyTorch reference of the heat-equation prior's covariance forms (no
kernels of the port).

The prior is ``u ~ GP(0, k)`` with ``k = k1(t - t') k2(x - x')``, ``k1`` a
Matérn 3/2 of lengthscale ``ell_t`` and ``k2`` a Matérn 5/2 of lengthscale
``ell_x``; the operator is ``H = d/dt - alpha d^2/dx^2`` on points ``(t, x)``.
With ``s1 = a |t - t'|`` (``a = sqrt(3) / ell_t``) and ``s2 = b |x - x'|``
(``b = sqrt(5) / ell_x``) the closed forms are, each times ``exp(-s1 - s2)``:

- ``k``: ``(1 + s1) (1 + s2 + s2^2 / 3)``;
- ``k H*`` = Cov(u(x), Hu(x')) = ``-k1'(tau) k2 - alpha k1 k2''``:
  ``a^2 tau (1 + s2 + s2^2 / 3) - alpha (1 + s1) b^2 (s2^2 - s2 - 1) / 3``;
- ``H k H*`` = Cov(Hu(x), Hu(x')) = ``-k1'' k2 + alpha^2 k1 k2''''`` (the two
  mixed terms cancel):
  ``a^2 (1 - s1) (1 + s2 + s2^2 / 3) + alpha^2 (1 + s1) b^4 (1 - 5 s2 / 3 + s2^2 / 3)``.

Everything is evaluated in the dtype of the points (float64 for the
reference, float32 for the control).  The posterior algebra is
:mod:`benchmark.reference.linalg`'s.
"""

from __future__ import annotations

import math

import torch


class HeatKernels:
    """The three covariance forms of the heat prior at points ``(n, 2)``."""

    def __init__(self, ell_t: float, ell_x: float, alpha: float):
        self.a = math.sqrt(3.0) / ell_t
        self.b = math.sqrt(5.0) / ell_x
        self.alpha = alpha

    def _parts(self, x0, x1):
        tau = x0[:, :1] - x1[:, 0]
        xi = x0[:, 1:] - x1[:, 1]
        s1 = tau.abs().mul_(self.a)
        s2 = xi.abs().mul_(self.b)
        env = torch.exp(-(s1 + s2))
        return tau, s1, s2, env

    def k(self, x0, x1):
        """Cov(u(x0), u(x1))."""
        _, s1, s2, env = self._parts(x0, x1)
        q = s2 * (s2 / 3.0 + 1.0) + 1.0
        return env.mul_(s1.add_(1.0)).mul_(q)

    def k_hs(self, x0, x1):
        """Cov(u(x0), Hu(x1)) = (k H*)(x0, x1)."""
        tau, s1, s2, env = self._parts(x0, x1)
        a2, ab2 = self.a**2, self.alpha * self.b**2 / 3.0
        q0 = s2 * (s2 / 3.0 + 1.0) + 1.0
        q2 = s2 * (s2 - 1.0) - 1.0
        out = tau.mul_(a2).mul_(q0).sub_(s1.add_(1.0).mul_(ab2).mul_(q2))
        return out.mul_(env)

    def hk_hs(self, x0, x1):
        """Cov(Hu(x0), Hu(x1)) = (H k H*)(x0, x1)."""
        _, s1, s2, env = self._parts(x0, x1)
        a2, c4 = self.a**2, self.alpha**2 * self.b**4
        q0 = s2 * (s2 / 3.0 + 1.0) + 1.0
        q4 = s2 * (s2 / 3.0 - 5.0 / 3.0) + 1.0
        out = (1.0 - s1) * a2 * q0 + (s1 + 1.0) * c4 * q4
        return out.mul_(env)

    def k_diag(self, x):
        """k(x, x) = 1 at every point."""
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def diag_hk_hs(self) -> float:
        """(H k H*)(x, x): the observation kernel's k(0)."""
        return self.a**2 + self.alpha**2 * self.b**4
