"""Plain PyTorch reference of the anchored problem's joint system (no kernels
of the port, no factor of the program).

The posterior of ``u`` given point values ``u(X1) + eps1`` (the anchors,
noise ``tau = anchor_noise``) and ``Hu(X) + eps`` (noise ``sigma^2``) has
the representer weights ``[w1; w]`` of the joint system

    [[k(X1, X1) + tau I,  (k H*)(X1, X)          ],   [w1]   [Y1]
     [(H k)(X, X1),       (H k H*)(X, X) + sigma^2 I]] [w ] = [Y ],

and the mean ``(k H*)(xq, X) w + k(xq, X1) w1``.  The program solves it by
block elimination (CG on the Schur complement of ``k(X1, X1) + tau I``); the
reference only multiplies: :func:`joint_residual` evaluates the system's
residual at the program's weights with the forms of
:mod:`benchmark.reference.heat`, never forming ``W A11^{-1}`` or factoring
anything, and :func:`anchored_mean` the mean of those weights.  ``(H k)(X,
X1)`` is the transpose of ``(k H*)(X1, X)``, evaluated once.  Everything is
float64, whatever the inputs' dtype, so TF32 does not arise.

Departures from the published description (arXiv:2212.12474, the anchored
heat IBVP): none.
"""

from __future__ import annotations

import torch

from .linalg import block_matrix, block_matvec


def _f64(*ts):
    return tuple(t.to(torch.float64) for t in ts)


def joint_residual(kern, X, X1, Y, Y1, w, w1, noise: float, anchor_noise: float):
    """``(r1, r)``: the joint system's residual at ``[w1; w]``, the anchor
    rows' and the PDE rows', in float64."""
    X, X1, Y, Y1, w, w1 = _f64(X, X1, Y, Y1, w, w1)
    C = block_matrix(kern.k_hs, X1, X)  # (n1, n): (k H*)(X1, X)
    r1 = kern.k(X1, X1) @ w1 + anchor_noise * w1 + C @ w - Y1
    r = C.T @ w1 + block_matvec(kern.hk_hs, X, X, w) + noise * w - Y
    return r1, r


def anchored_mean(kern, xq, X, X1, w, w1):
    """``(k H*)(xq, X) w + k(xq, X1) w1`` in float64."""
    xq, X, X1, w, w1 = _f64(xq, X, X1, w, w1)
    return block_matvec(kern.k_hs, xq, X, w) + block_matvec(kern.k, xq, X1, w1)
