"""Sharded posterior evaluation: the query points split over every rank.

Port of ``linpde_gp_tpu/parallel/posterior.py``.  Each rank evaluates its
slice of the queries (padded to a multiple of the mesh size by repeating
the first point) on the port's posterior (the dense engine's
``ConditionalGaussianProcess``, whose factor every rank holds), then one
``all_gather`` per output assembles them; queries never communicate
otherwise.
"""

from __future__ import annotations

import torch

from .mesh import Mesh


def sharded_posterior_eval(posterior, X, *, mesh: Mesh, with_std: bool = False):
    """Posterior mean (and std) at ``X`` (``batch + input_shape``), the query
    batch split over the mesh; results on every rank, on the mesh's device,
    of shape ``batch + output_shape``."""
    X = torch.as_tensor(X)
    in_ndim = len(posterior.input_shape)
    batch = tuple(X.shape[: X.ndim - in_ndim])
    x = X.reshape((-1,) + tuple(posterior.input_shape))
    n = x.shape[0]
    per = -(-n // mesh.size)
    pad = per * mesh.size - n
    if pad:
        x = torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
    mine = x[mesh.rank * per:(mesh.rank + 1) * per]
    outs = [posterior.mean(mine)] + ([posterior.std(mine)] if with_std else [])
    outs = [mesh.all_gather(o.to(mesh.device))[:n].reshape(batch + tuple(posterior.output_shape)) for o in outs]
    return tuple(outs) if with_std else outs[0]
