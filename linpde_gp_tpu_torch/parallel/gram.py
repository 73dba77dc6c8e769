"""Mesh-sharded Gram assembly.

Port of ``linpde_gp_tpu/parallel/gram.py``.  The Gram ``k(X0, X1)`` is
tiled over a 2-D mesh: row points split over the ``rows`` axis, column
points over ``cols``, and every rank evaluates exactly its own tile, with
no communication: K1 on CUDA tensors, the plain version (or the host
engine) on the CPU, in float64, the dense engine's precision.  A 1-D mesh
splits the rows only.  A kernel without a spec takes its own evaluation
(``kernel.matrix``, through ``ops/gram.gram_matrix``) on the tile, where
the JAX package evaluates the whole matrix on every device.
"""

from __future__ import annotations

import torch

from ..ops.gram import gram_matrix
from .mesh import Mesh


def points(kernel, X, device) -> torch.Tensor:
    """``X`` (``(n,) + input_shape``, numpy or a tensor) as ``(n, d)``
    float64 points on ``device``."""
    X = torch.as_tensor(X, dtype=torch.float64)
    return X.reshape(-1, max(kernel.input_size, 1)).to(device)


def _split(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{n} {what} do not split over {parts} ranks")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def sharded_gram(kernel, X0, X1=None, *, mesh: Mesh) -> torch.Tensor:
    """This rank's tile of ``k(X0, X1)``: the rows of its index along the
    mesh's first axis and the columns of its index along the second (all
    columns on a 1-D mesh), float64 on the rank's device.  The point
    counts must split evenly, as ``shard_map`` requires in the JAX
    package.  :func:`gather_gram` assembles the whole matrix."""
    x0 = points(kernel, X0, mesh.device)
    x1 = x0 if X1 is None else points(kernel, X1, mesh.device)
    rows, cols = mesh.axis_names[0], mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    r = _split(x0.shape[0], mesh.shape[rows], mesh.coords[rows], "row points")
    c = slice(None) if cols is None else _split(x1.shape[0], mesh.shape[cols], mesh.coords[cols], "column points")
    return gram_matrix(kernel, x0[r], x1[c], "f64")


def gather_gram(tile: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole matrix from every rank's :func:`sharded_gram` tile, on
    every rank."""
    if len(mesh.axis_names) > 1:
        tile = mesh.all_gather(tile.T, mesh.axis_names[1]).T
    return mesh.all_gather(tile, mesh.axis_names[0])
