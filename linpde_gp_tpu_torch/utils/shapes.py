"""Shape utilities (port of ``linpde_gp_tpu/utils/shapes.py``)."""

from __future__ import annotations

import numbers
from typing import Iterable, Tuple

ShapeType = Tuple[int, ...]


def as_shape(x, ndim: int | None = None) -> ShapeType:
    """Coerce ``x`` into a shape tuple; a length-1 shape broadcasts to
    ``ndim`` entries."""
    if isinstance(x, numbers.Integral):
        shape = (int(x),)
    elif isinstance(x, Iterable):
        shape = tuple(int(s) for s in x)
    else:
        raise TypeError(f"Cannot interpret {x!r} as a shape.")

    if ndim is not None and len(shape) != ndim:
        if len(shape) == 1 and ndim > 1:
            shape = shape * ndim
        else:
            raise ValueError(f"Shape {shape} does not have ndim {ndim}.")

    return shape


def size(shape: ShapeType) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out
