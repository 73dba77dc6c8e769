"""Domain types.

Port of ``linpde_gp_tpu/models/domains/domain.py``, numpy as there:
``Interval.uniform_grid`` gives an ndarray, ``CartesianProduct.uniform_grid``
a :class:`TensorProductGrid` (``Point`` factors as singleton dimensions)."""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from ...utils.shapes import ShapeType, as_shape
from .grid import TensorProductGrid


class Domain:
    def __init__(self, shape) -> None:
        self._shape: ShapeType = as_shape(shape)

    @property
    def shape(self) -> ShapeType:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def dimension(self) -> int:
        return 1 if self._shape == () else int(np.prod(self._shape))

    @property
    def volume(self):
        raise NotImplementedError

    @property
    def boundary(self):
        raise NotImplementedError

    def uniform_grid(self, shape, inset=0.0):
        raise NotImplementedError


class Point(Domain):
    def __init__(self, point) -> None:
        self._point = np.asarray(point, dtype=np.float64)
        super().__init__(self._point.shape)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._point, dtype=dtype)

    def __float__(self):
        return float(self._point)

    @property
    def volume(self):
        return np.zeros(())

    @property
    def boundary(self):
        return ()

    def __eq__(self, other):
        return isinstance(other, Point) and np.array_equal(self._point, other._point)

    def __hash__(self):
        return hash(self._point.tobytes())

    def __repr__(self):
        return f"Point({self._point})"

    def uniform_grid(self, shape=1, inset=0.0):
        shape = as_shape(shape)
        n = int(np.prod(shape)) if shape else 1
        if n != 1:
            raise ValueError(f"a point has a grid of one point, not {shape}")
        return np.broadcast_to(self._point, shape + self._point.shape).copy()


class Interval(Domain, Sequence):
    def __init__(self, lower_bound, upper_bound) -> None:
        self._lower = np.float64(lower_bound)
        self._upper = np.float64(upper_bound)
        if self._lower > self._upper:
            raise ValueError("lower bound must not exceed upper bound")
        super().__init__(())

    def __len__(self) -> int:
        return 2

    def __getitem__(self, idx: int):
        if idx in (0, -2):
            return self._lower
        if idx in (1, -1):
            return self._upper
        raise KeyError(f"Index {idx} out of range")

    def __iter__(self):
        yield self._lower
        yield self._upper

    @functools.cached_property
    def boundary(self):
        return (Point(self._lower), Point(self._upper))

    @property
    def volume(self):
        return self._upper - self._lower

    def __contains__(self, item) -> bool:
        arr = np.asarray(item)
        if arr.shape != self.shape:
            return False
        return bool(self._lower <= arr <= self._upper)

    def __eq__(self, other):
        return isinstance(other, Interval) and tuple(self) == tuple(other)

    def __hash__(self):
        return hash((float(self._lower), float(self._upper)))

    def __repr__(self):
        return f"Interval({self._lower}, {self._upper})"

    def uniform_grid(self, shape, inset=0.0, centered: bool = False) -> np.ndarray:
        shape = as_shape(shape)
        assert len(shape) == 1
        if centered:
            # Cell midpoints of a uniform partition.
            edges = np.linspace(self._lower, self._upper, shape[0] + 1)
            return 0.5 * (edges[:-1] + edges[1:])
        return np.linspace(self._lower + inset, self._upper - inset, shape[0])


class CartesianProduct(Domain):
    def __init__(self, *factors: Domain) -> None:
        self._factors = tuple(asdomain(f) for f in factors)
        if not all(f.ndim <= 1 for f in self._factors):
            raise ValueError("Cartesian-product factors must be at most 1-D.")
        dim = sum(f.dimension for f in self._factors)
        super().__init__((dim,))

    @property
    def factors(self):
        return self._factors

    def __len__(self) -> int:
        return len(self._factors)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return self._factors[idx]
        return CartesianProduct(*self._factors[idx])

    @property
    def volume(self):
        vol = 1.0
        for f in self._factors:
            vol = vol * f.volume
        return vol

    @functools.cached_property
    def boundary(self):
        """Boundary faces: each factor replaced by one of its boundary parts
        (reference: ``domains/_cartesian_product.py:79``)."""
        parts = []
        for i, factor in enumerate(self._factors):
            for boundary_part in factor.boundary:
                parts.append(
                    CartesianProduct(
                        *self._factors[:i], boundary_part, *self._factors[i + 1 :]
                    )
                )
        return tuple(parts)

    def __eq__(self, other):
        return (
            isinstance(other, CartesianProduct) and self._factors == other._factors
        )

    def __hash__(self):
        return hash(self._factors)

    def __repr__(self):
        return f"CartesianProduct{self._factors}"

    def uniform_grid(self, shape, inset=0.0, centered: bool = False):
        # Distribute the per-factor grid sizes, treating Point factors as
        # singleton dimensions (reference: ``domains/_box.py:82-113``).
        interval_idcs = [
            i for i, f in enumerate(self._factors) if not isinstance(f, Point)
        ]
        shape = as_shape(shape, ndim=len(interval_idcs))
        insets = np.broadcast_to(inset, (len(interval_idcs),))

        factor_grids = []
        j = 0
        for i, factor in enumerate(self._factors):
            if isinstance(factor, Point):
                factor_grids.append(np.asarray(factor).reshape((1,)))
            else:
                if isinstance(factor, Interval):
                    factor_grids.append(
                        factor.uniform_grid(
                            (shape[j],), inset=insets[j], centered=centered
                        )
                    )
                else:
                    factor_grids.append(factor.uniform_grid((shape[j],)))
                j += 1
        return TensorProductGrid(*factor_grids, indexing="ij")


class Box(CartesianProduct):
    def __init__(self, bounds) -> None:
        bounds = np.array(bounds, dtype=np.float64, copy=True)
        bounds.flags.writeable = False
        if bounds.ndim != 2 or bounds.shape[-1] != 2:
            raise ValueError(f"`bounds` must have shape (D, 2), got {bounds.shape}")
        if not np.all(bounds[:, 0] <= bounds[:, 1]):
            raise ValueError("lower bounds must not exceed upper bounds")
        self._bounds = bounds
        super().__init__(
            *(
                Interval(lo, hi) if lo != hi else Point(lo)
                for lo, hi in bounds
            )
        )

    @property
    def bounds(self) -> np.ndarray:
        return self._bounds

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return self.factors[idx]
        return Box(self._bounds[idx, :])

    def __contains__(self, item) -> bool:
        arr = np.asarray(item)
        if arr.shape != self.shape:
            return False
        return bool(
            np.all((self._bounds[:, 0] <= arr) & (arr <= self._bounds[:, 1]))
        )

    def __eq__(self, other):
        return isinstance(other, Box) and np.array_equal(self.bounds, other.bounds)

    def __hash__(self):
        return hash(self._bounds.tobytes())

    def __repr__(self):
        return f"Box({self._bounds.tolist()})"


def asdomain(obj) -> Domain:
    """Coerce ``obj`` into a :class:`Domain` (reference:
    ``domains/_asdomain.py``): 2-sequences become intervals, scalars
    points, (d, 2) arrays boxes.

    Examples
    --------
    >>> import numpy as np
    >>> asdomain([0.0, 1.0])
    Interval(0.0, 1.0)
    >>> np.asarray(asdomain([0.0, 1.0]).uniform_grid(3))
    array([0. , 0.5, 1. ])
    >>> asdomain(np.asarray([[0.0, 1.0], [0.0, 2.0]])).shape
    (2,)
    """
    if isinstance(obj, Domain):
        return obj
    if isinstance(obj, (list, tuple)) and len(obj) == 2 and np.ndim(obj[0]) == 0:
        return Interval(obj[0], obj[1])
    arr = np.asarray(obj)
    if arr.ndim == 0:
        return Point(arr)
    if arr.ndim == 1 and arr.shape[0] == 2:
        return Interval(arr[0], arr[1])
    if arr.ndim == 2 and arr.shape[-1] == 2:
        return Box(arr)
    raise TypeError(f"Cannot interpret {obj!r} as a Domain.")
