"""Computation domains (port of ``linpde_gp_tpu/models/domains``, numpy).

``Domain`` with ``shape``/``volume``/``boundary``; ``Interval``,
``Point``, ``CartesianProduct``, ``Box``; ``asdomain``; and
``uniform_grid``, which gives ``TensorProductGrid``s on products, whose
factor structure the Kronecker Grams and the regressor's grid mode use.
"""

from .domain import Box, CartesianProduct, Domain, Interval, Point, asdomain
from .grid import TensorProductGrid, grid_factors

__all__ = [
    "Domain",
    "Point",
    "Interval",
    "CartesianProduct",
    "Box",
    "asdomain",
    "TensorProductGrid",
    "grid_factors",
]
