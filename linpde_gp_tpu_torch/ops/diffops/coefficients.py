"""Multi-index calculus: the canonical IR for linear differential operators.

Any linear differential operator is a sum of weighted partial derivatives

    L[f]_out = sum_{gamma, alpha} c[gamma][alpha] * d^alpha f_gamma

and is represented here as a coefficient table mapping input-codomain
indices ``gamma`` to ``{MultiIndex alpha: coefficient}``.  Port of
``linpde_gp_tpu/ops/diffops/coefficients.py`` (numpy only, unchanged):
the table the kernel-transformation rule engine consumes.  Its insertion
order sets the order of the derived kernel terms, so it must match the
JAX package's for the term specs to match tuple for tuple.
"""

from __future__ import annotations

import functools
from typing import Iterator, Mapping

import numpy as np

from ...utils.shapes import ShapeType, as_shape


class MultiIndex:
    """Derivative multi-index ``alpha`` for ``∂^alpha``.

    Stored as a flat C-order tuple of non-negative integer orders plus
    the domain shape — a plain hashable value type (it keys the rule
    tables of ``ops/transforms/dispatch.py``, so cheap, stable hashing
    matters more than array semantics).
    """

    __slots__ = ("_shape", "_orders")

    def __init__(self, orders, shape: ShapeType | None = None) -> None:
        if isinstance(orders, MultiIndex):
            self._shape = orders._shape
            self._orders = orders._orders
            return
        arr = np.asarray(orders, dtype=int)
        self._shape = arr.shape if shape is None else as_shape(shape)
        flat = tuple(int(o) for o in arr.reshape(-1))
        if any(o < 0 for o in flat):
            raise ValueError(f"derivative orders must be non-negative, got {flat}")
        if len(flat) != int(np.prod(self._shape, dtype=int)):
            raise ValueError(
                f"{len(flat)} orders do not fill domain shape {self._shape}"
            )
        self._orders = flat

    @classmethod
    def from_index(cls, index, shape: ShapeType, order: int) -> "MultiIndex":
        """Single ``∂^order/∂x_index`` index; all other entries zero."""
        shape = as_shape(shape)
        flat_pos = int(np.ravel_multi_index(index, shape)) if shape else 0
        size = int(np.prod(shape, dtype=int))
        orders = tuple(
            int(order) if i == flat_pos else 0 for i in range(size)
        )
        out = cls.__new__(cls)
        out._shape = shape
        out._orders = orders
        return out

    @property
    def order(self) -> int:
        return sum(self._orders)

    @property
    def is_mixed(self) -> bool:
        return sum(1 for o in self._orders if o) > 1

    @property
    def array(self) -> np.ndarray:
        return np.asarray(self._orders, dtype=int).reshape(self._shape)

    @property
    def shape(self) -> ShapeType:
        return self._shape

    def __getitem__(self, index) -> int:
        if self._shape == ():
            return self._orders[0]
        return self._orders[int(np.ravel_multi_index(index, self._shape))]

    def factorize_dimwise(self) -> tuple[int, ...]:
        """Per-dimension derivative orders as a flat tuple."""
        return self._orders

    def __hash__(self) -> int:
        return hash((self._shape, self._orders))

    def __eq__(self, other) -> bool:
        if not isinstance(other, MultiIndex):
            return NotImplemented
        return self._shape == other._shape and self._orders == other._orders

    def __repr__(self) -> str:
        return f"MultiIndex({list(self.array.tolist()) if self._shape else self._orders[0]})"


class PartialDerivativeCoefficients(Mapping):
    """``{input_codomain_idx: {MultiIndex: coefficient}}`` table."""

    def __init__(
        self,
        coefficient_dict,
        input_domain_shape,
        input_codomain_shape,
    ) -> None:
        input_domain_shape = as_shape(input_domain_shape)
        input_codomain_shape = as_shape(input_codomain_shape)

        self._num_entries = 0
        normalized: dict = {}
        for codomain_idx, terms in coefficient_dict.items():
            codomain_idx = tuple(codomain_idx)
            if len(codomain_idx) != len(input_codomain_shape) or not all(
                i < s for i, s in zip(codomain_idx, input_codomain_shape)
            ):
                raise ValueError(
                    f"Codomain index {codomain_idx} does not match shape "
                    f"{input_codomain_shape}."
                )
            normalized[codomain_idx] = {}
            for multi_index, coeff in terms.items():
                multi_index = MultiIndex(multi_index)
                if multi_index.shape != input_domain_shape:
                    raise ValueError(
                        f"Multi-index shape {multi_index.shape} does not match "
                        f"input domain shape {input_domain_shape}."
                    )
                normalized[codomain_idx][multi_index] = float(coeff)
                self._num_entries += 1

        self._coefficient_dict = normalized
        self._input_domain_shape = input_domain_shape
        self._input_codomain_shape = input_codomain_shape

    @property
    def num_entries(self) -> int:
        return self._num_entries

    @functools.cached_property
    def has_mixed(self) -> bool:
        return any(
            mi.is_mixed
            for terms in self._coefficient_dict.values()
            for mi in terms
        )

    @functools.cached_property
    def max_order(self) -> int:
        return max(
            (mi.order for terms in self._coefficient_dict.values() for mi in terms),
            default=0,
        )

    @property
    def input_domain_shape(self) -> ShapeType:
        return self._input_domain_shape

    @property
    def input_codomain_shape(self) -> ShapeType:
        return self._input_codomain_shape

    def __getitem__(self, codomain_idx):
        return self._coefficient_dict[tuple(codomain_idx)]

    def __len__(self) -> int:
        return len(self._coefficient_dict)

    def __iter__(self) -> Iterator:
        return iter(self._coefficient_dict)

    def items_flat(self):
        """Yield ``(codomain_idx, multi_index, coeff)`` triples."""
        for codomain_idx, terms in self._coefficient_dict.items():
            for multi_index, coeff in terms.items():
                yield codomain_idx, multi_index, coeff

    def __neg__(self) -> "PartialDerivativeCoefficients":
        return -1.0 * self

    def __add__(self, other) -> "PartialDerivativeCoefficients":
        if not isinstance(other, PartialDerivativeCoefficients):
            return NotImplemented
        if self.input_domain_shape != other.input_domain_shape:
            raise ValueError("input domain shapes do not match")
        if self.input_codomain_shape != other.input_codomain_shape:
            raise ValueError("input codomain shapes do not match")
        new_dict: dict = {
            idx: dict(terms) for idx, terms in self._coefficient_dict.items()
        }
        for idx, terms in other._coefficient_dict.items():
            tgt = new_dict.setdefault(idx, {})
            for mi, coeff in terms.items():
                tgt[mi] = tgt.get(mi, 0.0) + coeff
        return PartialDerivativeCoefficients(
            new_dict, self.input_domain_shape, self.input_codomain_shape
        )

    def __sub__(self, other):
        return self + (-other)

    def __rmul__(self, other) -> "PartialDerivativeCoefficients":
        if np.ndim(other) != 0:
            return NotImplemented
        return PartialDerivativeCoefficients(
            {
                idx: {mi: float(other) * c for mi, c in terms.items()}
                for idx, terms in self._coefficient_dict.items()
            },
            self.input_domain_shape,
            self.input_codomain_shape,
        )

    __mul__ = __rmul__

    def __repr__(self) -> str:
        return f"PartialDerivativeCoefficients({self._coefficient_dict})"
