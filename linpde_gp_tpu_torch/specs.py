"""Kernel term specs as data.

At run time the gram-free path needs a kernel only as a ``(scale,
terms)`` spec of numbers: ``terms`` is a tuple of ``(coeff, factors)``
with one factor ``(kind, scale, poly, parity, prefactor)`` per input
dimension, each factor being ``prefactor * P(t) * exp(-t or -t^2) *
sign(d)^parity`` (``linpde_gp_tpu/ops/pallas_gram.py:29-32``).  The
port's symbolic layer derives them (``ops/gram.kernel_term_specs``);
this module loads and saves them as JSON, as hashable nested tuples (the
collapsed-group cache in ``ops/gram.py`` keys on them).

``data/heat_bench_specs.json`` holds the observation (``H k H*``) and
cross (``H k``) specs of the heat-equation benchmark problem, written
from the JAX package by ``tests/make_torch_spec_fixtures.py``: the
fixture that the port's derivation (``chip_smoke.py``, the tests) is
held to.
"""

from __future__ import annotations

import json
import math
import os

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
HEAT_BENCH_SPECS = os.path.join(DATA_DIR, "heat_bench_specs.json")


def to_tuple(spec) -> tuple:
    """Normalize a ``(scale, terms)`` spec into hashable nested tuples."""
    scale, terms = spec
    return float(scale), tuple(
        (
            float(coeff),
            tuple(
                (str(kind), float(s), tuple(float(c) for c in poly), int(parity), float(pref))
                for kind, s, poly, parity, pref in factors
            ),
        )
        for coeff, factors in terms
    )


def _to_json(spec) -> dict:
    scale, terms = to_tuple(spec)
    return {
        "scale": scale,
        "terms": [
            [coeff, [[kind, s, list(poly), parity, pref] for kind, s, poly, parity, pref in factors]]
            for coeff, factors in terms
        ],
    }


def save_specs(path: str, specs: dict) -> None:
    """Write ``{name: (scale, terms)}`` to ``path`` (floats round-trip exactly)."""
    with open(path, "w") as fh:
        json.dump({name: _to_json(spec) for name, spec in specs.items()}, fh, indent=1)
        fh.write("\n")


def load_specs(path: str = HEAT_BENCH_SPECS) -> dict:
    """Read ``{name: (scale, terms)}`` written by :func:`save_specs`."""
    with open(path) as fh:
        raw = json.load(fh)
    return {name: to_tuple((d["scale"], d["terms"])) for name, d in raw.items()}


def spec_diagonal(spec) -> float:
    """``k(x, x)`` of a stationary spec: every factor at ``d = 0`` is
    ``prefactor * poly[0]``, and a factor with a sign parity vanishes."""
    scale, terms = spec
    return scale * sum(
        coeff * math.prod(0.0 if parity else pref * poly[0] for _kind, _s, poly, parity, pref in factors)
        for coeff, factors in terms
    )
