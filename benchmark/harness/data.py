"""The benchmark's inputs, made on the device from the run's seed.

Frozen copies of the repository's data generators (``chip_smoke.py``:
``bench_data``, ``ibvp_data``; a problem's anchors are its module's): the same
distributions, drawn by a ``torch.Generator`` on the device instead of
numpy's seed 0, so that every seed gives another data set of the same sizes.  Each draw has a stream of its own, ``stream(seed, *key)``,
so that a step's data can be drawn again after the window for the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def stream(device, seed: int, *key: int) -> torch.Generator:
    """A generator on ``device`` for the draw ``key`` of run ``seed`` (any
    non-negative integer, also beyond 64 bits)."""
    state = np.random.SeedSequence([int(seed) % 2**128, *[int(k) for k in key]]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def uniform_points(g: torch.Generator, n: int, domain, dtype=torch.float64) -> torch.Tensor:
    """``n`` points uniform on the box ``domain`` (``[[lo, hi], ...]``;
    ``bench_data``'s X and Xq on [0, 5] x [-1, 1])."""
    u = torch.rand((n, len(domain)), generator=g, device=g.device, dtype=dtype)
    lo = torch.tensor([a for a, _ in domain], dtype=dtype, device=g.device)
    width = torch.tensor([b - a for a, b in domain], dtype=dtype, device=g.device)
    return u * width + lo


def normal(g: torch.Generator, n: int, dtype=torch.float64) -> torch.Tensor:
    """``n`` standard normal values (``bench_data``'s Y)."""
    return torch.randn(n, generator=g, device=g.device, dtype=dtype)


def log_uniform_sizes(lo: int, hi: int, count: int) -> list[int]:
    """``count`` batch sizes at the quantiles of a log-uniform law on [lo,
    hi]: every seed gets this same multiset, in an order of its own."""
    q = (np.arange(count) + 0.5) / count
    return [int(round(lo * (hi / lo) ** x)) for x in q]
