"""Global configuration of the PyTorch/CUDA port.

Counterpart of ``linpde_gp_tpu/config.py``, cut to what the gram-free
conditioning path reads.  Three arithmetic modes evaluate the kernel:

- ``"plain"``: float32, the plain kernel body;
- ``"ff"``: float32 float-float pairs (``ops/ff.py``), the JAX package's
  ``compensated=True`` body;
- ``"f64"``: native float64, the plain body instantiated for ``double``.

``mode`` has no default: every entry point takes ``mode=`` or reads it
from here, and raises if neither is set.  Which mode a benchmark should
default to is an open question that measurements on the card decide
(PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

MODES = ("plain", "ff", "f64")


@dataclasses.dataclass
class _Config:
    #: Arithmetic mode (one of :data:`MODES`) used when a call passes none.
    mode: str | None = None

    #: Device used when a call passes none; ``None`` means "cuda" when a
    #: card is present and "cpu" otherwise.
    device: str | None = None

    #: K1 (Gram) thread-block side: blocks of ``gram_tile x gram_tile``
    #: threads, one output entry each.
    gram_tile: int = 16

    #: K2 (Gram matvec) rows per block, which is also the width of the
    #: column tile staged in shared memory (plain and f64 bodies).
    matvec_tile: int = 128

    #: K2 rows per block / column-tile width for the float-float body.
    matvec_tile_compensated: int = 128


config = _Config()


def resolve_mode(mode: str | None) -> str:
    mode = config.mode if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (pass mode= or set config.mode), got {mode!r}")
    return mode


def mode_dtype(mode: str) -> torch.dtype:
    """Storage dtype of a mode: float64 for ``"f64"``, float32 otherwise."""
    return torch.float64 if resolve_mode(mode) == "f64" else torch.float32


def resolve_device(device=None) -> torch.device:
    if device is None:
        device = config.device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)
