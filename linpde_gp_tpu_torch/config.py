"""Global configuration of the PyTorch/CUDA port.

Counterpart of ``linpde_gp_tpu/config.py``, cut to what the gram-free
and dense conditioning paths read.  The dense engine (``models/gp.py``)
runs in float64 and reads the Cholesky jitter and whether to refine;
the gram-free path evaluates the kernel in one of three arithmetic
modes:

- ``"plain"``: float32, the plain kernel body;
- ``"ff"``: float32 float-float pairs (``ops/ff.py``), the JAX package's
  ``compensated=True`` body;
- ``"f64"``: native float64, the plain body instantiated for ``double``.

``mode`` has no default: every entry point takes ``mode=`` or reads it
from here, and raises if neither is set.  Which mode a benchmark should
default to is an open question that measurements on the card decide
(PERF.md).

The JAX package's ``use_x64`` has no counterpart: it sets JAX's x64 flag,
and torch takes each tensor's dtype as given (the dense engine is float64
on every device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MODES = ("plain", "ff", "f64")


@dataclasses.dataclass
class _Config:
    #: Arithmetic mode (one of :data:`MODES`) used when a call passes none.
    mode: str | None = None

    #: Device used when a call passes none; ``None`` means "cuda", and
    #: raises where there is no card: the CPU runs only when asked for.
    device: str | None = None

    #: K1 (Gram) thread-block side: blocks of ``gram_tile x gram_tile``
    #: threads, one output entry each.
    gram_tile: int = 16

    #: Rows per block of the banded matvec, each block with its own
    #: column window, and the width of the column tiles that
    #: ``band_tiles`` / ``total_tiles`` count.  On the card it must be a
    #: multiple of 128 (the narrow walk's rows per block in every mode).
    matvec_tile: int = 128

    #: Jitter added to a Gram's diagonal before its Cholesky factorization,
    #: relative to the mean diagonal (JAX ``config.py:30``).
    cholesky_jitter: float = 0.0

    #: Gauss-Legendre nodes per panel of the quadrature fallbacks
    #: (``LebesgueIntegral``; the projections take ``max(order // 8, 8)`` per
    #: element), and panels per interval (JAX ``config.py:33,36``).
    quadrature_order: int = 64
    quadrature_panels: int = 4

    #: Mixed-precision dense conditioning: factor float64 Grams in float32
    #: and recover float64 accuracy by preconditioned-CG refinement
    #: (``ops/linalg/refine.py``).
    solve_refinement: bool = False

    #: Route float64 Gram assembly and Gram matvecs of CPU tensors through
    #: the g++ host engine (``native/``), as the JAX package routes its
    #: host path (``config.py:80-87`` there).
    use_native_host_engine: bool = True

    #: Pairs (rows * cols) from which the host engine takes a CPU call.
    native_gram_threshold: int = 1 << 20

    def set(self, **kwargs):
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise AttributeError(f"Unknown config key: {key}")
            setattr(self, key, value)


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
    """``device``, else ``config.device``, else the card: without one,
    ``RuntimeError``, never a quiet fall back to the CPU."""
    if device is None:
        device = config.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device=\"cpu\" or set config.device = \"cpu\" to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def as_f64(x, device=None) -> torch.Tensor:
    """``x`` (numpy, a tensor or a number) as a float64 tensor, the dense
    engine's storage: on ``device`` if given, else a tensor on its own device
    and anything else on :func:`resolve_device`'s."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else torch.device(device), dtype=torch.float64)
    return torch.tensor(np.asarray(x, dtype=np.float64), device=resolve_device(device))
