"""Host native (C++/OpenMP) kernel reductions: the port's float64 CPU route.

Port of ``linpde_gp_tpu/native``.  On the card the Gram and the Gram
matvec are the CUDA kernels of ``csrc/``; on the CPU in mode ``f64`` and
above ``config.native_gram_threshold`` pairs, ``ops/gram.py`` routes them
through this engine, a formula-specialized C++ map-reduce built with g++.
"""

from .engine import NativeGramEngine, available, engine_for, engine_for_spec

__all__ = [
    "NativeGramEngine",
    "available",
    "engine_for",
    "engine_for_spec",
]
