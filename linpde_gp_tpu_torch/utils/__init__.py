"""Utilities of the port: shapes, serialization, profiling and (with
matplotlib installed) plotting."""

import importlib

from . import shapes

__all__ = ["shapes", "plotting"]


def __getattr__(name):
    # matplotlib is optional (the GPU machine has none): load plotting lazily.
    # import_module, not ``from . import``: that looks the name up here first.
    if name == "plotting":
        return importlib.import_module(f"{__name__}.plotting")
    raise AttributeError(name)
