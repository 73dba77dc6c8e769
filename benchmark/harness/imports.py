"""No module of JAX or of the JAX package may be loaded in a run's process."""

from __future__ import annotations

#: Top-level module names a run may not hold, compared whole:
#: ``linpde_gp_tpu_torch`` is not ``linpde_gp_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "linpde_gp_tpu")


def forbidden(module_names) -> list[str]:
    """The entries of ``module_names`` whose top-level name (the part before
    the first dot) is one of :data:`FORBIDDEN`."""
    return sorted(m for m in module_names if m.split(".", 1)[0] in FORBIDDEN)
