"""Namespace mirroring the reference's ``linpde_gp.linfunctls.projections``."""

from . import l2

__all__ = ["l2"]
