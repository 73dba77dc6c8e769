"""Posterior checkpoint and resume.

Port of ``linpde_gp_tpu/utils/serialization.py``: a conditioned posterior
(an ``IterativeGPRegressor`` with its solved weights, anchor factor and
Nyström factors, and the symbolic prior and operator, which are plain
Python objects) is written with :func:`torch.save` and read back with
:func:`torch.load`, its tensors mapped onto the device the caller names.
"""

from __future__ import annotations

import torch

from ..config import resolve_device


def save_posterior(path, posterior) -> None:
    """Write ``posterior`` to ``path``; the file holds every tensor's data
    whatever device it lies on."""
    torch.save(posterior, path)


def load_posterior(path, device=None):
    """Read a posterior written by :func:`save_posterior`, its tensors put
    on ``device`` (``None``: ``config.device``, else the card; without one
    it raises)."""
    return torch.load(path, map_location=resolve_device(device), weights_only=False)
