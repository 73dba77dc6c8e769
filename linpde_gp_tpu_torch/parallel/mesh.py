"""The process mesh of the parallel layer, on ``torch.distributed``.

Port of ``linpde_gp_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over the devices of one process and lets
``shard_map`` move data; here every rank of the default process group is
one process with one device, and every change of layout is a collective
that the calling module writes itself.  A :class:`Mesh` is the ranks laid
out rows-major over named axes (``("rows", "cols")`` for Gram and
Cholesky work), with one process group per line of each axis, created at
construction.  Its collectives are the three that both backends take with
equal-size pieces: ``all_gather``, ``all_reduce`` and ``broadcast`` (gloo
on the CPU, NCCL on cards).

Each rank's device is ``cuda:{LOCAL_RANK}`` (modulo the cards present) or
the CPU when asked for (``device="cpu"`` or ``config.device``).  Without a
process group, :func:`make_mesh` first starts one of world size 1 in this
process (NCCL for a card, gloo for the CPU), so that ``make_mesh(1)``
works as JAX's does; under ``torchrun`` it joins the world from the
environment.
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device

#: Meshes already built, by (process group, shape, axis names, device): a
#: mesh's groups are created collectively, once.
_MESHES: dict = {}


def _init_world(device: torch.device) -> None:
    """Start the default process group if there is none: from the
    environment under ``torchrun`` (``WORLD_SIZE`` set), else a world of one
    rank in this process, its store a file in a fresh temporary directory."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = os.path.join(tempfile.mkdtemp(prefix="lgt_world_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU if asked for, else ``cuda:{LOCAL_RANK}``
    (the global rank without ``LOCAL_RANK``) modulo the cards present."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """The ranks of the default process group laid out rows-major over
    ``axis_names`` with ``shape``; this rank's coordinates, device and
    the process groups along each axis through it."""

    def __init__(self, shape: tuple, axis_names: tuple, device: torch.device):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if self.size != dist.get_world_size():
            raise ValueError(f"a mesh of {self.size} ranks in a world of {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.device = device
        self._dims = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(self.rank, self._dims))))
        ranks = np.arange(self.size).reshape(self._dims)
        self._groups = {}
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, a, -1).reshape(-1, self._dims[a])
            for line in lines:  # every rank creates every group, in one order
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[(name,)] = (group, [int(r) for r in line])
        self._groups[self.axis_names] = (dist.group.WORLD, list(range(self.size)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"

    def _group(self, axes):
        axes = self.axis_names if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
        if axes not in self._groups:
            raise ValueError(f"no group over axes {axes}; have {list(self._groups)}")
        return self._groups[axes]

    def all_gather(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """Concatenate every rank's ``t`` (equal shapes) along dim 0 in the
        order of their index along ``axes``."""
        group, members = self._group(axes)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in members]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, 0)

    def all_reduce(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """Sum ``t`` over the ranks along ``axes``, in place; returns it."""
        group, _ = self._group(axes)
        dist.all_reduce(t, group=group)
        return t

    def broadcast(self, t: torch.Tensor, src: int, axes=None) -> torch.Tensor:
        """``t`` of the rank at index ``src`` along ``axes``, in place on
        every rank there (equal shapes); returns it."""
        group, members = self._group(axes)
        dist.broadcast(t, src=members[src], group=group)
        return t


def make_mesh(n_devices: int | None = None, axis_names=("rows", "cols"), *, device=None) -> Mesh:
    """2-D mesh over the ``n_devices`` ranks of the world (``None``: all of
    them), as square as possible, rows-major (``mesh.py:18-29`` of the JAX
    package): 4 ranks are 2 x 2, 8 are 2 x 4."""
    dev = rank_device(device)
    _init_world(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh({n}) in a world of {world} ranks: a mesh spans the whole world")
    rows = int(math.floor(math.sqrt(n)))
    while n % rows:
        rows -= 1
    return _mesh((rows, n // rows), tuple(axis_names), rank_device(device))


def make_1d_mesh(n_devices: int | None = None, axis_name: str = "shards", *, device=None) -> Mesh:
    """1-D mesh over the ``n_devices`` ranks of the world."""
    dev = rank_device(device)
    _init_world(dev)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _mesh((n,), (axis_name,), rank_device(device))


def _mesh(shape, axis_names, device) -> Mesh:
    key = (id(dist.distributed_c10d._get_default_group()), shape, axis_names, str(device))
    if key not in _MESHES:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        _MESHES[key] = Mesh(shape, axis_names, device)
    return _MESHES[key]


def row_sharding(mesh: Mesh, x) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis, split over
    every rank (``P(mesh.axis_names)`` of the JAX package), on the rank's
    device; the leading axis must divide by the mesh size."""
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """``x`` as rank 0 holds it, on every rank's device (``P()``)."""
    return mesh.broadcast(torch.as_tensor(x).to(mesh.device).contiguous().clone(), 0)
