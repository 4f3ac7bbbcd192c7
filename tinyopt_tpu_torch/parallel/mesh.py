"""Device meshes over ``torch.distributed``.

Counterpart of ``tinyopt_tpu.parallel.mesh``.  The scale-out axes: ``batch``
shards problem instances (data parallel) and ``block`` shards residual
blocks or landmarks within one instance, with the partial normal equations
summed over the axis.

JAX runs one controller that drives every device; PyTorch runs one process
a rank.  So a mesh here is a named layout of the ranks of the default
process group (a :class:`torch.distributed.device_mesh.DeviceMesh`), and
every rank calls the same entry point with the same global inputs: the
entry cuts out its rank's rows, computes its partials, completes them with
collectives and returns the replicated result (``parallel/_collectives``).

    init_distributed(device="cpu", init_method="file:///tmp/store",
                     rank=r, world_size=n)
    mesh = make_mesh(batch=n // 2, block=2, device="cpu")

``devices=`` names the ranks a mesh lays out, in order (JAX: the devices);
every rank of the world constructs the mesh, as ``DeviceMesh`` requires.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class Mesh:
    """A named mesh of ranks: ``shape[name]`` is an axis's size (as JAX's
    ``Mesh.shape``), ``device`` the rank's device.  An axis is one name or
    a tuple of names, the flattened group of those dimensions in row-major
    order (``P(("batch", "block"))``)."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self._groups = {}

    def _names(self, axis) -> tuple:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for n in names:
            if n not in self.shape:
                raise ValueError(f"mesh has no axis {n!r} (axes "
                                 f"{self.axis_names})")
        return names

    def size(self, axis) -> int:
        """Ranks along ``axis``."""
        return math.prod(self.shape[n] for n in self._names(axis))

    def index(self, axis) -> int:
        """This rank's coordinate along ``axis`` (row-major over a tuple)."""
        coord = dict(zip(self.axis_names, self.device_mesh.get_coordinate()))
        i = 0
        for n in self._names(axis):
            i = i * self.shape[n] + coord[n]
        return i

    def group(self, axis):
        """The process group of the ranks that share this rank's coordinates
        off ``axis``.  A tuple's groups are made on first use by every rank
        of the world in one order, as ``new_group`` requires (every rank
        calls the same entry point)."""
        names = self._names(axis)
        if len(names) == 1:
            return self.device_mesh.get_group(names[0])
        if names not in self._groups:
            dims = [self.axis_names.index(n) for n in names]
            rest = [d for d in range(len(self.axis_names)) if d not in dims]
            ranks = self.device_mesh.mesh.permute(*rest, *dims).reshape(
                -1, self.size(names))
            me = dist.get_rank()
            for row in ranks.tolist():
                g = dist.new_group(row)
                if me in row:
                    self._groups[names] = g
        return self._groups[names]


def _device(device: str) -> torch.device:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device "
                               "(torch.cuda.is_available() is False)")
        return torch.device("cuda", torch.cuda.current_device())
    if device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return torch.device("cpu")


def make_mesh(batch: int | None = None, block: int = 1, devices=None,
              axis_names=("batch", "block"), device: str = "cuda") -> Mesh:
    """A 2-D (batch, block) mesh over the given ranks (default: every rank
    of the world, in order) on ``device`` ("cuda" or "cpu")."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if batch is None:
        batch = n // block
    if batch * block != n:
        raise ValueError(f"mesh {batch}x{block} != {n} devices")
    dev = _device(device)
    return Mesh(DeviceMesh(device, torch.tensor(ranks).reshape(batch, block),
                           mesh_dim_names=tuple(axis_names)), dev)


def local_mesh(axis_name: str = "batch", device: str = "cuda") -> Mesh:
    """1-D mesh over every rank of the world."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    dev = _device(device)
    return Mesh(DeviceMesh(device, torch.arange(dist.get_world_size()),
                           mesh_dim_names=(axis_name,)), dev)


def init_distributed(device: str = "cuda", backend: str | None = None,
                     local_rank: int | None = None, **kwargs) -> None:
    """Initialize the default process group (a no-op if one exists).

    ``device`` "cuda" binds the rank to ``cuda:{local_rank}`` (the
    argument, else ``LOCAL_RANK``, else the rank) and defaults the backend
    to NCCL; "cpu" defaults it to gloo.  ``kwargs`` go to
    ``torch.distributed.init_process_group``: ``init_method`` (a
    ``file://`` store needs no network), ``rank``, ``world_size``..."""
    if dist.is_initialized():
        return
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA "
                               "device (torch.cuda.is_available() is False)")
        if local_rank is None:
            local_rank = int(os.environ.get(
                "LOCAL_RANK", kwargs.get("rank", os.environ.get("RANK", 0))))
        if not 0 <= local_rank < torch.cuda.device_count():
            raise ValueError(f"local_rank {local_rank} but "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(local_rank)
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(
        backend=backend or ("nccl" if device == "cuda" else "gloo"), **kwargs)
