"""The collectives of the mesh-sharded solvers, and the rank's rows.

Every collective here is one ``all_reduce``, the one collective that NCCL
and gloo both carry for every device:

* :func:`psum` sums a list of tensors over a mesh axis as ONE all-reduce
  of their flattened concatenation (the JAX package's single variadic
  ``psum`` of (H, g, cost));
* :func:`all_gather` / :func:`gather_rows` put each rank's rows at their
  place in a zero-filled buffer and sum it over the axis.  Exactly one
  rank writes each row, so the result is exact (x + 0 = x; a -0.0 comes
  back as +0.0).

gloo's all-reduce takes CUDA tensors as well as host ones, so one code
path serves NCCL on the card, gloo on the CPU and gloo on the card (two
ranks sharing one card, where NCCL refuses).  The sum of an all-reduce is
the same on every rank, so what the ranks decide from it (the loop's
accept / reject, its stop tests) never parts.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def psum(tensors, mesh, axis) -> list:
    """The sums over ``axis`` of ``tensors`` (one dtype), by one
    all-reduce."""
    tensors = list(tensors)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"psum of one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group(axis))
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def row_range(n: int, mesh, axis) -> tuple:
    """``(r0, r1)``: this rank's contiguous rows of an axis of ``n`` rows,
    ``NamedSharding(mesh, P(axis))``'s layout (``n`` divisible)."""
    size = mesh.size(axis)
    loc = n // size
    r = mesh.index(axis)
    return r * loc, (r + 1) * loc


def on_device(tree, device):
    """Every leaf of ``tree`` (a tensor, an array or a manifold pytree) as
    a tensor on ``device``."""
    return pytree.tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def local_rows(tree, r0: int, r1: int, dim: int, device):
    """Rows ``[r0, r1)`` along ``dim`` of every leaf of a global ``tree``,
    on ``device``."""
    return pytree.tree_map(
        lambda a: torch.as_tensor(a).narrow(dim, r0, r1 - r0).to(device),
        tree)


def gather_rows(tensors, index, n: int, mesh, axis, dim: int = 0) -> list:
    """Each tensor's rows along ``dim`` put at rows ``index`` (a slice or an
    index tensor, the same for all) of ``n`` rows, summed over ``axis``:
    the rows every rank holds, replicated.  One all-reduce a dtype; bools
    travel as uint8."""
    tensors = list(tensors)
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        bufs = []
        for i in idx:
            t = tensors[i].movedim(dim, 0)
            if dtype == torch.bool:
                t = t.to(torch.uint8)
            full = t.new_zeros((n,) + tuple(t.shape[1:]))
            full[index] = t
            bufs.append(full)
        sums = psum(bufs, mesh, axis)
        for i, s in zip(idx, sums):
            if dtype == torch.bool:
                s = s.to(torch.bool)
            out[i] = s.movedim(0, dim)
    return out


def all_gather(t: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """``t``, this rank's contiguous block of an axis split evenly over
    ``axis`` (:func:`row_range`), gathered along ``dim`` in rank order."""
    loc = t.shape[dim]
    r0 = mesh.index(axis) * loc
    return gather_rows([t], slice(r0, r0 + loc), loc * mesh.size(axis), mesh,
                       axis, dim)[0]
