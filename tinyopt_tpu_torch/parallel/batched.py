"""Batched instances: many independent solves as one batch, optionally
split over a mesh axis.

Counterpart of ``tinyopt_tpu.parallel.batched``.  With
``hessian.solver="fused"`` and a configuration inside
``ops.cuda_solver.fused_plan``, the whole batched solve is the fused
path (the K2 kernel on a CUDA device, its plain twin on the CPU).  Every
other configuration runs the batch-native loop, where "fused" means the
"cg" solver (K1 on a CUDA device).  Nothing falls back after a failure: a
kernel that does not build or launch raises.  With a mesh, each rank
solves its contiguous rows of the batch (one K2 launch a rank on the fused
path) and the results are gathered, so every rank returns the whole
batch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ..optimize import build_batch_solver, resolve_mode
from ..options import Options
from ..output import Output, map_output
from ._collectives import gather_rows, row_range


def batched_solver(fn: Callable, options: Options, mode: str, x_example,
                   data_example=None) -> Callable:
    """``solve(x_batch[, data_batch]) -> (x_opt_batch, Output_batch)``.

    ``fn`` is the residual, scalar cost (first-order types) or manual
    accumulation function of one instance; with ``data_example``,
    ``fn(x, data)`` receives per-instance data.  ``mode``: "auto",
    "residuals", "numdiff", "cost" or "acc" (``optimize.resolve_mode``; a
    residual function ``torch.func`` cannot differentiate runs "numdiff",
    outside the fused envelope, as are the first-order types)."""
    if options.hessian.solver == "fused":
        from ..ops.cuda_solver import fused_batched_solver, fused_plan
        mode, num_diff_used = resolve_mode(fn, options, mode, x_example,
                                           data_example)
        plan = fused_plan(options, mode, x_example, residual_fn=fn,
                          data_example=data_example)
        if plan is not None:
            return fused_batched_solver(fn, options, x_example, data_example,
                                        plan=plan)
        return build_batch_solver(fn, options, mode, x_example, data_example,
                                  num_diff_used=num_diff_used)
    return build_batch_solver(fn, options, mode, x_example, data_example)


def batched_optimize(x0_batch, fn: Callable, options: Options | None = None,
                     *, data_batch=None, mode: str = "auto", mesh=None,
                     axis="batch"):
    """Solve a batch of independent instances, optionally mesh-sharded.

    ``x0_batch`` (and each leaf of ``data_batch``) has a leading instance
    axis.  With ``mesh`` (``parallel.mesh``), every rank passes the whole
    batch; it solves its rows ``NamedSharding(mesh, P(axis))`` would give it
    (``axis`` a name or a tuple of names) on the mesh's device, and every
    rank returns the whole ``(x, Output)``."""
    options = options or Options()
    if mesh is not None:
        return shard_instances(
            lambda x, d: batched_optimize(x, fn, options, data_batch=d,
                                          mode=mode),
            (x0_batch, data_batch), mesh, axis)
    x_example = pytree.tree_map(lambda a: a[0], x0_batch)
    data_example = (None if data_batch is None
                    else pytree.tree_map(lambda a: a[0], data_batch))
    solve = batched_solver(fn, options, mode, x_example, data_example)
    if data_batch is None:
        return solve(x0_batch)
    return solve(x0_batch, data_batch)


def _map_tensors(fn, tree):
    """``fn`` on every tensor of ``tree``, an :class:`Output` included."""
    def f(v):
        if isinstance(v, Output):
            return map_output(fn, v)
        return fn(v) if isinstance(v, torch.Tensor) else v
    return pytree.tree_map(f, tree, is_leaf=lambda v: isinstance(v, Output))


def shard_instances(fn: Callable, args: tuple, mesh, axis="batch"):
    """``fn(*local_args)`` on this rank's rows of the leading instance axis
    of every tensor in ``args``, moved to the mesh's device; every tensor of
    the result (an :class:`Output`'s too) gathered along its leading axis,
    so each rank returns the whole batch."""
    leaves = [t for t in pytree.tree_leaves(args)
              if isinstance(t, torch.Tensor)]
    n = int(leaves[0].shape[0])
    size = mesh.size(axis)
    if n % size:
        raise ValueError(
            f"batch of {n} instances not divisible by mesh axis "
            f"{axis!r}={size}; pad the instance axis (pad_instances)")
    r0, r1 = row_range(n, mesh, axis)
    out = fn(*_map_tensors(lambda t: t[r0:r1].to(mesh.device), args))
    parts = []
    _map_tensors(lambda t: parts.append(t) or t, out)
    full = iter(gather_rows(parts, slice(r0, r1), n, mesh, axis))
    return _map_tensors(lambda t: next(full), out)
