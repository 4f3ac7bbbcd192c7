"""Batched instances: many independent solves as one batch.

Counterpart of ``tinyopt_tpu.parallel.batched`` without a mesh.  With
``hessian.solver="fused"`` and a configuration inside
``ops.cuda_solver.fused_plan``, the whole batched solve is the fused
path (the K2 kernel on a CUDA device, its plain twin on the CPU).  Every
other configuration runs the batch-native loop, where "fused" means the
"cg" solver (K1 on a CUDA device).  Nothing falls back after a failure: a
kernel that does not build or launch raises.
"""

from __future__ import annotations

from typing import Callable

from torch.utils import _pytree as pytree

from ..optimize import build_batch_solver, resolve_mode
from ..options import Options


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
                     *, data_batch=None, mode: str = "auto", mesh=None):
    """Solve a batch of independent instances.

    ``x0_batch`` (and each leaf of ``data_batch``) has a leading instance
    axis.  ``mesh`` (multi-device sharding) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "batched_optimize(mesh=...) is not ported yet (ROADMAP Queue 1, "
            "slice D item 17)")
    options = options or Options()
    x_example = pytree.tree_map(lambda a: a[0], x0_batch)
    data_example = (None if data_batch is None
                    else pytree.tree_map(lambda a: a[0], data_batch))
    solve = batched_solver(fn, options, mode, x_example, data_example)
    if data_batch is None:
        return solve(x0_batch)
    return solve(x0_batch, data_batch)
