"""Public API: ``optimize(x, fn, options)`` and ``build_solver``.

Counterpart of ``tinyopt_tpu.optimize`` (reference: include/tinyopt/
optimize.h:17-79), which dispatches on what ``fn`` computes:

  * a residual pytree (NLLS)         -> automatic differentiation
    (``torch.func``), or finite differences when ``torch.func`` cannot
    differentiate ``fn`` (``Output.num_diff_used``), or ``mode="numdiff"``
  * ``(cost, grad, H)``              -> manual accumulation (``mode="acc"``)

The first-order solvers (a scalar cost, ``(cost, grad)``) are not ported
yet.  Every solve runs the batch-native loop (optimizers/loop.py); a
single ``optimize`` call is a batch of one whose outputs are squeezed to
0-d.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .cost import Cost
from .diff.auto import make_acc_system, make_nlls_system, num_residuals
from .diff.num_diff import make_num_diff_system
from .optimizers.loop import (check_loop_supported, optimize_from_acc,
                              skipped_output)
from .options import FIRST_ORDER_TYPES, Options
from .output import map_output

#: What ``torch.func`` raises for a function it cannot differentiate.
_AD_ERRORS = (RuntimeError, NotImplementedError, TypeError, ValueError)
#: The device's own failures (RuntimeErrors too), never read as "not
#: differentiable".
_DEVICE_ERRORS = tuple(getattr(torch, n) for n in ("OutOfMemoryError",
                                                   "AcceleratorError")
                       if hasattr(torch, n))


def _numel(v) -> int:
    return math.prod(v.shape) if hasattr(v, "shape") else 1


def _detect_mode(fn, x, options: Options, dims: int, data=None) -> str:
    """Signature dispatch (optimize.h:26-76) on one evaluation of ``fn``:
    ``(cost_like, grad (dims,)[, H (dims, dims)])`` is a manual
    accumulation; anything else is residuals (a scalar cost for the
    first-order solvers).  A residual tuple is told apart by shape: the
    gradient spans the tangent, H is square over it, and a 2-element acc
    (no H) exists only for first-order solvers."""
    out = fn(x) if data is None else fn(x, data)
    first_order = options.solver_type in FIRST_ORDER_TYPES
    if isinstance(out, (tuple, list)) and len(out) in (2, 3):
        first, second = out[0], out[1]
        first_scalar = (hasattr(first, "shape") and _numel(first) == 1) \
            or isinstance(first, (tuple, list, Cost))
        grad_ok = hasattr(second, "shape") and tuple(second.shape) == (dims,)
        if len(out) == 2:
            h_ok = first_order
        else:
            h_ok = hasattr(out[2], "shape") and tuple(out[2].shape) == (
                dims, dims)
        if first_scalar and grad_ok and h_ok:
            return "acc"
    if first_order:
        leaves = pytree.tree_leaves(out)
        if any(getattr(l, "dim", lambda: 0)() > 0 for l in leaves) and all(
                _numel(l) == 1 for l in leaves):
            raise ValueError(
                "GradientDescent auto-dispatch: the function returns a "
                "size-1 tensor, which is ambiguous — pass mode=\"cost\" "
                "(minimize the value) or mode=\"residuals\" (minimize its "
                "square) explicitly, or return a 0-d scalar (reference: "
                "optimize.h:59-72)")
        return "cost"
    return "residuals"


def _ad_works(fn, x_example, spec, data_example) -> bool:
    """Whether ``torch.func`` differentiates ``fn`` on the example: one
    accumulation of a batch of one, on the example's device.  (The JAX
    package traces abstractly; meta and fake tensors cannot stand in here,
    as torch.func on them refuses ordinary residuals such as
    ``x1 + 10.0 * x2``.)"""
    x1 = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x_example),
                          spec)
    d1 = (None if data_example is None
          else pytree.tree_map(lambda a: torch.as_tensor(a)[None],
                               data_example))
    acc, _, _ = make_nlls_system(fn, x_example, spec, d1, data_example)
    try:
        acc(x1)
    except _DEVICE_ERRORS:
        raise
    except _AD_ERRORS:
        return False
    return True


def resolve_mode(fn, options: Options, mode: str, x_example,
                 data_example=None) -> tuple[str, bool]:
    """(mode, num_diff_used): ``"auto"`` resolved by :func:`_detect_mode`,
    and a residual function ``torch.func`` cannot differentiate moved to
    ``"numdiff"`` (the reference's numdiff fallback, optimizer.h:167-182).
    Raises for the modes GN / LM / DogLeg cannot run."""
    x_example = mf.as_pytree(x_example)
    spec = mf.tangent_spec(x_example)
    first_order = options.solver_type in FIRST_ORDER_TYPES
    if mode == "auto":
        mode = _detect_mode(fn, x_example, options, spec.dims, data_example)
    if mode not in ("residuals", "numdiff", "cost", "acc"):
        raise ValueError(f"Unknown mode {mode!r}")
    if mode == "cost" and not first_order:
        raise ValueError(
            "GN/LM cannot optimize a gradient-only/scalar cost function; "
            "provide residuals or an acc returning H "
            "(reference: optimize.h:40-57)")
    if first_order:
        check_loop_supported(options)      # raises: not ported yet
    if mode == "residuals" and not _ad_works(fn, x_example, spec,
                                             data_example):
        return "numdiff", True
    return mode, mode == "numdiff"


def build_batch_solver(fn: Callable, options: Options, mode: str, x_example,
                       data_example=None, *,
                       num_diff_used: bool | None = None) -> Callable:
    """``solve(x0_batch[, data_batch]) -> (x_opt_batch, Output)`` through the
    batch-native loop.  ``fn(x)`` (or ``fn(x, data)``) is the residual or
    manual accumulation function of ONE instance; every tensor of
    ``x0_batch`` (manifold leaves included: a batched ``SE3`` holds (B, 4)
    and (B, 3)) and of ``data_batch`` has a leading instance axis.
    ``num_diff_used``: ``None`` resolves ``mode`` here; else ``mode`` was
    resolved by :func:`resolve_mode`, which returned this flag beside it."""
    check_loop_supported(options)
    x_example = mf.as_pytree(x_example)
    if num_diff_used is None:
        mode, num_diff_used = resolve_mode(fn, options, mode, x_example,
                                           data_example)
    spec = mf.tangent_spec(x_example)
    n_res = (None if mode == "acc"
             else num_residuals(fn, x_example, data_example))

    def system(data_batch):
        if mode == "acc":
            return make_acc_system(fn, x_example, spec, False,
                                   options.hessian.H_is_full, data_batch)
        make = make_nlls_system if mode == "residuals" \
            else make_num_diff_system
        return make(fn, x_example, spec, data_batch, data_example)

    def solve(x0_batch, data_batch=None):
        x0 = mf.flatten_batch(x0_batch, spec)
        if n_res == 0:
            cap = options.max_iters + 1 + (1 if options.check_final_cost
                                           else 0)
            out = skipped_output(x0.shape[0],
                                 cap if options.save_history else 0,
                                 spec.dtype, x0.device)
        else:
            acc, ev, _ = system(data_batch)
            x0, out = optimize_from_acc(x0, acc, ev, options, spec)
        out.num_diff_used = num_diff_used
        return mf.unflatten(x0, spec), out

    return solve


def build_solver(fn: Callable, options: Options, mode: str,
                 x_example) -> Callable:
    """Build ``solve(x) -> (x_opt, Output)`` for one instance."""
    batch = build_batch_solver(fn, options, mode, x_example)

    def solve(x):
        xb = pytree.tree_map(lambda a: a[None], mf.as_pytree(x))
        xo, out = batch(xb)
        return (pytree.tree_map(lambda a: a[0], xo),
                map_output(lambda v: v[0], out))

    return solve


def optimize(x, fn: Callable, options: Options | None = None, *,
             mode: str = "auto"):
    """Optimize ``x`` (a tensor, a manifold element such as
    ``manifolds.SE3``, or a dict/tuple of them) to minimize the residual
    or manual accumulation function ``fn``; ``mode`` is "auto",
    "residuals", "numdiff" or "acc".  Returns ``(x_opt, Output)``.

        T, out = optimize(SE3.identity(), lambda T: (prior_inv @ T).log())
    """
    options = options or Options()
    x = mf.as_pytree(x)
    t0 = time.perf_counter()
    x_opt, out = build_solver(fn, options, mode, x)(x)
    out.duration_ms = torch.tensor((time.perf_counter() - t0) * 1e3,
                                   dtype=torch.float32)
    return x_opt, out
