"""Public API: ``optimize(x, fn, options)`` and ``build_solver``.

Counterpart of ``tinyopt_tpu.optimize`` (reference: include/tinyopt/
optimize.h:17-79) for residual functions (NLLS, LM/GN).  The scalar-cost,
manual-acc and numerical-differentiation modes are not ported yet.

Every solve runs the batch-native loop (optimizers/loop.py); a single
``optimize`` call is a batch of one whose outputs are squeezed to 0-d.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .diff.auto import make_nlls_system, num_residuals
from .optimizers.loop import (check_loop_supported, optimize_from_acc,
                              skipped_output)
from .options import Options
from .output import map_output


def _resolve_mode(fn, mode: str, x_example, data_example) -> str:
    """Only residual functions are ported: "auto" resolves to them unless
    ``fn`` returns a manual accumulation ``(cost, grad[, H])``."""
    if mode == "residuals":
        return mode
    if mode != "auto":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP Queue 1, slice B "
            "item 10: cost/acc/numdiff modes)")
    out = fn(x_example) if data_example is None else fn(x_example,
                                                        data_example)
    if isinstance(out, (tuple, list)) and len(out) in (2, 3):
        dims = mf.tangent_spec(x_example).dims
        second = out[1]
        if isinstance(second, torch.Tensor) and tuple(second.shape) == (dims,) \
                and torch.as_tensor(out[0]).numel() == 1:
            raise NotImplementedError(
                "manual accumulation functions (cost, grad[, H]) are not "
                "ported yet (ROADMAP Queue 1, slice B item 10)")
    return "residuals"


def build_batch_solver(fn: Callable, options: Options, mode: str, x_example,
                       data_example=None) -> Callable:
    """``solve(x0_batch[, data_batch]) -> (x_opt_batch, Output)`` through the
    batch-native loop.  ``fn(x)`` (or ``fn(x, data)``) is the residual
    function of ONE instance; every tensor of ``x0_batch`` (manifold
    leaves included: a batched ``SE3`` holds (B, 4) and (B, 3)) and of
    ``data_batch`` has a leading instance axis."""
    check_loop_supported(options)
    x_example = mf.as_pytree(x_example)
    _resolve_mode(fn, mode, x_example, data_example)
    spec = mf.tangent_spec(x_example)
    n_res = num_residuals(fn, x_example, data_example)

    def solve(x0_batch, data_batch=None):
        x0 = mf.flatten_batch(x0_batch, spec)
        if n_res == 0:
            cap = options.max_iters + 1 + (1 if options.check_final_cost
                                           else 0)
            out = skipped_output(x0.shape[0],
                                 cap if options.save_history else 0,
                                 spec.dtype, x0.device)
            return x0_batch, out
        acc, ev, _ = make_nlls_system(fn, x_example, spec, data_batch,
                                      data_example)
        x, out = optimize_from_acc(x0, acc, ev, options, spec)
        return mf.unflatten(x, spec), out

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
    function ``fn``. Returns ``(x_opt, Output)``.

        T, out = optimize(SE3.identity(), lambda T: (prior_inv @ T).log())
    """
    options = options or Options()
    x = mf.as_pytree(x)
    t0 = time.perf_counter()
    x_opt, out = build_solver(fn, options, mode, x)(x)
    out.duration_ms = torch.tensor((time.perf_counter() - t0) * 1e3,
                                   dtype=torch.float32)
    return x_opt, out
