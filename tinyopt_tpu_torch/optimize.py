"""Public API: ``optimize(x, fn, options)``, ``build_solver``,
``covariance_at`` and ``multi_start_optimize``.

Counterpart of ``tinyopt_tpu.optimize`` (reference: include/tinyopt/
optimize.h:17-79), which dispatches on what ``fn`` computes:

  * a residual pytree (NLLS)         -> automatic differentiation
    (``torch.func``), or finite differences when ``torch.func`` cannot
    differentiate ``fn`` (``Output.num_diff_used``), or ``mode="numdiff"``
  * a scalar cost                    -> reverse-mode AD for the
    first-order solvers (``mode="cost"``); their residual mode minimizes
    the sum of squared residuals
  * ``(cost, grad[, H])``            -> manual accumulation (``mode="acc"``)

Every solve runs the batch-native loop (optimizers/loop.py); a single
``optimize`` call is a batch of one whose outputs are squeezed to 0-d.
``options.max_duration_ms > 0`` makes ``optimize`` a host-stepped solve
that checks the wall clock between iterations (the reference's
kTimedOut).  As in the JAX package, only ``optimize`` reads it: a batched
solve runs its iterations whatever the budget.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .cost import Cost, normalize_cost
from .diff.auto import (flatten_residuals, make_acc_system, make_cost_system,
                        make_nlls_system, num_residuals)
from .diff.num_diff import make_num_diff_system
from .ops.linalg import cov_rescale, inv_cov
from .optimizers.loop import optimize_from_acc, skipped_output
from .options import FIRST_ORDER_TYPES, Options
from .output import map_output
from .stop_reasons import StopReason

#: What ``torch.func`` raises for a function it cannot differentiate.
_AD_ERRORS = (RuntimeError, NotImplementedError, TypeError, ValueError)
#: The device's own failures (RuntimeErrors too), never read as "not
#: differentiable".
_DEVICE_ERRORS = tuple(getattr(torch, n) for n in ("OutOfMemoryError",
                                                   "AcceleratorError")
                       if hasattr(torch, n))
_RUNNING = (int(StopReason.NONE), int(StopReason.MAX_ITERS))


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
    and a residual function of GN / LM / DogLeg that ``torch.func`` cannot
    differentiate moved to ``"numdiff"`` (the reference's numdiff
    fallback, optimizer.h:167-182).  Raises for the modes GN / LM / DogLeg
    cannot run."""
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
    if mode == "residuals" and not first_order and not _ad_works(
            fn, x_example, spec, data_example):
        return "numdiff", True
    return mode, mode == "numdiff"


class _System(NamedTuple):
    """A resolved problem: ``make(data_batch) -> (accumulate, evaluate)``
    over flat (B, P) parameters, with what the callers need beside it."""

    make: Callable
    n_res: int | None
    spec: mf.TangentSpec
    mode: str
    num_diff_used: bool


def _build_system(fn: Callable, options: Options, mode: str, x_example,
                  data_example=None, num_diff_used: bool | None = None
                  ) -> _System:
    """Resolve ``mode`` (unless ``num_diff_used`` says it already was) and
    the system constructor of ``tinyopt_tpu.optimize._build_system``: the
    first-order types get a scalar cost differentiated in reverse mode
    (their residual mode squares and sums the residuals), GN / LM /
    DogLeg the normal equations."""
    x_example = mf.as_pytree(x_example)
    if num_diff_used is None:
        mode, num_diff_used = resolve_mode(fn, options, mode, x_example,
                                           data_example)
    spec = mf.tangent_spec(x_example)
    first_order = options.solver_type in FIRST_ORDER_TYPES
    print_J = options.log.enable and options.log.print_J_jet

    def sum_squares(x, *data):
        return torch.sum(torch.square(flatten_residuals(fn(x, *data))))

    if mode == "acc":
        n_res = None
    elif first_order and mode in ("cost", "residuals"):
        n_res = 1
        if mode == "cost":      # make_cost_system's scalar check, once
            make_cost_system(fn, x_example, spec, None, data_example)
    else:
        n_res = num_residuals(fn, x_example, data_example)

    def make(data_batch=None):
        if mode == "acc":
            acc, ev, _ = make_acc_system(fn, x_example, spec, first_order,
                                         options.hessian.H_is_full,
                                         data_batch)
        elif first_order and mode in ("cost", "residuals"):
            acc, ev, _ = make_cost_system(
                fn if mode == "cost" else sum_squares, x_example, spec,
                data_batch, data_example)
        elif mode == "numdiff":
            acc, ev, _ = make_num_diff_system(
                fn, x_example, spec, data_batch, data_example,
                first_order=first_order)
        else:
            acc, ev, _ = make_nlls_system(fn, x_example, spec, data_batch,
                                          data_example, print_J=print_J)
        return acc, ev

    return _System(make, n_res, spec, mode, num_diff_used)


def _history_cap(options: Options) -> int:
    return (options.max_iters + 1 + (1 if options.check_final_cost else 0)
            ) if options.save_history else 0


def build_batch_solver(fn: Callable, options: Options, mode: str, x_example,
                       data_example=None, *,
                       num_diff_used: bool | None = None,
                       warm_start=None) -> Callable:
    """``solve(x0_batch[, data_batch]) -> (x_opt_batch, Output)`` through the
    batch-native loop.  ``fn(x)`` (or ``fn(x, data)``) is the residual,
    scalar cost or manual accumulation function of ONE instance; every
    tensor of ``x0_batch`` (manifold leaves included: a batched ``SE3``
    holds (B, 4) and (B, 3)) and of ``data_batch`` has a leading instance
    axis.  ``num_diff_used``: ``None`` resolves ``mode`` here; else
    ``mode`` was resolved by :func:`resolve_mode`, which returned this
    flag beside it.  ``warm_start=(g0[, H0])`` seeds the normal equations
    (``optimizers.loop.init_carry``)."""
    sysm = _build_system(fn, options, mode, x_example, data_example,
                         num_diff_used)
    spec = sysm.spec

    def solve(x0_batch, data_batch=None):
        x0 = mf.flatten_batch(x0_batch, spec)
        if sysm.n_res == 0:
            out = skipped_output(x0.shape[0], _history_cap(options),
                                 spec.dtype, x0.device)
        else:
            acc, ev = sysm.make(data_batch)
            x0, out = optimize_from_acc(x0, acc, ev, options, spec,
                                        warm_start=warm_start)
        out.num_diff_used = sysm.num_diff_used
        return mf.unflatten(x0, spec), out

    return solve


def _batch_of_one(batch_solve, x):
    xb = pytree.tree_map(lambda a: a[None], mf.as_pytree(x))
    xo, out = batch_solve(xb)
    return (pytree.tree_map(lambda a: a[0], xo),
            map_output(lambda v: v[0], out))


def build_solver(fn: Callable, options: Options, mode: str, x_example, *,
                 warm_start=None) -> Callable:
    """Build ``solve(x) -> (x_opt, Output)`` for one instance;
    ``warm_start=(g0[, H0])`` seeds the normal equations (the reference's
    ``InitWith``, optimizer.h:46-55): the first iteration evaluates the
    cost only and proposes from the given system."""
    batch = build_batch_solver(fn, options, mode, x_example,
                               warm_start=warm_start)
    return lambda x: _batch_of_one(batch, x)


def covariance_at(fn: Callable, x, options: Options | None = None, *,
                  mode: str = "auto", rescaled: bool = False,
                  data_batch=None):
    """Posterior covariance H(x)⁻¹ computed post hoc at ``x``.

    For solve paths that never form H (the fused whole-solve kernel, which
    requires ``save_last=False``): one accumulation of the un-damped
    normal equations at ``x``, inverted, with ``Output.covariance``'s
    rescale (output.h:80-93: × cost² / (n − dims) for overdetermined
    systems) when ``rescaled``.  ``x`` is one instance; with
    ``data_batch`` every tensor of ``x`` and of ``data_batch`` has a
    leading instance axis and ``fn(x, data)`` is one instance's function,
    as for ``batched_optimize``: the result is (B, D, D)."""
    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError("covariance requires a GN/LM-style Hessian; "
                         "first-order solver types build none")
    batched = data_batch is not None
    x = mf.as_pytree(x)
    xb = x if batched else pytree.tree_map(lambda a: a[None], x)
    x_example = pytree.tree_map(lambda a: a[0], xb)
    data_example = (None if data_batch is None
                    else pytree.tree_map(lambda a: a[0], data_batch))
    sysm = _build_system(fn, options, mode, x_example, data_example)
    acc, _ = sysm.make(data_batch)
    H, _, cost = acc(mf.flatten_batch(xb, sysm.spec))
    if not isinstance(H, torch.Tensor):
        raise ValueError(
            "covariance_at needs a dense Hessian (got "
            f"{type(H).__name__})")
    cov = inv_cov(H)
    if rescaled:
        scale = cov_rescale(cost.cost, cost.num_residuals, sysm.spec.dims)
        cov = cov * scale.to(cov.dtype)[:, None, None]
    return cov if batched else cov[0]


def optimize(x, fn: Callable, options: Options | None = None, *,
             mode: str = "auto"):
    """Optimize ``x`` (a tensor, a manifold element such as
    ``manifolds.SE3``, or a dict/tuple of them) to minimize the residual,
    scalar cost or manual accumulation function ``fn``; ``mode`` is
    "auto", "residuals", "numdiff", "cost" or "acc".  Returns
    ``(x_opt, Output)``.

        T, out = optimize(SE3.identity(), lambda T: (prior_inv @ T).log())
    """
    options = options or Options()
    x = mf.as_pytree(x)
    if options.max_duration_ms > 0:
        return _optimize_with_timeout(x, fn, options, mode)
    t0 = time.perf_counter()
    x_opt, out = build_solver(fn, options, mode, x)(x)
    out.duration_ms = torch.tensor((time.perf_counter() - t0) * 1e3,
                                   dtype=torch.float32)
    return x_opt, out


class _SegmentPair(NamedTuple):
    start: Callable      #: (x0_batch, data_batch=None) -> (x, Output, Carry)
    resume: Callable     #: (state, data_batch=None) -> (x, Output, Carry)
    evaluate: Callable   #: (x_batch, data_batch=None) -> normalized cost
    spec: mf.TangentSpec
    num_diff_used: bool
    mode: str
    n_res: int | None


def _segment_pair(fn, options: Options, mode: str, x_example,
                  iters_per_segment: int, data_example=None) -> _SegmentPair:
    """The segment functions shared by the timeout loop and
    ``checkpoint.segment_solver``: ``start`` and ``resume`` run exactly
    ``iters_per_segment`` loop iterations on a batch with the whole carry
    (``optimizers.loop.Carry``) as input and output; ``evaluate`` returns
    the (normalized) cost for the check_final_cost fallback."""
    seg_opts = options.replace(max_iters=iters_per_segment,
                               max_duration_ms=0.0, check_final_cost=False)
    sysm = _build_system(fn, seg_opts, mode, x_example, data_example)
    spec = sysm.spec

    def finish(x, out, st):
        out.num_diff_used = sysm.num_diff_used
        return mf.unflatten(x, spec), out, st

    def start(x0_batch, data_batch=None):
        acc, ev = sysm.make(data_batch)
        return finish(*optimize_from_acc(
            mf.flatten_batch(x0_batch, spec), acc, ev, seg_opts, spec,
            return_state=True))

    def resume(state, data_batch=None):
        acc, ev = sysm.make(data_batch)
        return finish(*optimize_from_acc(
            state.x, acc, ev, seg_opts, spec, segment_state=state,
            return_state=True))

    def evaluate(x_batch, data_batch=None):
        _, ev = sysm.make(data_batch)
        return normalize_cost(ev(mf.flatten_batch(x_batch, spec)),
                              seg_opts.cost).cost

    return _SegmentPair(start, resume, evaluate, spec, sysm.num_diff_used,
                        sysm.mode, sysm.n_res)


def _optimize_with_timeout(x, fn, options: Options, mode: str):
    """Host-stepped solve honoring ``max_duration_ms``
    (``tinyopt_tpu.optimize._optimize_with_timeout``): one loop iteration
    a segment with the complete loop state carried between segments,
    checking the wall clock in between (optimizer.h:302-305).  The
    trajectory is that of the unsegmented loop; a non-terminal exit
    (budget spent or timed out) returns the best accepted point."""
    t0 = time.perf_counter()
    pair = _segment_pair(fn, options, mode, x, 1)
    cap = _history_cap(options)
    if pair.n_res == 0 or pair.spec.dims == 0:
        leaf = pytree.tree_leaves(x)[0]
        out = map_output(lambda v: v[0], skipped_output(
            1, cap, pair.spec.dtype, torch.as_tensor(leaf).device))
        out.num_diff_used = pair.num_diff_used
        out.duration_ms = torch.tensor((time.perf_counter() - t0) * 1e3,
                                       dtype=torch.float32)
        return x, out
    budget = options.max_iters + 1 + (1 if options.check_final_cost else 0)
    xb = pytree.tree_map(lambda a: a[None], x)
    agg = _SegmentHistory(1, budget, options.save_history, pair.spec.dtype,
                          torch.as_tensor(pytree.tree_leaves(x)[0]).device)
    state, out, timed_out = None, None, False
    while agg.total < budget:
        _, out, state = (pair.start(xb) if state is None
                         else pair.resume(state))
        agg.add(out)
        if int(out.stop_reason[0]) not in _RUNNING:
            break
        if (time.perf_counter() - t0) * 1e3 > options.max_duration_ms:
            timed_out = True
            break
    x_final = mf.unflatten(_best_if_running(out, state), pair.spec)
    out = agg.finish(out)
    if timed_out:
        out.stop_reason = torch.full_like(out.stop_reason,
                                          int(StopReason.TIMED_OUT))
    out = map_output(lambda v: v[0], out)
    out.duration_ms = torch.tensor((time.perf_counter() - t0) * 1e3,
                                   dtype=torch.float32)
    return pytree.tree_map(lambda a: a[0], x_final), out


def _best_if_running(out, state):
    """Flat parameters to return after segments: an instance stopped by a
    segment boundary or the budget returns its best accepted point (the
    unsegmented loop gates its final apply, so its x is exactly that), a
    stopped one its x."""
    running = out.stop_reason == int(StopReason.MAX_ITERS)
    return torch.where(running[:, None], state.best_x, state.x)


class _SegmentHistory:
    """Per-instance iteration counts and history rows summed over segments:
    each segment's rows land at the instance's own iteration offset, so
    the rows (capacity ``budget``) equal an unsegmented solve's."""

    def __init__(self, B, budget, save_history, dtype, device):
        self.total = 0
        self.budget = budget
        self.iters = torch.zeros((B,), dtype=torch.int32, device=device)
        cap = budget if save_history else 0
        self.rows = [torch.zeros((B, cap), dtype=dtype, device=device),
                     torch.zeros((B, cap), dtype=dtype, device=device),
                     torch.zeros((B, cap), dtype=torch.bool, device=device)]
        self.num_hist = torch.zeros((B,), dtype=torch.int32, device=device)

    def add(self, out):
        k = out.errs.shape[-1]
        if self.rows[0].shape[-1] and k:
            cols = torch.arange(k, device=self.iters.device)
            dest = self.iters[:, None].long() + cols
            keep = (cols < out.num_hist[:, None]) & (dest < self.budget)
            dest = torch.where(keep, dest, torch.full_like(dest, self.budget))
            for i, src in enumerate((out.errs, out.deltas2, out.successes)):
                wide = torch.cat([self.rows[i], self.rows[i][:, :1]], dim=-1)
                self.rows[i] = wide.scatter(1, dest, src)[:, :self.budget]
            self.num_hist = torch.where(out.num_hist > 0,
                                        self.iters + out.num_hist,
                                        self.num_hist)
        self.iters = self.iters + out.num_iters
        self.total += int(out.num_iters.max())

    def finish(self, out):
        out.num_iters = self.iters
        out.errs, out.deltas2, out.successes = self.rows
        out.num_hist = self.num_hist
        return out


def multi_start_optimize(x0_batch, fn: Callable,
                         options: Options | None = None, *,
                         mode: str = "auto"):
    """Solve from many start points at once and return the best.

    Every start runs in one batch of the loop (with "cg" or "fused", K1
    each iteration, as the JAX package's vmap of ``build_solver`` does);
    the lowest-cost successful solve wins.  Returns ``(x_best, out_best,
    outs_all)``."""
    options = options or Options()
    x0_batch = mf.as_pytree(x0_batch)
    x_example = pytree.tree_map(lambda a: a[0], x0_batch)
    xs, outs = build_batch_solver(fn, options, mode, x_example)(x0_batch)
    cost = torch.where(outs.succeeded(), outs.final_cost.cost,
                       torch.full_like(outs.final_cost.cost, float("inf")))
    i = int(torch.argmin(cost))
    return (pytree.tree_map(lambda a: a[i], xs),
            map_output(lambda v: v[i], outs), outs)


# Reference-style alias
Optimize = optimize
