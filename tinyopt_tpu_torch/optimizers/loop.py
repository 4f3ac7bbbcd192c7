"""The outer optimization loop, batch-native.

Counterpart of ``tinyopt_tpu.optimizers.loop.optimize_from_acc``
(reference: include/tinyopt/optimizers/optimizer.h:243-534).  The JAX
package writes ONE instance's loop as a ``lax.while_loop`` and batches it
with ``vmap``; torch has no vmap of a while loop, so this loop is written
for a leading instance axis directly, with exactly the semantics vmap gives
the JAX loop:

  * every per-instance scalar is a (B,) tensor, the parameters a flat
    (B, P) tensor and the steps and gradients (B, D) tangent vectors; an
    accepted step is applied through the retraction of each leaf
    (``manifold.retract_flat``: ``x + δ`` for Euclidean leaves);
  * the loop runs while ANY instance is active; an instance whose stop
    reason is set (or whose iteration budget is spent) is frozen — its
    new state is computed and discarded by a select, as vmap does;
  * each ``lax.cond`` is a select between both branches; the inner
    solve-retry loop runs while any instance still retries, and updates
    only those.

A single solve is a batch of one.  Stop-reason codes and priorities, the λ
schedule with compounded bad factors, failure budgets, the first-iteration
auto-accept, exact rollback to the last accepted point, check_final_cost
and the history are those of the JAX loop.  Logging, stop callbacks,
segment / warm-start mode and the first-order solvers are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import manifold as mf
from ..cost import Cost, normalize_cost
from ..options import (FIRST_ORDER_TYPES, LAMBDA_SCHEDULED_TYPES, Options,
                       SolverType)
from ..output import Output
from ..solvers.lm import (LMState, lm_bad_step, lm_failed_step, lm_good_step,
                          lm_init, tr_bad_step, where_state)
from ..solvers.step import propose_step
from ..stop_reasons import StopReason
from ..utils import float_epsilon

_I32 = torch.int32


def check_loop_supported(opts: Options) -> None:
    """Raise ``NotImplementedError`` for options this loop does not serve."""
    if opts.solver_type in FIRST_ORDER_TYPES:
        raise NotImplementedError(
            f"{opts.solver_type.name}: first-order solvers are not ported "
            "yet (ROADMAP Queue 1, slice B item 11)")
    if opts.log.enable or opts.log.print_failure:
        raise NotImplementedError(
            "per-iteration logging is not ported yet (ROADMAP Queue 1, "
            "slice B item 11: profiling)")
    if opts.stop_callback is not None or opts.stop_callback2 is not None:
        raise NotImplementedError(
            "stop callbacks are not ported yet (ROADMAP Queue 1, slice B "
            "item 11)")
    if opts.max_duration_ms > 0:
        raise NotImplementedError(
            "max_duration_ms (the segmented timeout loop) is not ported "
            "yet (ROADMAP Queue 1, slice B item 11: checkpoint.py)")


def _where(pred, a, b):
    """Per-instance select: ``pred`` (B,) broadcast over trailing axes."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


def _solve_with_retries(H, g, lm: LMState, nf0, nc0, extra_ok, active, opts):
    """Propose, and on failure escalate λ and retry (optimizer.h:356-399),
    for every active instance that has not solved or given up yet.  A
    failed LM proposal takes the compounding bad step, a failed DogLeg
    proposal the fixed shrink of :func:`tr_bad_step`, GN none."""
    mcf = opts.max_consec_failures
    max_tries = mcf if mcf > 0 else 255
    if opts.solver_type == SolverType.DOGLEG:
        escalate = tr_bad_step
    elif opts.solver_type == SolverType.LEVENBERG_MARQUARDT:
        escalate = lm_failed_step
    else:
        escalate = None
    dx = torch.zeros_like(g)
    ok = torch.zeros_like(active)
    give_up = torch.zeros_like(active)
    nf, nc = nf0, nc0
    while True:
        cond = (~ok) & (~give_up) & (nc <= max_tries) & active
        if not bool(cond.any()):
            break
        dx_new, ok_new = propose_step(H, g, lm.lam, opts)
        ok_new = ok_new & extra_ok
        fail = (~ok_new).to(_I32)
        nf2, nc2 = nf + fail, nc + fail
        gu_new = (~ok_new) & (mcf > 0) & (nc2 >= mcf)
        lm2 = where_state((~ok_new) & (~gu_new),
                          escalate(lm, opts) if escalate else lm, lm)
        dx = _where(cond & ok_new, dx_new, dx)
        ok = torch.where(cond, ok_new, ok)
        lm = where_state(cond, lm2, lm)
        nf = torch.where(cond, nf2, nf)
        nc = torch.where(cond, nc2, nc)
        give_up = torch.where(cond, gu_new, give_up)
    return dx, ok, lm, nf, nc


def optimize_from_acc(
    x0: torch.Tensor,
    accumulate: Callable[[torch.Tensor], tuple],
    evaluate: Callable[[torch.Tensor], Cost],
    options: Options,
    spec: mf.TangentSpec,
):
    """Run the full loop on flat parameters ``x0`` (B, P).

    ``accumulate(x) -> (H, g, Cost)`` builds the batched normal equations
    (H (B, D, D), g (B, D)) and ``evaluate(x) -> Cost`` the cost only (the
    Rebuild(false) path of ``carry_system=True``).  ``spec``: the
    parameters' layout, whose retraction applies the steps.  Returns
    ``(x_opt, Output)`` with a leading instance axis on every field.
    """
    opts = options
    check_loop_supported(opts)
    carry_H = opts.hessian.carry_system
    if (not carry_H) and opts.hessian.save_last:
        raise ValueError(
            "hessian.carry_system=False cannot save the final Hessian; "
            "set hessian.save_last=False as well")

    B = x0.shape[0]
    d = spec.dims
    dtype, dev = x0.dtype, x0.device
    max_iters_total = opts.max_iters + 1 + (1 if opts.check_final_cost else 0)
    cap = max_iters_total if opts.save_history else 0
    if d == 0:
        return x0, skipped_output(B, cap, dtype, dev)
    # λ rides the schedule for LM (damping) and DogLeg (inverse radius)
    lam_sched = opts.solver_type in LAMBDA_SCHEDULED_TYPES
    is_dl = opts.solver_type == SolverType.DOGLEG
    mcf, mtf = opts.max_consec_failures, opts.max_total_failures
    eps = float_epsilon(dtype)
    noise = 8.0 * torch.finfo(dtype).eps

    def zeros(*shape, dt=dtype):
        return torch.zeros((B,) + shape, dtype=dt, device=dev)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    x, best_x = x0.clone(), x0.clone()
    H = zeros(d, d) if carry_H else None
    g = zeros(d)
    lm = lm_init(opts, dtype, B, dev)
    best_cost, final_rerr = full(float("inf")), full(float("inf"))
    best_num_res = zeros(dt=_I32)
    best_inliers = torch.ones((B,), dtype=torch.float32, device=dev)
    last_dx = zeros(d)
    has_last = zeros(dt=torch.bool)
    last_was_success = full(True, torch.bool)
    rebuild = full(True, torch.bool)
    it, num_failures, num_consec = zeros(dt=_I32), zeros(dt=_I32), zeros(dt=_I32)
    stop = zeros(dt=_I32)
    errs, deltas2 = zeros(cap), zeros(cap)
    succ = zeros(cap, dt=torch.bool)
    num_hist = zeros(dt=_I32)
    hist_cols = torch.arange(cap, device=dev)
    codes = {c: torch.tensor(int(c), dtype=_I32, device=dev)
             for c in StopReason}
    code = codes.__getitem__

    def build(xc):
        Hb, gb, cost = accumulate(xc)
        cost = normalize_cost(cost, opts.cost)
        if opts.grad_clipping > 0:
            gb = torch.clamp(gb, -opts.grad_clipping, opts.grad_clipping)
        return Hb, gb, cost

    while True:
        active = (stop == int(StopReason.NONE)) & (it < max_iters_total)
        if not bool(active.any()):
            break

        # --- Build or evaluate-only (lm.h:60-105) ---
        if carry_H:
            # lax.cond under vmap: both branches, then a select.  A branch
            # no active instance takes is skipped (its values are unused).
            if bool((active & rebuild).any()):
                Hn, gn, cost = build(x)
            else:
                Hn, gn, cost = H, g, None
            if bool((active & ~rebuild).any()):
                ce = normalize_cost(evaluate(x), opts.cost)
                cost = ce if cost is None else Cost(
                    *(torch.where(rebuild, a, b) for a, b in
                      zip((cost.cost, cost.num_residuals, cost.inlier_ratio),
                          (ce.cost, ce.num_residuals, ce.inlier_ratio))))
            Hc = _where(rebuild, Hn, H)
            gc = _where(rebuild, gn, g)
        else:
            Hc, gc, cost = build(x)
        err = cost.cost.to(dtype)
        n_res = cost.num_residuals

        # --- Build validity (lm.h:83-88): min |H[i,i]| check ---
        if opts.hessian.check_min_H_diag > 0:
            diag_ok = torch.all(torch.abs(torch.diagonal(Hc, dim1=-2, dim2=-1))
                                >= opts.hessian.check_min_H_diag, dim=-1)
        else:
            diag_ok = torch.ones_like(active)

        # --- Inner solve-retry loop with λ escalation ---
        dx, solved, lm_state, rs_nf, rs_nc = _solve_with_retries(
            Hc, gc, lm, num_failures, num_consec, diag_ok, active, opts)

        # --- Early failure routing (optimizer.h:364-409) ---
        err_bad = (torch.isnan(err) | torch.isinf(err)
                   | ~torch.all(torch.isfinite(gc), dim=-1))
        no_res = n_res <= 0
        stop_early = torch.where(
            solved,
            torch.where(err_bad, code(StopReason.SYSTEM_HAS_NAN_OR_INF),
                        code(StopReason.NONE)),
            torch.where(no_res, code(StopReason.SKIPPED),
                        torch.where(err_bad,
                                    code(StopReason.SYSTEM_HAS_NAN_OR_INF),
                                    code(StopReason.SOLVER_FAILED))))
        dx_norm2 = torch.sum(dx * dx, dim=-1)
        dxn_bad = torch.isnan(dx_norm2) | torch.isinf(dx_norm2)
        stop_early = torch.where((stop_early == 0) & dxn_bad,
                                 code(StopReason.SYSTEM_HAS_NAN_OR_INF),
                                 stop_early)
        early_fail = stop_early != 0

        # --- Accept / reject (optimizer.h:427-459) ---
        derr = err - best_cost
        is_good = derr < 0
        rel_derr = torch.where(
            (best_cost > eps) & torch.isfinite(best_cost),
            (best_cost - err) / best_cost, torch.zeros_like(err))
        first_eval = ~torch.isfinite(best_cost)
        good = is_good | first_eval

        if cap:
            col = (hist_cols[None, :] == it[:, None].long()) \
                & (~early_fail)[:, None]
            errs_n = torch.where(col, err[:, None], errs)
            deltas2_n = torch.where(col, dx_norm2[:, None], deltas2)
            succ_n = torch.where(col, is_good[:, None], succ)
            num_hist_n = torch.where(early_fail, num_hist, it + 1)
        else:
            errs_n, deltas2_n, succ_n, num_hist_n = errs, deltas2, succ, num_hist

        # λ schedule (lm.h:123-145); the first evaluation is auto-accepted
        # but does NOT trigger GoodStep (optimizer.h:441).  DogLeg ignores
        # the step quality (a low-quality good step must not shrink a trust
        # radius) and shrinks by a fixed factor on rejection.
        if lam_sched:
            quality = (rel_derr if opts.use_step_quality_approx and not is_dl
                       else torch.zeros_like(err))
            apply_good = (~early_fail) & good & (~first_eval)
            apply_bad = (~early_fail) & (~good)
            bad_step = tr_bad_step if is_dl else lm_bad_step
            lm_state = where_state(
                apply_good, lm_good_step(lm_state, quality, opts),
                where_state(apply_bad, bad_step(lm_state, opts), lm_state))

        accepted = (~early_fail) & good
        rejected = (~early_fail) & (~good)
        rej = rejected.to(_I32)
        num_consec_n = torch.where(accepted, torch.zeros_like(rs_nc),
                                   rs_nc + rej)
        num_failures_n = rs_nf + rej

        best_cost_n = torch.where(accepted, err, best_cost)
        best_num_res_n = torch.where(accepted, n_res.to(_I32), best_num_res)
        best_inliers_n = torch.where(accepted, cost.inlier_ratio, best_inliers)
        final_rerr_n = torch.where(accepted, rel_derr, final_rerr)

        # Failure budgets (optimizer.h:450-459) — no dx applied
        budget_stop = torch.where(
            rejected & (mcf > 0) & (num_consec_n >= mcf),
            code(StopReason.MAX_CONSEC_NO_DECR),
            torch.where(rejected & (mtf > 0) & (num_failures_n >= mtf),
                        code(StopReason.MAX_NO_DECR), code(StopReason.NONE)))
        budget_fail = (stop_early == 0) & (budget_stop != 0)

        # --- Stop-criteria cascade (optimizer.h:518-534) ---
        grad_norm2 = torch.sum(gc * gc, dim=-1)
        cascade = torch.zeros_like(stop)

        def set_if(cascade, pred, c):
            return torch.where((cascade == 0) & pred, code(c), cascade)

        if opts.min_error > 0:
            cascade = set_if(cascade, err < opts.min_error,
                             StopReason.MIN_ERROR)
        if opts.min_rerr_dec > 0:
            cascade = set_if(cascade,
                             (rel_derr > noise) & (rel_derr < opts.min_rerr_dec),
                             StopReason.MIN_REL_ERROR)
        if opts.min_step_norm2 > 0:
            cascade = set_if(cascade, dx_norm2 < opts.min_step_norm2,
                             StopReason.MIN_DELTA_NORM)
        if opts.min_grad_norm2 > 0:
            cascade = set_if(cascade, grad_norm2 < opts.min_grad_norm2,
                             StopReason.MIN_GRAD_NORM)
        stop_n = torch.where(stop_early != 0, stop_early,
                             torch.where(budget_stop != 0, budget_stop,
                                         cascade))

        # --- Apply / rollback (optimizer.h:266-299) ---
        returned_dx = (~early_fail) & (~budget_fail)
        success = accepted & returned_dx
        fail = ~success
        probe = fail & (~has_last) & returned_dx
        x_base = _where(fail & has_last, best_x, x)
        # The final iteration (and a terminal success) freezes x at the
        # point whose error was just evaluated.
        is_last = (it + 1) >= max_iters_total
        next_is_last = (it + 2) >= max_iters_total
        applied = _where((success | probe) & (cascade == 0) & ~is_last, dx,
                         torch.zeros_like(dx))
        x_n = mf.retract_flat(x_base, applied, spec)
        best_x_n = _where(success, x, best_x)
        last_dx_n = _where(success | probe, dx, last_dx)
        has_last_n = torch.where(success, torch.ones_like(has_last),
                                 torch.where(has_last,
                                             torch.zeros_like(has_last),
                                             probe))
        eval_only = torch.where(success,
                                next_is_last & opts.check_final_cost,
                                ~last_was_success)

        # Commit the new state for active instances only.
        a = active
        x = _where(a, x_n, x)
        best_x = _where(a, best_x_n, best_x)
        if carry_H:
            H = _where(a, Hc, H)
        g = _where(a, gc, g)
        lm = where_state(a, lm_state, lm)
        best_cost = torch.where(a, best_cost_n, best_cost)
        best_num_res = torch.where(a, best_num_res_n, best_num_res)
        best_inliers = torch.where(a, best_inliers_n, best_inliers)
        final_rerr = torch.where(a, final_rerr_n, final_rerr)
        last_dx = _where(a, last_dx_n, last_dx)
        has_last = torch.where(a, has_last_n, has_last)
        last_was_success = torch.where(a, success, last_was_success)
        rebuild = torch.where(a, ~eval_only, rebuild)
        it = torch.where(a, it + 1, it)
        num_failures = torch.where(a, num_failures_n, num_failures)
        num_consec = torch.where(a, num_consec_n, num_consec)
        stop = torch.where(a, stop_n, stop)
        errs = _where(a, errs_n, errs)
        deltas2 = _where(a, deltas2_n, deltas2)
        succ = _where(a, succ_n, succ)
        num_hist = torch.where(a, num_hist_n, num_hist)

    stop = torch.where(stop == int(StopReason.NONE),
                       torch.full_like(stop, int(StopReason.MAX_ITERS)), stop)
    out = Output(
        final_cost=Cost(cost=best_cost, num_residuals=best_num_res,
                        inlier_ratio=best_inliers),
        final_rerr_dec=final_rerr,
        stop_reason=stop,
        num_iters=it,
        num_failures=num_failures,
        num_consec_failures=num_consec,
        duration_ms=torch.zeros((B,), dtype=torch.float32, device=dev),
        final_grad=g,
        final_hessian=H if opts.hessian.save_last else None,
        errs=errs, deltas2=deltas2, successes=succ, num_hist=num_hist,
        final_lambda=lm.lam,
    )
    return x, out


def skipped_output(B, cap, dtype, device) -> Output:
    """The Output of a problem with nothing to optimize (optimizer.h:63-70)."""
    def z(*shape, dt=torch.int32):
        return torch.zeros((B,) + shape, dtype=dt, device=device)
    return Output(
        final_cost=Cost(cost=torch.full((B,), float("inf"), dtype=dtype,
                                        device=device),
                        num_residuals=z(),
                        inlier_ratio=torch.ones((B,), dtype=torch.float32,
                                                device=device)),
        final_rerr_dec=torch.full((B,), float("inf"), dtype=dtype,
                                  device=device),
        stop_reason=torch.full((B,), int(StopReason.SKIPPED),
                               dtype=torch.int32, device=device),
        num_iters=z(), num_failures=z(), num_consec_failures=z(),
        duration_ms=z(dt=torch.float32),
        final_grad=None, final_hessian=None,
        errs=z(cap, dt=dtype), deltas2=z(cap, dt=dtype),
        successes=z(cap, dt=torch.bool), num_hist=z(),
    )
