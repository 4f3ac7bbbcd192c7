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

The whole state is one :class:`Carry` of tensors.  A single solve is a
batch of one.  Stop-reason codes and priorities, the λ schedule with
compounded bad factors, failure budgets, the first-evaluation auto-accept,
exact rollback to the last accepted point, check_final_cost, the history,
the first-order solvers (``solvers/first_order.py``, their rejection
backoff riding the λ schedule), warm start, segment mode, stop callbacks
and the log lines are those of the JAX loop.

Log lines go to standard output from the host, one an active instance an
iteration, failure lines first, in instance order: for a batch of one they
are the JAX package's lines.  Under ``vmap`` the JAX package also prints a
line for each stopped instance (its frozen state evaluated again) and a
failure line for every instance (a ``lax.cond`` under ``vmap`` is a select
and runs the print); this loop prints neither.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost, normalize_cost
from ..ops.linalg import max_std_dev
from ..options import (FIRST_ORDER_TYPES, LAMBDA_SCHEDULED_TYPES, Options,
                       SolverType, is_stateful_fo)
from ..output import Output
from ..solvers.first_order import fo_init, fo_on_build, fo_propose
from ..solvers.lm import (LMState, lm_bad_step, lm_failed_step, lm_good_step,
                          lm_init, tr_bad_step)
from ..solvers.step import propose_step
from ..stop_reasons import StopReason
from ..utils import float_epsilon, where_instance, where_tree

_I32 = torch.int32
_NONE = int(StopReason.NONE)


@dataclasses.dataclass
class Carry:
    """The loop's complete state, every field with a leading instance axis
    (the segment state of ``checkpoint.py``)."""

    x: torch.Tensor               #: (B, P) current candidate
    fo: Any                       #: first-order state (solvers/first_order)
                                  #: or () — learns from every evaluation
    best_x: torch.Tensor          #: (B, P) last accepted point (the exact
                                  #: rollback target)
    H: Any                        #: un-damped JᵀJ in the representation
                                  #: accumulate builds: (B, D, D), a
                                  #: BlockDiag, SparseSym or LinPoint
                                  #: (sparse.py); None without
                                  #: carry_system, for first-order types
                                  #: and before the first build
    g: torch.Tensor               #: (B, D) gradient JᵀR
    lm: LMState                   #: λ and the compounding bad factor
    best_cost: torch.Tensor       #: last accepted cost (inf before)
    best_num_res: torch.Tensor    #: int32
    best_inliers: torch.Tensor    #: float32
    final_rerr: torch.Tensor      #: last relative error decrease
    last_dx: torch.Tensor         #: (B, D)
    has_last_dx: torch.Tensor     #: bool
    last_was_success: torch.Tensor  #: bool
    rebuild: torch.Tensor         #: bool: re-accumulate vs evaluate-only
    it: torch.Tensor              #: int32 == num_iters (of the segment)
    num_failures: torch.Tensor    #: int32
    num_consec: torch.Tensor      #: int32
    stop: torch.Tensor            #: int32 StopReason (NONE while running)
    errs: torch.Tensor            #: (B, cap)
    deltas2: torch.Tensor         #: (B, cap)
    succ: torch.Tensor            #: (B, cap) bool
    num_hist: torch.Tensor        #: int32


_CARRY_FIELDS = tuple(f.name for f in dataclasses.fields(Carry))
pytree.register_pytree_node(
    Carry, lambda c: ([getattr(c, k) for k in _CARRY_FIELDS], None),
    lambda values, _: Carry(*values))


def _solve_with_retries(H, g, lm: LMState, nf0, nc0, extra_ok, active, opts,
                        propose=propose_step):
    """Propose, and on failure escalate λ and retry (optimizer.h:356-399),
    for every active instance that has not solved or given up yet.  A
    failed LM proposal takes the compounding bad step, a failed DogLeg
    proposal the fixed shrink of :func:`tr_bad_step`, GN and GD none.
    ``propose(H, g, λ, opts) -> (dx, ok)`` proposes for the whole batch."""
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
        dx_new, ok_new = propose(H, g, lm.lam, opts)
        ok_new = ok_new & extra_ok
        fail = (~ok_new).to(_I32)
        nf2, nc2 = nf + fail, nc + fail
        gu_new = (~ok_new) & (mcf > 0) & (nc2 >= mcf)
        lm2 = where_tree((~ok_new) & (~gu_new),
                          escalate(lm, opts) if escalate else lm, lm)
        dx = where_instance(cond & ok_new, dx_new, dx)
        ok = torch.where(cond, ok_new, ok)
        lm = where_tree(cond, lm2, lm)
        nf = torch.where(cond, nf2, nf)
        nc = torch.where(cond, nc2, nc)
        give_up = torch.where(cond, gu_new, give_up)
    return dx, ok, lm, nf, nc


def _apply_callback(cb, *args) -> torch.Tensor:
    """The user's per-instance stop callback over the batch (bool (B,)):
    ``torch.func.vmap`` applies the one-instance function unchanged."""
    def one(*a):
        return torch.as_tensor(cb(*a))
    out = torch.func.vmap(one)(*args)
    return out.to(torch.bool).expand(args[0].shape[0])


class _LogPrinter:
    """The per-iteration log and failure lines (reference optimizer.h
    print blocks), with the JAX package's format strings
    (``tinyopt_tpu.optimizers.loop``), printed from the host."""

    def __init__(self, opts: Options, first_order: bool):
        lo = opts.log
        self.opts = opts
        fmt = ("#{it} ok:{g} " + lo.e + ":{err:.4e} n:{n} "
               "d:{derr:+.2e} r:{rel:+.1e} |dx|:{dxn:.2e} "
               "|grad|:{gn:.2e} 1/lam:{il:.2e}")
        if lo.print_x:
            fmt += " x:{x}"
        if lo.print_dx:
            fmt += " dx:{dx}"
        if lo.print_inliers:
            fmt += " in:{inl:.1%}"
        self.sigma = lo.print_max_stdev and not first_order
        if self.sigma:
            fmt += " sigma:{sd:.2e}"
        if lo.print_t:
            fmt += " τ:{tau:.2f}"
        self.fmt = fmt
        self.t0 = None

    @staticmethod
    def _rows(kw, mask):
        host = {k: np.asarray(v.detach().cpu()) for k, v in kw.items()}
        return [{k: v[b] for k, v in host.items()}
                for b in np.flatnonzero(np.asarray(mask.cpu()))]

    def failures(self, mask, it, stop, dxn2, gn2, err, dx, g):
        fmt = ("FAILURE #{it} stop:{stop} |dx|²:{d:.3e} |∇|²:{g:.3e} "
               "ε:{e:.3e} dx:{dx} grad:{gr}")
        for kv in self._rows(dict(it=it, stop=stop, d=dxn2, g=gn2, e=err,
                                  dx=dx, gr=g), mask):
            print(fmt.format(**kv), flush=True)

    def lines(self, mask, first, kw):
        kw = dict(kw, first=first)
        for kv in self._rows(kw, mask):
            now = time.perf_counter()
            if self.t0 is None or int(kv["it"]) == 0:
                self.t0 = now
            kv["tau"] = (now - self.t0) * 1e3
            line = self.fmt.format(**kv)
            if self.opts.log.print_emoji:
                emo = ("ℹ️" if bool(kv["first"])
                       else ("✅" if bool(kv["g"]) else "❌"))
                line = emo + " " + line
            print(line, flush=True)


def init_carry(x0: torch.Tensor, opts: Options, spec: mf.TangentSpec,
               warm_start=None, cap: int = 0, dense_H: bool = False) -> Carry:
    """The loop's state before the first iteration, for flat parameters
    ``x0`` (B, P), with history rows of ``cap`` slots;
    ``warm_start=(g0[, H0])`` seeds the normal equations (the reference's
    ``InitWith``, optimizer.h:46-55): the first iteration then evaluates
    the cost only.

    The carried Hessian is None until the first build makes it (the JAX
    package takes its representation from ``eval_shape``; nothing of size
    d² is allocated for a sparse or matrix-free system).  A warm start
    without H0, and ``dense_H=True`` (a template for a dense system's
    state), give zeros (B, d, d)."""
    first_order = opts.solver_type in FIRST_ORDER_TYPES
    carry_H = (not first_order) and opts.hessian.carry_system
    B, d = x0.shape[0], spec.dims
    dtype, dev = spec.dtype, x0.device

    def zeros(*shape, dt=dtype):
        return torch.zeros((B,) + shape, dtype=dt, device=dev)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    H0 = zeros(d, d) if carry_H and (dense_H or warm_start is not None) \
        else None
    g0 = zeros(d)
    if warm_start is not None:
        g0 = torch.as_tensor(warm_start[0], dtype=dtype,
                             device=dev).expand(B, d).clone()
        if carry_H and len(warm_start) > 1 and warm_start[1] is not None:
            H0 = torch.as_tensor(warm_start[1], dtype=dtype,
                                 device=dev).expand(B, d, d).clone()
    return Carry(
        x=x0.clone(), fo=fo_init(opts, x0, spec), best_x=x0.clone(), H=H0,
        g=g0, lm=lm_init(opts, dtype, B, dev),
        best_cost=full(float("inf")), best_num_res=zeros(dt=_I32),
        best_inliers=torch.ones((B,), dtype=torch.float32, device=dev),
        final_rerr=full(float("inf")), last_dx=zeros(d),
        has_last_dx=zeros(dt=torch.bool),
        last_was_success=full(True, torch.bool),
        rebuild=full(warm_start is None, torch.bool),
        it=zeros(dt=_I32), num_failures=zeros(dt=_I32),
        num_consec=zeros(dt=_I32), stop=zeros(dt=_I32),
        errs=zeros(cap), deltas2=zeros(cap), succ=zeros(cap, dt=torch.bool),
        num_hist=zeros(dt=_I32))


def optimize_from_acc(
    x0: torch.Tensor,
    accumulate: Callable[[torch.Tensor], tuple],
    evaluate: Callable[[torch.Tensor], Cost],
    options: Options,
    spec: mf.TangentSpec,
    *,
    propose: Callable = propose_step,
    warm_start: tuple | None = None,
    segment_state: Carry | None = None,
    return_state: bool = False,
):
    """Run the full loop on flat parameters ``x0`` (B, P).

    ``accumulate(x) -> (H, g, Cost)`` builds the batched normal equations
    (H (B, D, D), or None for the first-order types; g (B, D)) and
    ``evaluate(x) -> Cost`` the cost only (the Rebuild(false) path).
    H may be any pytree the ``propose(H, g, λ, opts) -> (dx, ok)``
    function understands: besides a dense tensor, a ``BlockDiag`` or a
    ``SparseSym`` (``propose_step``), or a custom representation with its
    own ``propose`` (the matrix-free ``LinPoint`` of ``sparse.py``); the
    loop selects it per instance leaf by leaf, and ``final_hessian`` holds
    it.
    ``spec``: the parameters' layout, whose retraction applies the steps.
    ``warm_start=(g0[, H0])``: see :func:`init_carry`.  Returns
    ``(x_opt, Output)`` with a leading instance axis on every field.

    Segment mode (``return_state=True``, or ``segment_state=`` to resume
    from a returned :class:`Carry`) runs exactly ``options.max_iters``
    iterations a call, applies every iteration's proposal (a segment
    boundary is not a stop) and returns ``(x, Output, Carry)``; the +1
    rollback and check_final_cost allowances are the caller's.  A resumed
    instance continues exactly where it stopped; an instance whose stop
    reason is set stays stopped.  N segments of k iterations follow the
    trajectory of one solve of N·k iterations bit for bit.
    """
    opts = options
    st = opts.solver_type
    first_order = st in FIRST_ORDER_TYPES
    fo_stateful = is_stateful_fo(opts)
    is_adamw = st == SolverType.ADAMW
    lam_sched = st in LAMBDA_SCHEDULED_TYPES
    is_dl = st == SolverType.DOGLEG
    carry_H = (not first_order) and opts.hessian.carry_system
    if (not first_order) and (not carry_H) and opts.hessian.save_last:
        raise ValueError(
            "hessian.carry_system=False cannot save the final Hessian; "
            "set hessian.save_last=False as well")
    if (not carry_H) and (not first_order) and warm_start is not None:
        raise ValueError(
            "warm_start requires hessian.carry_system=True (the seeded "
            "system lives in the loop carry)")
    if is_adamw and opts.adam.weight_decay > 0 and spec.has_manifold:
        raise ValueError(
            "AdamW weight decay requires pure-Euclidean parameters "
            "(decay toward the origin is undefined on a manifold); "
            "use SolverType.ADAM or weight_decay=0")

    segmented = return_state or (segment_state is not None)
    max_iters_total = opts.max_iters if segmented else (
        opts.max_iters + 1 + (1 if opts.check_final_cost else 0))
    cap = max_iters_total if opts.save_history else 0
    B = x0.shape[0]
    d = spec.dims
    dtype, dev = x0.dtype, x0.device
    if d == 0:
        out = skipped_output(B, cap, dtype, dev)
        return (x0, out, None) if return_state else (x0, out)
    mcf, mtf = opts.max_consec_failures, opts.max_total_failures
    eps = float_epsilon(dtype)
    noise = 8.0 * torch.finfo(dtype).eps
    codes = {c: torch.tensor(int(c), dtype=_I32, device=dev)
             for c in StopReason}
    code = codes.__getitem__
    hist_cols = torch.arange(cap, device=dev)
    log = (_LogPrinter(opts, first_order)
           if opts.log.enable or opts.log.print_failure else None)

    def zeros(*shape, dt=dtype):
        return torch.zeros((B,) + shape, dtype=dt, device=dev)

    if segment_state is not None:
        # segment-local fields restart; solver and acceptance state carry
        c = dataclasses.replace(
            segment_state, it=zeros(dt=_I32), errs=zeros(cap),
            deltas2=zeros(cap), succ=zeros(cap, dt=torch.bool),
            num_hist=zeros(dt=_I32))
    else:
        c = init_carry(x0, opts, spec, warm_start, cap)

    def build(xc):
        Hb, gb, cost = accumulate(xc)
        cost = normalize_cost(cost, opts.cost)
        if opts.grad_clipping > 0:
            gb = torch.clamp(gb, -opts.grad_clipping, opts.grad_clipping)
        return (None if first_order else Hb), gb, cost

    def body(c: Carry, active) -> Carry:
        it = c.it
        # --- Build or evaluate-only (lm.h:60-105) ---
        if carry_H or first_order:
            # lax.cond under vmap: both branches, then a select.  A branch
            # no active instance takes is skipped (its values are unused).
            if bool((active & c.rebuild).any()):
                Hn, gn, cost = build(c.x)
            else:
                Hn, gn, cost = c.H, c.g, None
            if bool((active & ~c.rebuild).any()):
                ce = normalize_cost(evaluate(c.x), opts.cost)
                cost = ce if cost is None else Cost(
                    *(torch.where(c.rebuild, a, b) for a, b in
                      zip((cost.cost, cost.num_residuals, cost.inlier_ratio),
                          (ce.cost, ce.num_residuals, ce.inlier_ratio))))
            Hc = (Hn if first_order or c.H is None
                  else where_tree(c.rebuild, Hn, c.H))
            gc = where_instance(c.rebuild, gn, c.g)
        else:
            Hc, gc, cost = build(c.x)
        err = cost.cost.to(dtype)
        n_res = cost.num_residuals

        # --- Build validity (lm.h:83-88): min |H[i,i]| check ---
        if (not first_order) and opts.hessian.check_min_H_diag > 0:
            if isinstance(Hc, torch.Tensor):
                diag = torch.diagonal(Hc, dim1=-2, dim2=-1)
            elif hasattr(Hc, "diagonal"):
                diag = Hc.diagonal()
            else:
                # a SchurSystem or LinPoint: jnp.diagonal raises TypeError
                # on it in the JAX loop as well
                raise TypeError(
                    "hessian.check_min_H_diag needs the Hessian's diagonal; "
                    f"a {type(Hc).__name__} has none")
            diag_ok = torch.all(torch.abs(diag)
                                >= opts.hessian.check_min_H_diag, dim=-1)
        else:
            diag_ok = torch.ones_like(active)

        # --- Proposal: stateful first-order, or the solve-retry loop ---
        if fo_stateful:
            # secant / BB bookkeeping only where this iteration rebuilt;
            # the proposed state is committed on every evaluation
            fo_b = where_tree(c.rebuild,
                               fo_on_build(opts, c.fo, gc, c.x, spec), c.fo)
            dx, fo_new = fo_propose(opts, fo_b, gc, c.lm,
                                    c.x if is_adamw else None)
            solved = torch.ones_like(active)
            lm_state, rs_nf, rs_nc = c.lm, c.num_failures, c.num_consec
        else:
            fo_new = c.fo
            dx, solved, lm_state, rs_nf, rs_nc = _solve_with_retries(
                Hc, gc, c.lm, c.num_failures, c.num_consec, diag_ok, active,
                opts, propose)

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
        derr = err - c.best_cost
        is_good = derr < 0
        rel_derr = torch.where(
            (c.best_cost > eps) & torch.isfinite(c.best_cost),
            (c.best_cost - err) / c.best_cost, torch.zeros_like(err))
        # keyed on "no finite best cost yet", not the iteration index, so a
        # resumed segment does not re-trigger it
        first_eval = ~torch.isfinite(c.best_cost)
        good = is_good | first_eval

        if cap:
            col = (hist_cols[None, :] == it[:, None].long()) \
                & (~early_fail)[:, None]
            errs = torch.where(col, err[:, None], c.errs)
            deltas2 = torch.where(col, dx_norm2[:, None], c.deltas2)
            succ = torch.where(col, is_good[:, None], c.succ)
            num_hist = torch.where(early_fail, c.num_hist, it + 1)
        else:
            errs, deltas2, succ, num_hist = c.errs, c.deltas2, c.succ, \
                c.num_hist

        # λ schedule (lm.h:123-145); the first evaluation is auto-accepted
        # but does NOT trigger GoodStep (optimizer.h:441).  DogLeg ignores
        # the step quality and shrinks by a fixed factor on rejection; the
        # stateful first-order types ride the schedule for their backoff.
        if lam_sched or fo_stateful:
            quality = (rel_derr if opts.use_step_quality_approx and not is_dl
                       else torch.zeros_like(err))
            apply_good = (~early_fail) & good & (~first_eval)
            apply_bad = (~early_fail) & (~good)
            bad_step = tr_bad_step if is_dl else lm_bad_step
            lm_state = where_tree(
                apply_good, lm_good_step(lm_state, quality, opts),
                where_tree(apply_bad, bad_step(lm_state, opts), lm_state))

        accepted = (~early_fail) & good
        rejected = (~early_fail) & (~good)
        rej = rejected.to(_I32)
        num_consec = torch.where(accepted, torch.zeros_like(rs_nc),
                                 rs_nc + rej)
        num_failures = rs_nf + rej

        best_cost = torch.where(accepted, err, c.best_cost)
        best_num_res = torch.where(accepted, n_res.to(_I32), c.best_num_res)
        best_inliers = torch.where(accepted, cost.inlier_ratio,
                                   c.best_inliers)
        final_rerr = torch.where(accepted, rel_derr, c.final_rerr)

        # Failure budgets (optimizer.h:450-459) — no dx applied
        budget_stop = torch.where(
            rejected & (mcf > 0) & (num_consec >= mcf),
            code(StopReason.MAX_CONSEC_NO_DECR),
            torch.where(rejected & (mtf > 0) & (num_failures >= mtf),
                        code(StopReason.MAX_NO_DECR), code(StopReason.NONE)))
        budget_fail = (stop_early == 0) & (budget_stop != 0)

        # --- Stop-criteria cascade (optimizer.h:518-534) ---
        grad_norm2 = torch.sum(gc * gc, dim=-1)
        cascade = torch.zeros_like(c.stop)

        def set_if(cascade, pred, reason):
            return torch.where((cascade == 0) & pred, code(reason), cascade)

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
        if opts.stop_callback is not None:
            cascade = set_if(cascade, _apply_callback(
                opts.stop_callback, err, dx_norm2, grad_norm2),
                StopReason.USER_STOPPED)
        if opts.stop_callback2 is not None:
            cascade = set_if(cascade, _apply_callback(
                opts.stop_callback2, err, dx, gc), StopReason.USER_STOPPED)
        stop = torch.where(stop_early != 0, stop_early,
                           torch.where(budget_stop != 0, budget_stop, cascade))

        # --- Apply / rollback (optimizer.h:266-299) ---
        returned_dx = (~early_fail) & (~budget_fail)
        success = accepted & returned_dx
        fail = ~success
        probe = fail & (~c.has_last_dx) & returned_dx
        x_base = where_instance(fail & c.has_last_dx, c.best_x, c.x)
        # The final iteration (and a terminal success) freezes x at the
        # point whose error was just evaluated; a segment boundary is not
        # a stop, so segment mode applies every proposal.
        if segmented:
            gate = torch.zeros_like(active)
        else:
            gate = (it + 1) >= max_iters_total
        next_is_last = (it + 2) >= max_iters_total
        applied = where_instance((success | probe) & (cascade == 0) & ~gate, dx,
                         torch.zeros_like(dx))
        x_new = mf.retract_flat(x_base, applied, spec)
        eval_only = torch.where(success,
                                next_is_last & opts.check_final_cost,
                                ~c.last_was_success)

        if log is not None:
            if opts.log.print_failure:
                log.failures(active & early_fail, it, stop_early, dx_norm2,
                             grad_norm2, err, dx, gc)
            if opts.log.enable:
                kw = dict(it=it, g=good, err=err, n=n_res,
                          derr=torch.where(first_eval,
                                           torch.zeros_like(derr), derr),
                          rel=rel_derr, dxn=torch.sqrt(dx_norm2),
                          gn=torch.sqrt(grad_norm2),
                          il=1.0 / torch.clamp(lm_state.lam, min=1e-30),
                          x=x_new, dx=dx, inl=cost.inlier_ratio)
                if log.sigma and isinstance(Hc, torch.Tensor):
                    kw["sd"] = max_std_dev(Hc)
                log.lines(active, first_eval, kw)

        return Carry(
            x=x_new, fo=fo_new, best_x=where_instance(success, c.x, c.best_x),
            H=Hc if carry_H else None, g=gc, lm=lm_state,
            best_cost=best_cost, best_num_res=best_num_res,
            best_inliers=best_inliers, final_rerr=final_rerr,
            last_dx=where_instance(success | probe, dx, c.last_dx),
            has_last_dx=torch.where(
                success, torch.ones_like(c.has_last_dx),
                torch.where(c.has_last_dx, torch.zeros_like(c.has_last_dx),
                            probe)),
            last_was_success=success, rebuild=~eval_only, it=it + 1,
            num_failures=num_failures, num_consec=num_consec, stop=stop,
            errs=errs, deltas2=deltas2, succ=succ, num_hist=num_hist)

    while True:
        active = (c.stop == _NONE) & (c.it < max_iters_total)
        if not bool(active.any()):
            break
        new = body(c, active)
        if c.H is None and new.H is not None:
            c.H = pytree.tree_map(torch.zeros_like, new.H)
        # commit the new state for active instances only
        c = where_tree(active, new, c)

    stop = torch.where(c.stop == _NONE,
                       torch.full_like(c.stop, int(StopReason.MAX_ITERS)),
                       c.stop)
    out = Output(
        final_cost=Cost(cost=c.best_cost, num_residuals=c.best_num_res,
                        inlier_ratio=c.best_inliers),
        final_rerr_dec=c.final_rerr,
        stop_reason=stop,
        num_iters=c.it,
        num_failures=c.num_failures,
        num_consec_failures=c.num_consec,
        duration_ms=torch.zeros((B,), dtype=torch.float32, device=dev),
        final_grad=c.g,
        final_hessian=(c.H if (not first_order) and opts.hessian.save_last
                       else None),
        errs=c.errs, deltas2=c.deltas2, successes=c.succ,
        num_hist=c.num_hist, final_lambda=c.lm.lam,
    )
    if return_state:
        return c.x, out, c
    return c.x, out


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
