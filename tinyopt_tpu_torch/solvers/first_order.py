"""Stateful first-order step proposers, batched: GD (fixed and
Barzilai–Borwein), SGD-momentum, Adam / AdamW, L-BFGS.

Counterpart of ``tinyopt_tpu.solvers.first_order`` for a leading instance
axis: every state field carries one row an instance — (B, d) buffers,
(B, m, d) L-BFGS ring buffers, (B,) heads, counts, steps and rates — and
the previous build point is the flat (B, P) parameter vector.  The
contract with the loop is the JAX package's:

* ``fo_init(opts, x0, spec)`` -> the state (a NamedTuple of tensors, or
  ``()`` for fixed-rate GD);
* ``fo_on_build(opts, state, g, x, spec)`` -> the state with the secant
  pair between the previous and the current BUILD point pushed (L-BFGS)
  or the BB rate updated; the loop applies it only to the instances that
  rebuilt;
* ``fo_propose(opts, state, g, lm_state, x_flat)`` -> ``(dx, state')``;
  the loop commits ``state'`` on every evaluation, rejected ones included
  (the parameters move only on accepted steps).

Every stateful proposal is scaled by ``lr · bad_factor₀ / bad_factor``,
the λ schedule's compounding rejection factor (``solvers/lm.py``): the
loop's accept / reject cycle then backtracks lr, lr/2, lr/4, … and
recovers at once on acceptance.  Constants are 0-d tensors of the
parameters' type, so ``1 − β`` and ``β^t`` round as the JAX package's
typed scalars do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import manifold as mf
from ..options import Options, SolverType

_I32 = torch.int32


class SGDState(NamedTuple):
    v: torch.Tensor            #: (B, d) momentum buffer


class AdamState(NamedTuple):
    m: torch.Tensor            #: (B, d) first-moment estimate
    v: torch.Tensor            #: (B, d) second-moment estimate
    t: torch.Tensor            #: (B,) int32 proposal count (bias
                               #: correction); advances on every
                               #: evaluation, rejected ones included


class BBState(NamedTuple):
    """Barzilai–Borwein adaptive-rate state (GDOptions.adaptive="bb")."""

    lr: torch.Tensor           #: (B,) current step size
    g_prev: torch.Tensor       #: (B, d) gradient at the last BUILD point
    x_prev: torch.Tensor       #: (B, P) parameters of the last BUILD point
    have_prev: torch.Tensor    #: (B,) int32: (x_prev, g_prev) hold a build


class LBFGSState(NamedTuple):
    S: torch.Tensor            #: (B, m, d) step ring buffer
    Y: torch.Tensor            #: (B, m, d) gradient-difference ring buffer
    rho: torch.Tensor          #: (B, m) 1 / (sᵀy); 0 marks an empty slot
    head: torch.Tensor         #: (B,) int32 next write slot
    count: torch.Tensor        #: (B,) int32 pairs stored (≤ m)
    g_prev: torch.Tensor       #: (B, d) gradient at the last BUILD point
    x_prev: torch.Tensor       #: (B, P) parameters of the last BUILD point
    have_prev: torch.Tensor    #: (B,) int32: (x_prev, g_prev) hold a build
                               #: (0 until the first rebuild: a warm start
                               #: skips iteration 0's build, so the zeros
                               #: init must never form a secant pair)


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s type and device."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _col(v):
    return v[..., None]


def fo_init(opts: Options, x0: torch.Tensor, spec: mf.TangentSpec):
    """The initial state for flat parameters ``x0`` (B, P)."""
    st = opts.solver_type
    B, d, dt, dev = x0.shape[0], spec.dims, spec.dtype, x0.device

    def z(*shape, dtype=dt):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    if st == SolverType.GRADIENT_DESCENT and opts.gd.adaptive != "off":
        if opts.gd.adaptive != "bb":
            raise ValueError(
                f"unknown gd.adaptive={opts.gd.adaptive!r}; "
                "expected 'off' or 'bb'")
        return BBState(lr=torch.full((B,), opts.gd.lr, dtype=dt, device=dev),
                       g_prev=z(d), x_prev=x0.clone(), have_prev=z(dtype=_I32))
    if st == SolverType.SGD:
        return SGDState(v=z(d))
    if st in (SolverType.ADAM, SolverType.ADAMW):
        return AdamState(m=z(d), v=z(d), t=z(dtype=_I32))
    if st == SolverType.LBFGS:
        m = opts.lbfgs.memory
        return LBFGSState(S=z(m, d), Y=z(m, d), rho=z(m), head=z(dtype=_I32),
                          count=z(dtype=_I32), g_prev=z(d), x_prev=x0.clone(),
                          have_prev=z(dtype=_I32))
    return ()


def fo_on_build(opts: Options, state, g: torch.Tensor, x: torch.Tensor,
                spec: mf.TangentSpec):
    """Push the secant pair between the previous and current build points
    (s = x ⊟ x_prev, y = g − g_prev) and advance (x_prev, g_prev); the BB
    rate sᵀy / yᵀy; identity for the other methods.  A pair is dropped
    (slot untouched) when sᵀy ≤ 1e-10·sᵀs (no movement, or the curvature
    condition fails)."""
    if isinstance(state, BBState):
        s = mf.local_flat(state.x_prev, x, spec)
        y = g - state.g_prev
        sy = _dot(s, y)
        yy = _dot(y, y)
        lr_bb = sy / torch.where(yy > 0, yy, torch.ones_like(yy))
        ok = ((state.have_prev != 0) & (sy > 0) & (yy > 0)
              & torch.isfinite(lr_bb))
        return BBState(lr=torch.where(ok, lr_bb, state.lr), g_prev=g,
                       x_prev=x, have_prev=torch.ones_like(state.have_prev))
    if opts.solver_type != SolverType.LBFGS:
        return state
    s = mf.local_flat(state.x_prev, x, spec)
    y = g - state.g_prev
    sy = _dot(s, y)
    do = (state.have_prev != 0) & (sy > _c(1e-10, g) * _dot(s, s))
    rows = torch.arange(g.shape[0], device=g.device)
    idx = state.head.long()
    S, Y, rho = state.S.clone(), state.Y.clone(), state.rho.clone()
    S[rows, idx] = torch.where(_col(do), s, state.S[rows, idx])
    Y[rows, idx] = torch.where(_col(do), y, state.Y[rows, idx])
    rho[rows, idx] = torch.where(
        do, 1.0 / torch.where(do, sy, torch.ones_like(sy)),
        state.rho[rows, idx])
    m = state.rho.shape[-1]
    head = torch.where(do, (state.head + 1) % m, state.head)
    count = torch.where(do, torch.clamp(state.count + 1, max=m), state.count)
    return LBFGSState(S=S, Y=Y, rho=rho, head=head, count=count, g_prev=g,
                      x_prev=x, have_prev=torch.ones_like(state.have_prev))


def _lbfgs_direction(state: LBFGSState, g: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion r ≈ H⁻¹g from the stored pairs (Nocedal &
    Wright, Alg. 7.4) over each instance's ring buffer, slot
    ``(head − 1 − k) % m`` newest first; ρ = 0 masks an empty slot, so
    every instance runs the same m steps."""
    m = state.rho.shape[-1]
    rows = torch.arange(g.shape[0], device=g.device)
    head, count = state.head.long(), state.count.long()
    q = g
    alphas = torch.zeros_like(state.rho)
    for k in range(m):
        i = (head - 1 - k) % m
        a = state.rho[rows, i] * _dot(state.S[rows, i], q)
        q = q - _col(a) * state.Y[rows, i]
        alphas[rows, i] = a
    # initial Hessian scaling γ = sᵀy / yᵀy of the newest valid pair
    newest = (head - 1) % m
    y_new = state.Y[rows, newest]
    yy = _dot(y_new, y_new)
    rho_new = state.rho[rows, newest]
    sy_newest = torch.where(
        rho_new != 0,
        1.0 / torch.where(rho_new != 0, rho_new, torch.ones_like(rho_new)),
        torch.zeros_like(rho_new))
    gamma = torch.where((state.count > 0) & (yy > 0),
                        sy_newest / torch.where(yy > 0, yy,
                                                torch.ones_like(yy)),
                        torch.ones_like(yy))
    r = _col(gamma) * q
    for k in range(m):
        i = (head - count + k) % m
        b = state.rho[rows, i] * _dot(state.Y[rows, i], r)
        r = r + _col(alphas[rows, i] - b) * state.S[rows, i]
    return r


def fo_propose(opts: Options, state, g: torch.Tensor, lm_state,
               x_flat: torch.Tensor | None = None):
    """One proposal for every instance: ``(dx, state')``.  ``x_flat``
    (B, P) is needed only by AdamW's decoupled weight decay."""
    st = opts.solver_type
    if st == SolverType.GRADIENT_DESCENT:
        if isinstance(state, BBState):
            backoff = opts.lm.bad_factor / lm_state.bad_factor
            return _col(-state.lr * backoff) * g, state
        return -opts.gd.lr * g, state

    # the rejection backoff shared by every stateful method (lr, lr/2, …)
    backoff = opts.lm.bad_factor / lm_state.bad_factor

    if st == SolverType.SGD:
        mu = _c(opts.sgd.momentum, g)
        v = mu * state.v + g
        step_g = g + mu * v if opts.sgd.nesterov else v
        return _col(-_c(opts.sgd.lr, g) * backoff) * step_g, SGDState(v=v)

    if st in (SolverType.ADAM, SolverType.ADAMW):
        o = opts.adam
        b1, b2 = _c(o.beta1, g), _c(o.beta2, g)
        t = state.t + 1
        m = b1 * state.m + (1 - b1) * g
        v = b2 * state.v + (1 - b2) * g * g
        tf = _col(t.to(g.dtype))
        mhat = m / (1 - b1 ** tf)
        vhat = v / (1 - b2 ** tf)
        upd = mhat / (torch.sqrt(vhat) + _c(o.eps, g))
        if st == SolverType.ADAMW and o.weight_decay > 0:
            # decoupled decay inside the backoff, as the JAX package (its
            # fo_propose explains why the whole proposal is scaled)
            upd = upd + _c(o.weight_decay, g) * x_flat
        return (_col(-_c(o.lr, g) * backoff) * upd,
                AdamState(m=m, v=v, t=t))

    if st == SolverType.LBFGS:
        r = _lbfgs_direction(state, g)
        return _col(-_c(opts.lbfgs.lr, g) * backoff) * r, state

    raise ValueError(f"not a first-order solver type: {st}")
