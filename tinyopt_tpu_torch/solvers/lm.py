"""Levenberg-Marquardt damping schedule as pure state transitions.

Counterpart of ``tinyopt_tpu.solvers.lm`` (reference: include/tinyopt/
solvers/lm.h:123-154), on per-instance (B,) tensors: a good step scales λ
by good_factor (or the quality rule) and reverts compounded bad factors; a
bad or failed step scales λ by the current bad factor, which then
compounds; λ is clamped to ``damping_range``.  DogLeg reads λ as the
inverse trust radius and shrinks it on rejection by the fixed factor of
:func:`tr_bad_step`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LMState(NamedTuple):
    lam: torch.Tensor          #: damping factor λ, (B,)
    bad_factor: torch.Tensor   #: current compounding bad-step scale, (B,)


def lm_init(opts, dtype, batch: int, device) -> LMState:
    return LMState(
        lam=torch.full((batch,), opts.lm.damping_init, dtype=dtype,
                       device=device),
        bad_factor=torch.full((batch,), opts.lm.bad_factor, dtype=dtype,
                              device=device))


def _clamp(lam, opts):
    lo, hi = opts.lm.damping_range
    return torch.clamp(lam, lo, hi)


def lm_good_step(state: LMState, quality: torch.Tensor, opts) -> LMState:
    dtype = state.lam.dtype
    gf = torch.tensor(opts.lm.good_factor, dtype=dtype,
                      device=state.lam.device)
    s = torch.where(quality != 0,
                    torch.maximum(gf, 1.0 - (2.0 * quality - 1.0) ** 3), gf)
    base_bad = torch.tensor(opts.lm.bad_factor, dtype=dtype,
                            device=state.lam.device)
    s = torch.where(state.bad_factor != base_bad, s / state.bad_factor, s)
    return LMState(lam=_clamp(state.lam * s, opts),
                   bad_factor=torch.full_like(state.bad_factor,
                                              opts.lm.bad_factor))


def lm_bad_step(state: LMState, opts) -> LMState:
    return LMState(lam=_clamp(state.lam * state.bad_factor, opts),
                   bad_factor=state.bad_factor * opts.lm.bad_factor)


def lm_failed_step(state: LMState, opts) -> LMState:
    return lm_bad_step(state, opts)


def tr_bad_step(state: LMState, opts) -> LMState:
    """DogLeg rejection or failed proposal: λ·bad_factor, a fixed shrink of
    the trust radius with NO compounding (a compounding factor collapses
    the radius through rejection / rollback pairs; Nocedal & Wright
    alg. 4.1 shrinks by a fixed factor)."""
    return LMState(lam=_clamp(state.lam * opts.lm.bad_factor, opts),
                   bad_factor=state.bad_factor)

