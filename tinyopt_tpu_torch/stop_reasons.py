"""Stop reasons for the optimization loop.

Behavioral spec mirrored from the reference library's ``StopReason`` enum
(reference: include/tinyopt/stop_reasons.h:14-43): negative codes are
failures, zero/positive codes are successes; ``Converged`` is true for codes
in [kMinError, kMaxIters).

The codes are plain ints so they can live in int32 tensors (one per batch
instance) and in the CUDA kernels' state.  The codes and descriptions are
those of ``tinyopt_tpu.stop_reasons``.
"""

from __future__ import annotations

import enum


class StopReason(enum.IntEnum):
    """Why the optimization terminated (negative = failure)."""

    # Failures (negative)
    OUT_OF_MEMORY = -4        #: Out of memory allocating the system (Hessians)
    SOLVER_FAILED = -3        #: Failed to solve the normal equations (H not invertible)
    SYSTEM_HAS_NAN_OR_INF = -2  #: Residuals or Jacobians have NaNs or Inf
    SKIPPED = -1              #: No residuals / nothing to optimize

    # Successes (>= 0)
    NONE = 0                  #: No stop (used by Step() or when no iterations ran)
    MIN_ERROR = 1             #: Minimal error reached
    MIN_REL_ERROR = 2         #: Minimal relative error decrease reached
    MIN_DELTA_NORM = 3        #: Minimal step norm reached
    MIN_GRAD_NORM = 4         #: Minimal gradient norm reached
    MAX_ITERS = 5             #: Maximum number of iterations reached
    MAX_NO_DECR = 6           #: Failed to decrease error too many times (total)
    MAX_CONSEC_NO_DECR = 7    #: Failed to decrease error too many times in a row
    TIMED_OUT = 8             #: Total allocated time reached
    USER_STOPPED = 9          #: User stop callback fired


# Aliases matching the reference spelling (stop_reasons.h) for familiarity.
kOutOfMemory = StopReason.OUT_OF_MEMORY
kSolverFailed = StopReason.SOLVER_FAILED
kSystemHasNaNOrInf = StopReason.SYSTEM_HAS_NAN_OR_INF
kSkipped = StopReason.SKIPPED
kNone = StopReason.NONE
kMinError = StopReason.MIN_ERROR
kMinRelError = StopReason.MIN_REL_ERROR
kMinDeltaNorm = StopReason.MIN_DELTA_NORM
kMinGradNorm = StopReason.MIN_GRAD_NORM
kMaxIters = StopReason.MAX_ITERS
kMaxNoDecr = StopReason.MAX_NO_DECR
kMaxConsecNoDecr = StopReason.MAX_CONSEC_NO_DECR
kTimedOut = StopReason.TIMED_OUT
kUserStopped = StopReason.USER_STOPPED


_DESCRIPTIONS = {
    StopReason.NONE: "🌱 Optimization not ran or used with Step() (success)",
    StopReason.MIN_ERROR: "🌞 Reached minimum error (success)",
    StopReason.MIN_REL_ERROR: "🌞 Reached minimum relative error (success)",
    StopReason.MIN_DELTA_NORM: "🌞 Reached minimal delta norm (success)",
    StopReason.MIN_GRAD_NORM: "🌞 Reached minimal gradient (success)",
    StopReason.MAX_ITERS: "⛅ Reached maximum number of iterations (success)",
    StopReason.MAX_NO_DECR: "⛅ Failed to decrease error too many times (success)",
    StopReason.MAX_CONSEC_NO_DECR:
        "⛅ Failed to decrease error consecutively too many times (success)",
    StopReason.TIMED_OUT: "⌛ Reached maximum allocated time (success)",
    StopReason.USER_STOPPED: "👍 User stopped the process (success)",
    StopReason.OUT_OF_MEMORY:
        "❌ Out of memory when allocating the Hessian(s), use block-sparse? (failure)",
    StopReason.SYSTEM_HAS_NAN_OR_INF:
        "❌ Residuals or Jacobians have NaNs or Inf (failure)",
    StopReason.SOLVER_FAILED: "❌ Failed to solve the normal equations (failure)",
    StopReason.SKIPPED:
        "❌ The system has no residuals or nothing to optimize (failure)",
}


def stop_reason_description(reason, options=None, final_cost=None) -> str:
    """Human-readable description of a stop reason.

    Mirrors ``StopReasonDescription`` (reference: stop_reasons.h:46-134),
    optionally appending the threshold from ``options`` that triggered it.
    """
    try:
        reason = StopReason(int(reason))
    except ValueError:
        return f"⛈️ Unknown reason: {int(reason)}"
    msg = _DESCRIPTIONS[reason]
    if options is not None:
        import math

        if reason == StopReason.MIN_ERROR and final_cost is not None:
            msg += f" ε:[{float(final_cost)} < {options.min_error}]"
        elif reason == StopReason.MIN_REL_ERROR:
            msg += f" [rel dε < {options.min_rerr_dec}]"
        elif reason == StopReason.MIN_DELTA_NORM:
            msg += f" [|δX| < {math.sqrt(options.min_step_norm2)}]"
        elif reason == StopReason.MIN_GRAD_NORM:
            msg += f" [|∇| < {math.sqrt(options.min_grad_norm2)}]"
        elif reason == StopReason.MAX_ITERS:
            msg += f" [#it == {options.max_iters}]"
        elif reason == StopReason.MAX_NO_DECR:
            msg += f" [={options.max_total_failures}]"
        elif reason == StopReason.MAX_CONSEC_NO_DECR:
            msg += f" [={options.max_consec_failures}]"
        elif reason == StopReason.TIMED_OUT:
            msg += f" [> {options.max_duration_ms}ms]"
    return msg
