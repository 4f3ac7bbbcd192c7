"""Optimization options.

Frozen (hashable) dataclasses with exactly the fields and defaults of
``tinyopt_tpu.options`` (which mirror the reference ``tinyopt::Options``,
include/tinyopt/optimizers/options.h:18-156), without importing JAX.
``tinyopt_tpu_torch.interop.options_from_reference`` copies a JAX-package
``Options`` into this one field by field.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional


class SolverType(enum.Enum):
    """Which solver drives the step proposal (options.h:24-30)."""

    LEVENBERG_MARQUARDT = 0
    GAUSS_NEWTON = 1
    GRADIENT_DESCENT = 2
    SGD = 3                  #: gradient descent + (Nesterov) momentum
    ADAM = 4                 #: Adam (Kingma & Ba 2015)
    ADAMW = 5                #: Adam with decoupled weight decay
    LBFGS = 6                #: limited-memory BFGS (two-loop recursion)
    DOGLEG = 7               #: Powell dogleg trust region (λ = inverse radius)


# Short aliases
LevenbergMarquardt = SolverType.LEVENBERG_MARQUARDT
GaussNewton = SolverType.GAUSS_NEWTON
GradientDescent = SolverType.GRADIENT_DESCENT
SGD = SolverType.SGD
Adam = SolverType.ADAM
AdamW = SolverType.ADAMW
LBFGS = SolverType.LBFGS
DogLeg = SolverType.DOGLEG

#: Solver types that never build a Hessian (gradient-only loop).
FIRST_ORDER_TYPES = frozenset({
    SolverType.GRADIENT_DESCENT, SolverType.SGD, SolverType.ADAM,
    SolverType.ADAMW, SolverType.LBFGS})

#: First-order types with per-solve optimizer state in the loop.
STATEFUL_FO_TYPES = frozenset({
    SolverType.SGD, SolverType.ADAM, SolverType.ADAMW, SolverType.LBFGS})


def is_stateful_fo(options: "Options") -> bool:
    """Whether the loop carries first-order optimizer state for these
    options (momentum, moments, curvature pairs, or GD's adaptive rate)."""
    return (options.solver_type in STATEFUL_FO_TYPES
            or (options.solver_type == SolverType.GRADIENT_DESCENT
                and options.gd.adaptive != "off"))


#: Solver types whose λ rides the schedule of lm.h:123-154: the damping of
#: LM, the inverse trust radius of DogLeg.
LAMBDA_SCHEDULED_TYPES = frozenset({
    SolverType.LEVENBERG_MARQUARDT, SolverType.DOGLEG})


@dataclasses.dataclass(frozen=True)
class HessianOptions:
    """Hessian handling options (options.h:58-67)."""

    #: Cholesky with PSD-failure detection; False = unchecked solve.
    use_ldlt: bool = True
    #: Reject the build when any |H[i,i]| is below this threshold (0 = off).
    check_min_H_diag: float = 0.0
    #: Whether manual acc functions fill the FULL Hessian (acc mode only).
    H_is_full: bool = True
    #: Save the last (un-damped) Hessian into the Output.
    save_last: bool = True
    #: Normal-equation solver: "cholesky", "cg" (batched Jacobi-PCG, the
    #: K1 kernel on a CUDA device) or "fused" (CG semantics; batched
    #: solves inside the kernel's envelope run the whole loop in the K2
    #: kernel, ops/cuda_solver.py).
    solver: str = "cholesky"
    #: CG iteration count (0 = tangent dimension).
    cg_iters: int = 0
    #: Carry (H, g) across iterations so rejected steps re-damp the last
    #: built system (lm.h:96-105); False re-accumulates at the current
    #: point instead.  False requires save_last=False.
    carry_system: bool = True
    #: Column coloring for the matrix-free diag(JᵀJ) of the fused path:
    #: "auto" probes the example instance's Jacobian structure, "off"
    #: always uses one jvp sweep per tangent dimension.
    diag_coloring: str = "auto"
    #: Instances per grid tile of the JAX package's fused kernel.  Unused
    #: by this package: K2's geometry comes from the shapes alone
    #: (ops/cuda_solver.k2_launch_plan).
    fused_block: int = 0
    #: Schur-family options (not ported yet; kept for field parity).
    schur_refine: int = 0
    schur_cg_iters: int = 0
    schur_banded: str = "auto"
    schur_sort: str = "auto"


@dataclasses.dataclass(frozen=True)
class CostScalingOptions:
    """Cost scaling options (options.h:75-80)."""

    use_squared_norm: bool = True  #: cost = ||r||^2 (faster); else ||r||
    downscale_by_2: bool = False   #: cost *= 0.5
    normalize: bool = False        #: cost /= num_residuals


@dataclasses.dataclass(frozen=True)
class LMOptions:
    """Levenberg-Marquardt damping schedule (options.h:128-141)."""

    damping_init: float = 1e-4     #: Initial λ (0 disables damping ≈ GN)
    damping_range: tuple = (1e-9, 1e9)  #: λ clamp range
    good_factor: float = 1.0 / 3.0  #: λ scale on accepted steps
    bad_factor: float = 2.0         #: λ scale on rejected steps (compounds)


@dataclasses.dataclass(frozen=True)
class GDOptions:
    """Gradient descent options (options.h:147-154)."""

    lr: float = 1e-3          #: Fixed (or initial, for adaptive) rate
    adaptive: str = "off"     #: "off" | "bb" (Barzilai–Borwein)


@dataclasses.dataclass(frozen=True)
class SGDOptions:
    """SGD-with-momentum options."""

    lr: float = 1e-3
    momentum: float = 0.9
    nesterov: bool = False


@dataclasses.dataclass(frozen=True)
class AdamOptions:
    """Adam / AdamW options."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2


@dataclasses.dataclass(frozen=True)
class LBFGSOptions:
    """Limited-memory BFGS options."""

    memory: int = 8
    lr: float = 1.0


@dataclasses.dataclass(frozen=True)
class LogOptions:
    """Iteration logging options (options.h:113-125)."""

    enable: bool = False
    e: str = "ε²"
    print_emoji: bool = False
    print_x: bool = False
    print_dx: bool = False
    print_inliers: bool = False
    print_t: bool = False
    print_J_jet: bool = False
    print_max_stdev: bool = False
    print_failure: bool = False


@dataclasses.dataclass(frozen=True)
class Options:
    """Common optimization options (options.h:18-156)."""

    solver_type: SolverType = SolverType.LEVENBERG_MARQUARDT

    #: Re-evaluate the cost once more after the final iteration and roll back
    #: if it increased (options.h:43).
    check_final_cost: bool = False
    #: Use the relative error decrease as the LM step quality (options.h:46).
    use_step_quality_approx: bool = False
    #: Clip the gradient to [-v, +v]; 0 disables (options.h:49).
    grad_clipping: float = 0.0

    hessian: HessianOptions = HessianOptions()
    cost: CostScalingOptions = CostScalingOptions()

    # --- Stop criteria (options.h:89-106) ---
    max_iters: int = 50
    min_error: float = 1e-12
    min_rerr_dec: float = 1e-10
    min_step_norm2: float = 1e-14
    min_grad_norm2: float = 1e-18
    max_total_failures: int = 0
    max_consec_failures: int = 5
    max_duration_ms: float = 0.0

    #: Record per-iteration history (errs/deltas2/successes) in the Output.
    save_history: bool = True

    #: Callback (err, |δx|², |∇|²) -> bool; True stops the loop.
    stop_callback: Optional[Callable[..., Any]] = None
    #: Callback (err, δx, ∇) -> bool; True stops the loop.
    stop_callback2: Optional[Callable[..., Any]] = None

    log: LogOptions = LogOptions()
    lm: LMOptions = LMOptions()
    gd: GDOptions = GDOptions()
    sgd: SGDOptions = SGDOptions()
    adam: AdamOptions = AdamOptions()
    lbfgs: LBFGSOptions = LBFGSOptions()

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    def for_dtype(self, dtype) -> "Options":
        """Stop thresholds rescaled to the solve dtype's precision.

        Same rule as ``tinyopt_tpu.Options.for_dtype``: squared thresholds
        scale by the FloatEpsilon ratio squared, the relative decrease by
        the ratio; float64 options are returned unchanged."""
        import torch

        from .utils import float_epsilon

        ratio = float_epsilon(dtype) / float_epsilon(torch.float64)
        if ratio == 1.0:
            return self
        return self.replace(
            min_error=self.min_error * ratio ** 2,
            min_rerr_dec=self.min_rerr_dec * ratio,
            min_step_norm2=self.min_step_norm2 * ratio ** 2,
            min_grad_norm2=self.min_grad_norm2 * ratio ** 2,
        )
