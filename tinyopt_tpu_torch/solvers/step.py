"""Step proposal for GN / LM on dense batched normal equations.

Counterpart of ``tinyopt_tpu.solvers.step.propose_step`` (reference:
include/tinyopt/solvers/gn.h:150-171), for the dense (B, d, d) Hessian
with the "cholesky" and the "cg"/"fused" solvers.  "cg" goes through
``ops.cuda_cg.cg_solve``: the K1 kernel on a CUDA device, its plain twin on
the CPU.
"""

from __future__ import annotations

import torch

from ..ops.cuda_cg import cg_solve
from ..ops.linalg import damp_diagonal, solve_psd
from ..options import SolverType


def propose_step(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor, opts):
    """Propose dx for the current (H, g, λ), all batched. Returns (dx, ok).

    GN/LM solve (H ⊕ λ·diag) dx = −g (λ ignored for GN); a failed
    factorization or a non-finite step is reported through ``ok`` (B,)
    for the λ-escalating retry loop."""
    if opts.solver_type == SolverType.DOGLEG:
        raise NotImplementedError(
            "DogLeg is not ported yet (ROADMAP Queue 1, slice A item 5: "
            "solvers/step.py dogleg branch)")
    if opts.solver_type not in (SolverType.LEVENBERG_MARQUARDT,
                                SolverType.GAUSS_NEWTON):
        raise NotImplementedError(
            f"{opts.solver_type.name} is not ported yet (ROADMAP Queue 1, "
            "slice B item 11: solvers/first_order.py)")
    if not isinstance(H, torch.Tensor):
        raise NotImplementedError(
            "BlockDiag / SparseSym Hessians are not ported yet (ROADMAP "
            "Queue 1, slice C item 13)")
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    Hd = damp_diagonal(H, lam) if is_lm else H
    if opts.hessian.solver in ("cg", "fused"):
        iters = opts.hessian.cg_iters or g.shape[-1]
        dx = cg_solve(Hd, -g, iters)
        return dx, torch.all(torch.isfinite(dx), dim=-1)
    return solve_psd(Hd, -g, use_cholesky=opts.hessian.use_ldlt)
