"""Step proposal for GN / LM / DogLeg on batched normal equations.

Counterpart of ``tinyopt_tpu.solvers.step.propose_step`` (reference:
include/tinyopt/solvers/gn.h:150-171, gd.h:131-134 for fixed-rate GD),
for every Hessian representation: the dense (B, d, d) tensor with the
"cholesky" and the "cg"/"fused" solvers, a :class:`~..ops.block.BlockDiag`
(batched block Cholesky) and a :class:`~..ops.sparse_sym.SparseSym`
(Jacobi-PCG to ``cg_iters``).  Dense "cg" goes through
``ops.cuda_cg.cg_solve``: the K1 kernel on a CUDA device, its plain twin on
the CPU.
"""

from __future__ import annotations

import torch

from ..ops.block import BlockDiag
from ..ops.cuda_cg import cg_solve
from ..ops.linalg import damp_diagonal, solve_psd
from ..ops.sparse_sym import SparseSym
from ..options import SolverType


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def dogleg_core(g, lam, dx_gn, ok_gn, gHg, solve_reg):
    """Powell dogleg blend from precomputed pieces, batched: ``g``,
    ``dx_gn`` (B, d), ``lam``, ``ok_gn``, ``gHg`` (B,).  Returns (dx, ok).

    ``tinyopt_tpu.solvers.step.dogleg_core`` for every instance at once:
    the trust radius is Δ = ref/λ, ref the length of the Gauss-Newton step
    (or of the fallback), a GN step more than κ = 1e3 times the Cauchy step
    is insane, and an insane GN step is replaced by a Levenberg step,
    damped first by λ and, when that one is insane too, by max(λ, 1).
    ``solve_reg(λ_eff) -> (dx, ok)`` solves the λ_eff-damped system for
    the whole batch; it runs only when some instance needs it, and its
    result is kept only for those (the JAX package's ``lax.cond`` under
    ``vmap``: the same per-instance result)."""
    dtype = g.dtype
    lam = lam.to(dtype)
    tiny = torch.finfo(dtype).tiny
    kappa2 = 1e6
    zero = torch.zeros_like(gHg)

    def col(v):
        return v[:, None]

    def sane(ok, n2, n_sd2):
        return ok & torch.where(n_sd2 > 0, n2 <= kappa2 * n_sd2,
                                torch.ones_like(ok))

    def regularized(need, lam_eff):
        if not bool(need.any()):
            return torch.zeros_like(g), torch.zeros_like(need)
        dx, ok = solve_reg(lam_eff)
        return (torch.where(col(need), dx, torch.zeros_like(dx)),
                need & ok)

    dx_gn = torch.where(col(ok_gn), dx_gn, torch.zeros_like(dx_gn))
    gg = _dot(g, g)
    pos_curv = gHg > 0
    alpha = torch.where(pos_curv,
                        gg / torch.where(pos_curv, gHg, torch.ones_like(gHg)),
                        zero)
    dx_sd = col(-alpha) * g                          # Cauchy point
    n_gn2 = _dot(dx_gn, dx_gn)
    n_sd2 = _dot(dx_sd, dx_sd)
    gn_sane = sane(ok_gn, n_gn2, n_sd2)
    dx_r1, ok_r1 = regularized(~gn_sane, lam)
    r1_sane = sane(ok_r1, _dot(dx_r1, dx_r1), n_sd2)
    dx_r2, ok_r2 = regularized(~(gn_sane | r1_sane),
                               torch.clamp(lam, min=1.0))
    dx_reg = torch.where(col(r1_sane), dx_r1, dx_r2)
    ok_reg = torch.where(r1_sane, ok_r1, ok_r2)
    dx_reg = torch.where(col(ok_reg), dx_reg, dx_sd)
    n_reg2 = _dot(dx_reg, dx_reg)
    ref2 = torch.where(gn_sane, n_gn2,
                       torch.where(ok_reg, n_reg2,
                                   torch.where(pos_curv & (n_sd2 > 0), n_sd2,
                                               gg)))
    radius = torch.sqrt(torch.clamp(ref2, min=tiny)) / lam
    # gradient branch clipped to the boundary, never past the Cauchy point
    bd_len = torch.where(pos_curv & (n_sd2 > 0),
                         torch.minimum(radius, torch.sqrt(n_sd2)), radius)
    dx_bd = col(torch.where(gg > 0,
                            -(bd_len / torch.sqrt(torch.clamp(gg, min=tiny))),
                            zero)) * g
    reg_scale = torch.clamp(
        radius / torch.sqrt(torch.clamp(n_reg2, min=tiny)), max=1.0)
    dx_reg = col(reg_scale) * dx_reg
    # two-segment interpolation: ‖dx_sd + τ (dx_gn − dx_sd)‖ = Δ
    dvec = dx_gn - dx_sd
    a = torch.clamp(_dot(dvec, dvec), min=tiny)
    b = 2.0 * _dot(dx_sd, dvec)
    c = n_sd2 - radius * radius
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    tau = (-b + torch.sqrt(disc)) / (2.0 * a)
    dx_mid = dx_sd + col(torch.clamp(tau, 0.0, 1.0)) * dvec
    use_gn = gn_sane & (n_gn2 <= radius * radius)
    use_reg = (~gn_sane) & ok_reg
    use_bd = (~use_gn) & (~use_reg) & ((n_sd2 >= radius * radius)
                                       | (~pos_curv) | (~gn_sane))
    dx = torch.where(col(use_gn), dx_gn,
                     torch.where(col(use_reg), dx_reg,
                                 torch.where(col(use_bd), dx_bd, dx_mid)))
    return dx, torch.all(torch.isfinite(dx), dim=-1)


def _dogleg_step(H, g: torch.Tensor, lam: torch.Tensor, opts):
    """Powell dogleg inside the trust radius ``ref/λ``
    (``tinyopt_tpu.solvers.step._dogleg_step``): the GN step and up to two
    damped steps of the same solver — the blockwise Cholesky of a
    ``BlockDiag``, the Jacobi-PCG of a ``SparseSym``, and for dense
    ``H`` Cholesky ("cholesky") or ``cg_solve`` — K1 on a CUDA device —
    ("cg", "fused"); gᵀHg = g · Hg."""
    use_ldlt = opts.hessian.use_ldlt
    if isinstance(H, BlockDiag):
        dx_gn, ok_gn = H.solve(-g, use_cholesky=use_ldlt)
        return dogleg_core(
            g, lam, dx_gn, ok_gn, _dot(g, H.matvec(g)),
            lambda le: H.damp(le).solve(-g, use_cholesky=use_ldlt))
    if isinstance(H, SparseSym):
        iters = opts.hessian.cg_iters
        dx_gn, ok_gn = H.solve(-g, cg_iters=iters)
        return dogleg_core(
            g, lam, dx_gn, ok_gn, _dot(g, H.matvec(g)),
            lambda le: H.damp(le).solve(-g, cg_iters=iters))
    gHg = _dot(g, torch.matmul(H, g[..., None])[..., 0])
    if opts.hessian.solver in ("cg", "fused"):
        iters = opts.hessian.cg_iters or g.shape[-1]

        def cg_ok(Hm):
            dx = cg_solve(Hm, -g, iters)
            return dx, torch.all(torch.isfinite(dx), dim=-1)

        dx_gn, ok_gn = cg_ok(H)
        return dogleg_core(g, lam, dx_gn, ok_gn, gHg,
                           lambda le: cg_ok(damp_diagonal(H, le)))
    dx_gn, ok_gn = solve_psd(H, -g, use_cholesky=use_ldlt)
    return dogleg_core(
        g, lam, dx_gn, ok_gn, gHg,
        lambda le: solve_psd(damp_diagonal(H, le), -g, use_cholesky=use_ldlt))


def propose_step(H, g: torch.Tensor, lam: torch.Tensor, opts):
    """Propose dx for the current (H, g, λ), all batched. Returns (dx, ok).

    GD proposes dx = −lr·g and always succeeds; GN/LM solve
    (H ⊕ λ·diag) dx = −g (λ ignored for GN); DogLeg takes the Powell
    dogleg step in the trust radius ref/λ; a failed factorization
    or a non-finite step is reported through ``ok`` (B,) for the
    λ-escalating retry loop.  ``H`` is a dense (B, d, d) tensor, a
    ``BlockDiag`` or a ``SparseSym``."""
    if opts.solver_type == SolverType.GRADIENT_DESCENT:
        return -opts.gd.lr * g, torch.ones(g.shape[:-1], dtype=torch.bool,
                                           device=g.device)
    if opts.solver_type == SolverType.DOGLEG:
        return _dogleg_step(H, g, lam, opts)
    if opts.solver_type not in (SolverType.LEVENBERG_MARQUARDT,
                                SolverType.GAUSS_NEWTON):
        raise ValueError(
            f"{opts.solver_type.name} proposes through "
            "solvers/first_order.fo_propose, not propose_step")
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    if isinstance(H, BlockDiag):
        Hd = H.damp(lam) if is_lm else H
        return Hd.solve(-g, use_cholesky=opts.hessian.use_ldlt)
    if isinstance(H, SparseSym):
        # the reference's SimplicialLDLT path (gn.h:154-156) -> Jacobi-PCG
        Hd = H.damp(lam) if is_lm else H
        return Hd.solve(-g, cg_iters=opts.hessian.cg_iters)
    Hd = damp_diagonal(H, lam) if is_lm else H
    if opts.hessian.solver in ("cg", "fused"):
        iters = opts.hessian.cg_iters or g.shape[-1]
        dx = cg_solve(Hd, -g, iters)
        return dx, torch.all(torch.isfinite(dx), dim=-1)
    return solve_psd(Hd, -g, use_cholesky=opts.hessian.use_ldlt)
