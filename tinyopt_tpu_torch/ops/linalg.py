"""Dense linear-algebra primitives for the normal-equation solves.

Counterpart of ``tinyopt_tpu.ops.linalg`` (reference: include/tinyopt/
math.h:232-277).  Every function takes a leading batch axis.
``solve_psd_cg`` is also the plain twin of the K1 CUDA kernel
(``ops/cuda_cg.py``).
"""

from __future__ import annotations

import torch


def damp_diagonal(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Multiplicative LM damping ``H[i,i] += λ·H[i,i]`` (solvers/lm.h:107-117),
    with absolute λ·1 damping where the diagonal is exactly zero.

    ``H`` (..., d, d), ``lam`` broadcastable to H's batch shape."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damp = torch.where(diag == 0, torch.ones_like(diag), diag)
    lam = torch.as_tensor(lam, dtype=H.dtype, device=H.device)
    return H + torch.diag_embed(lam[..., None] * damp)


def solve_psd(H: torch.Tensor, b: torch.Tensor, use_cholesky: bool = True):
    """Solve ``H dx = b`` for symmetric positive-definite H.

    Returns ``(dx, ok)``; ``ok`` is False where the factorization failed
    (``cholesky_ex`` info ≠ 0) or the solution is non-finite
    (``SolveLDLT`` returning nullopt, math.h:232-240).  The Cholesky
    factors the symmetric part (H + Hᵀ)/2, as JAX's ``cholesky`` does, not
    the lower triangle alone.  With
    ``use_cholesky=False`` it mirrors the reference's unchecked inverse
    path including the 1-dim guard (gn.h:150-171)."""
    d = H.shape[-1]
    if use_cholesky:
        if d == 1:
            h = H[..., 0, 0]
            ok = (h > 0) & torch.isfinite(h) & torch.isfinite(b[..., 0])
            hs = torch.where(h == 0, torch.ones_like(h), h)[..., None]
            dx = torch.where(ok[..., None], b / hs, torch.zeros_like(b))
            return dx, ok
        L, info = torch.linalg.cholesky_ex((H + H.mT) / 2)
        dx = torch.cholesky_solve(b[..., None], L)[..., 0]
        ok = (info == 0) & torch.all(torch.isfinite(dx), dim=-1)
        return dx, ok
    if d == 1:
        eps = float(torch.finfo(H.dtype).eps) ** 0.5
        h = H[..., 0, 0]
        good = h > eps
        hs = torch.where(good, h, torch.ones_like(h))[..., None]
        dx = torch.where(good[..., None], b / hs, torch.zeros_like(b))
        return dx, torch.ones_like(good)
    dx = torch.linalg.solve(H, b)
    return dx, torch.ones(H.shape[:-2], dtype=torch.bool, device=H.device)


def pcg_core(matvec, dinv: torch.Tensor, b: torch.Tensor,
             iters: int) -> torch.Tensor:
    """Jacobi-preconditioned CG, exactly ``iters`` iterations.

    The formulas of ``tinyopt_tpu.ops.linalg.pcg_core``: a direction with
    pᵀHp ≤ finfo.tiny freezes the iterate (α = 0), and the CG β divides by
    max(rz, tiny).  ``matvec`` maps (..., d) -> (..., d); ``dinv`` is the
    inverse diagonal (1 where non-positive), or a callable applying a
    general preconditioner M⁻¹ (the block-Jacobi of the Schur reduced
    solve, ``ops/schur.py``)."""
    eps = torch.finfo(b.dtype).tiny
    prec = dinv if callable(dinv) else (lambda v: v * dinv)
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = torch.sum(r * z, dim=-1)
    for _ in range(iters):
        Hp = matvec(p)
        denom = torch.sum(p * Hp, dim=-1)
        pos = denom > eps
        alpha = torch.where(pos, rz / torch.where(pos, denom,
                                                  torch.ones_like(denom)),
                            torch.zeros_like(rz))
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Hp
        z = prec(r)
        rz_new = torch.sum(r * z, dim=-1)
        p = z + (rz_new / torch.clamp(rz, min=eps))[..., None] * p
        rz = rz_new
    return x


def cg_to_tol(matvec, b: torch.Tensor, *, maxiter: int, tol: float = 0.0,
              atol: float = 0.0, precond=None) -> torch.Tensor:
    """Conjugate gradients with ``jax.scipy.sparse.linalg.cg``'s stopping
    rule, for every instance of a batch at once (``b`` (..., d); the dot
    products reduce over the last axis only).

    From x₀ = 0 and r₀ = b − A(0), an instance iterates while
    ``rs > max(tol²·‖b‖², atol²)`` and ``k < maxiter``, where ``rs`` is
    γ = rᵀM(r) without a preconditioner and ‖r‖² with one; a NaN ``rs``
    (or a NaN ``b``) stops it.  A stopped instance is frozen while the
    others go on, as the vmapped ``lax.while_loop`` freezes it — so an
    instance whose residual reaches exactly 0 stops there instead of
    dividing 0 by 0 (unlike :func:`pcg_core`, which runs a fixed count).
    One departure, by design: an instance whose ``rs`` falls below the
    smallest normal number stops too.  JAX's rule runs on there, and in
    float32 the next pᵀAp can underflow to 0 and turn the iterate NaN (the
    JAX package's own float32 sparse bench ends 13 of 10,000 instances
    SOLVER_FAILED so at d = 10, ``tests/torch_sparse_cg_study.py``); the
    iterate has by then converged far below rounding.  ``matvec`` and ``precond`` map (..., d) -> (..., d)."""
    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = r if precond is None else precond(r)
    p = z
    gamma = dot(r, z)
    atol2 = torch.maximum(tol * tol * dot(b, b),
                          torch.full_like(gamma, atol * atol))
    k = torch.zeros(gamma.shape, dtype=torch.int64, device=b.device)
    tiny = torch.finfo(b.dtype).tiny

    def running():
        rs = gamma if precond is None else dot(r, r)
        return (rs > atol2) & (rs >= tiny) & (k < maxiter)

    run = running()
    while bool(run.any()):
        Ap = matvec(p)
        alpha = gamma / dot(p, Ap)
        x_ = x + alpha[..., None] * p
        r_ = r - alpha[..., None] * Ap
        z_ = r_ if precond is None else precond(r_)
        gamma_ = dot(r_, z_)
        p_ = z_ + (gamma_ / gamma)[..., None] * p
        sel = run[..., None]
        x = torch.where(sel, x_, x)
        r = torch.where(sel, r_, r)
        p = torch.where(sel, p_, p)
        gamma = torch.where(run, gamma_, gamma)
        k = k + run.to(k.dtype)
        run = running()
    return x


def jacobi_inverse(diag: torch.Tensor) -> torch.Tensor:
    """1/diag where diag > 0, else 1 (the PCG preconditioner)."""
    pos = diag > 0
    return torch.where(pos, 1.0 / torch.where(pos, diag,
                                              torch.ones_like(diag)),
                       torch.ones_like(diag))


def solve_psd_cg(H: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched Jacobi-PCG solve of ``H dx = b`` — the plain twin of K1.

    ``H``: (..., d, d), ``b``: (..., d).  Fixed-iteration CG composes with
    the LM loop as an inexact solve: a poor step is rejected and λ
    escalates."""
    def mv(v):
        return torch.matmul(H, v[..., None])[..., 0]

    dinv = jacobi_inverse(torch.diagonal(H, dim1=-2, dim2=-1))
    return pcg_core(mv, dinv, b, iters)


def inv_cov(H: torch.Tensor) -> torch.Tensor:
    """Covariance = H⁻¹ (reference: math.h:88-189), batched over H's
    leading axes; NaN or Inf entries where H is singular."""
    d = H.shape[-1]
    eye = torch.eye(d, dtype=H.dtype, device=H.device).expand(H.shape)
    return torch.linalg.solve_ex(H, eye)[0]


def cov_rescale(cost: torch.Tensor, num_residuals: torch.Tensor,
                dims: int) -> torch.Tensor:
    """Overdetermined-covariance rescale factor (reference output.h:80-93):
    ``cost² / (num_residuals − dims)`` where num_residuals > dims, else 1.
    Shared by ``Output.covariance(rescaled=True)`` and ``covariance_at``."""
    c = torch.as_tensor(cost)
    n = torch.as_tensor(num_residuals, device=c.device)
    return torch.where(n > dims,
                       c * c / torch.clamp(n - dims, min=1).to(c.dtype),
                       torch.ones_like(c))


def max_std_dev(H: torch.Tensor) -> torch.Tensor:
    """√(max coefficient of H⁻¹) (reference: solvers/gn.h:177-183)."""
    return torch.sqrt(torch.amax(inv_cov(H), dim=(-2, -1)))


def refine_psd_solve(H: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     rounds: int, use_cholesky: bool = True) -> torch.Tensor:
    """Mixed-precision iterative refinement of a PSD solve, batched over
    the leading axes (``tinyopt_tpu.ops.linalg.refine_psd_solve``).

    Each of ``rounds`` rounds computes the residual ``r = b − H·x`` in
    float64 and solves ``H c = r`` in the working dtype with
    :func:`solve_psd`.  The forward error contracts by about eps·cond(H) a
    round, so a few rounds recover near-float64 solutions of a float32
    system whenever cond(H) < 1/eps32.  A correction is taken only where it
    is finite and shorter than the one before it (the first: than x);
    refinement stops there for that instance, as a classical refinement
    loop stops once its corrections no longer shrink.  Past cond(H) ~
    1/eps the rounds diverge, and the JAX package, which skips only
    non-finite corrections, takes them: a nearly singular float32
    bundle-adjustment system at λ ~ 1e-8 went from |x| 30 to 2.1e4 in two
    rounds where the float64 solve of the same matrix has |x| 12."""
    prev = torch.linalg.vector_norm(x, dim=-1)
    for _ in range(max(rounds, 0)):
        r = (b.double() - torch.matmul(H.double(), x.double()[..., None])
             [..., 0]).to(H.dtype)
        corr, ok = solve_psd(H, r, use_cholesky=use_cholesky)
        size = torch.linalg.vector_norm(corr, dim=-1)
        take = ok & (size < prev)
        x = x + torch.where(take[..., None], corr, torch.zeros_like(corr))
        prev = torch.where(take, size, torch.zeros_like(size))
    return x
