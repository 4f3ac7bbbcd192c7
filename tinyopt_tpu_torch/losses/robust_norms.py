"""Robust norms / M-estimators (reference:
include/tinyopt/losses/robust_norms.h).

Counterpart of ``tinyopt_tpu.losses.robust_norms``.  Every estimator takes
the squared norm ``n2 = ‖r‖²`` and a squared threshold ``th2`` and returns
``(loss, scale)``, ``scale`` the IRLS weight of the residual's Jacobian
(robust_norms.h:17-27).  ``*_loss`` variants take a residual vector and
return the robust loss.  ``robust_whiten`` turns an estimator into residual
whitening, so that the same LM solver minimizes Σ ρ(‖rᵢ‖²).
"""

from __future__ import annotations

import torch


def _pair(n2, th2):
    n2 = torch.as_tensor(n2)
    return n2, torch.as_tensor(th2, dtype=n2.dtype, device=n2.device)


def truncated(n2, th2):
    """Hard clip: loss = min(n2, th2), scale ∈ {0,1} (robust_norms.h:35-55)."""
    n2, th2 = _pair(n2, th2)
    inlier = n2 <= th2
    return (torch.where(inlier, n2, th2),
            torch.where(inlier, torch.ones_like(n2), torch.zeros_like(n2)))


def huber(n2, th2):
    """Huber: quadratic inside, linear outside (robust_norms.h:70-103)."""
    n2, th2 = _pair(n2, th2)
    inlier = n2 <= th2
    th = torch.sqrt(th2)
    n = torch.sqrt(torch.clamp(n2, min=1e-30))
    loss = torch.where(inlier, n2, 2.0 * th * n - th2)
    scale = torch.where(inlier, torch.ones_like(n2), th / n)
    return loss, scale


def tukey(n2, th2):
    """Tukey biweight — deliberately renormalized ×⅓ against the cited
    reference (robust_norms.h:122-152 uses loss th²(1−u³), scale 3u²), as
    the JAX package does: the ⅓ restores the loss ≈ n², scale ≈ 1 inlier
    contract of every other estimator here; the outlier plateau is
    therefore th²/3, not th²."""
    n2, th2 = _pair(n2, th2)
    inlier = n2 <= th2
    u = 1.0 - n2 / th2
    loss = torch.where(inlier, th2 / 3.0 * (1.0 - u * u * u), th2 / 3.0)
    scale = torch.where(inlier, u * u, torch.zeros_like(u))
    return loss, scale


def arctan(n2, th2):
    """Arctan soft clamp: loss = th·atan(n²/th), th = √th²,
    scale = 1/(1 + n⁴/th²) (robust_norms.h:169-191)."""
    n2, th2 = _pair(n2, th2)
    th = torch.sqrt(th2)
    loss = th * torch.atan2(n2, th)
    scale = 1.0 / (1.0 + n2 * n2 / th2)
    return loss, scale


def cauchy(n2, th2):
    """Cauchy/Lorentzian: th² log(1 + n²/th²) (robust_norms.h:208-228)."""
    n2, th2 = _pair(n2, th2)
    loss = th2 * torch.log1p(n2 / th2)
    scale = 1.0 / (1.0 + n2 / th2)
    return loss, scale


def geman_mcclure(n2, th2):
    """Geman-McClure: loss = n²/(n²+th²) (plateau 1),
    scale = th²/(n²+th²)² (robust_norms.h:245-265)."""
    n2, th2 = _pair(n2, th2)
    s = th2 + n2
    return n2 / s, th2 / (s * s)


def blake_zisserman(n2, th2):
    """Blake-Zisserman (robust_norms.h:282-303)."""
    n2, th2 = _pair(n2, th2)
    eps = torch.exp(-th2)
    loss = -torch.log(torch.exp(-n2) + eps)
    scale = torch.exp(-n2) / (torch.exp(-n2) + eps)
    return loss, scale


def _loss_of(fn):
    def loss_fn(r, th2):
        r = torch.as_tensor(r).reshape(-1)
        l, _ = fn(torch.dot(r, r), th2)
        return l
    loss_fn.__name__ = f"{fn.__name__}_loss"
    loss_fn.__doc__ = (f"ρ(‖r‖²) of :func:`{fn.__name__}` for a residual "
                       "vector ``r``.")
    return loss_fn


truncated_loss = _loss_of(truncated)
huber_loss = _loss_of(huber)
tukey_loss = _loss_of(tukey)
arctan_loss = _loss_of(arctan)
cauchy_loss = _loss_of(cauchy)
geman_mcclure_loss = _loss_of(geman_mcclure)
blake_zisserman_loss = _loss_of(blake_zisserman)


def robust_whiten(r, robust_fn, th2):
    """Robust whitening: r' = √(ρ(n²)/n²) · r, so that ‖r'‖² = ρ(n²).

    Differentiating a residual function that returns r' carries the
    robustification into its Jacobian, and the squared norm of r' is the
    robust loss: the hard-rejecting norms (truncated, Tukey) add their
    constant plateau ρ(∞) to the cost instead of a spurious zero.  Double
    where guards: neither branch of a ``torch.where`` sees an operand that
    makes its value or its derivative NaN, so ``torch.func`` gives a finite
    gradient at rejection (ρ = 0) and at r = 0.
    """
    r = torch.as_tensor(r).reshape(-1)
    # a sum, not torch.dot: vmapped, dot becomes a batched matmul, whose
    # CUDA library sums in an order that changes with the batch size; a
    # sum keeps one order at every size (K2's generated families sum so)
    n2 = torch.sum(r * r)
    loss, _ = robust_fn(n2, th2)
    tiny = torch.finfo(n2.dtype).tiny
    one = torch.ones_like(n2)
    pos = n2 > tiny
    ratio = torch.clamp(loss, min=0.0) / torch.where(pos, n2, one)
    rpos = ratio > 0
    w = torch.where(pos, torch.where(rpos, torch.sqrt(torch.where(
        rpos, ratio, one)), torch.zeros_like(n2)), one)
    return w * r


def robust_cost(residuals, robust_fn, th2):
    """Robust total cost with inlier accounting (robust_norms.h:60-63
    composed with cost.h:22-37): ``residuals`` (n, k), n blocks of k (or
    (n,) scalar blocks); ``Cost(Σ ρ(‖rᵢ‖²), n, #inliers / n)``, a block an
    inlier when ‖rᵢ‖² ≤ th2."""
    from ..cost import Cost

    r = torch.as_tensor(residuals)
    if r.dim() == 1:
        r = r[:, None]
    r = r.reshape(r.shape[0], -1)
    n2 = torch.sum(r * r, dim=-1)
    loss, _ = robust_fn(n2, th2)
    inl = torch.mean((n2 <= th2).to(torch.float32))
    return Cost(cost=torch.sum(loss),
                num_residuals=torch.tensor(r.shape[0], dtype=torch.int32,
                                           device=r.device),
                inlier_ratio=inl)


def gnc_schedule(th_coarse, th_fine, steps: int = 5):
    """Geometric threshold ladder for graduated non-convexity: from
    ``th_coarse`` (at or above the gross-error scale) down to ``th_fine``
    (the inlier noise scale), ``steps`` thresholds."""
    if steps < 2:
        return (float(th_fine),)
    ratio = (float(th_fine) / float(th_coarse)) ** (1.0 / (steps - 1))
    return tuple(float(th_coarse) * ratio ** i for i in range(steps))


def _whiten_factory(residual_fn, robust_fn):
    def fac(th2):
        def whitened(*args, **kwargs):
            return robust_whiten(residual_fn(*args, **kwargs), robust_fn,
                                 th2)
        return whitened
    return fac


def gnc_anneal(solve_stage, x0, thresholds, *, residual_fn=None,
               robust_fn=None, make_fn=None):
    """Graduated non-convexity: re-solve at each threshold, each stage
    from the previous solution; returns the last ``(x, Output)``.

    ``thresholds`` are unsquared scales, squared here.  With
    ``residual_fn`` (and ``robust_fn``, Geman-McClure by default) the
    residual is whitened at each squared threshold, and each stage calls
    ``solve_stage(x, th2, whitened_fn)``; ``make_fn(th2) -> fn`` builds the
    stage's function instead; with neither, ``solve_stage(x, th2)``.  The
    port has no solve cache to hit, so each call builds its functions.
    """
    if make_fn is None and residual_fn is not None:
        make_fn = _whiten_factory(
            residual_fn, geman_mcclure if robust_fn is None else robust_fn)
    x, out = x0, None
    for th in thresholds:
        th2 = float(th) ** 2
        if make_fn is not None:
            x, out = solve_stage(x, th2, make_fn(th2))
        else:
            x, out = solve_stage(x, th2)
    return x, out
