"""Mahalanobis norms and whitening (reference:
include/tinyopt/losses/mahalanobis.h:18-172).

Counterpart of ``tinyopt_tpu.losses.mahalanobis``.  ``cov_or_var`` is read
by its shape, like the reference's overloads: a scalar is an isotropic
variance (``maha_*``) or standard deviation (whitening), a (d,) vector
per-coordinate variances (standard deviations for whitening), a (d, d)
matrix a full covariance.  Whitened residuals r' = W·r have
‖r'‖² = ‖r‖²_Σ, and differentiating a residual function carries the
whitening into its Jacobian.
"""

from __future__ import annotations

import torch

from ..utils import float_epsilon


def _apply_inv_cov(x: torch.Tensor, cov_or_var) -> torch.Tensor:
    """Σ⁻¹ x for scalar / variance-vector / full-covariance Σ."""
    c = torch.as_tensor(cov_or_var, dtype=x.dtype, device=x.device)
    if c.dim() == 0:
        safe = torch.where(c < float_epsilon(x.dtype), torch.ones_like(c), c)
        return x / safe
    if c.dim() == 1:
        return x / c
    return torch.linalg.solve(c, x)


def maha_squared_norm(x, cov_or_var):
    """Squared Mahalanobis norm ‖x‖²_Σ = xᵀ Σ⁻¹ x (mahalanobis.h:18-86)."""
    x = torch.as_tensor(x).reshape(-1)
    return torch.dot(x, _apply_inv_cov(x, cov_or_var))


def maha_squared_norm_with_jac(x, cov_or_var, add_scale: bool = True):
    """(‖x‖²_Σ, J) with J = 2(Σ⁻¹x)ᵀ (or (Σ⁻¹x)ᵀ if not add_scale)."""
    x = torch.as_tensor(x).reshape(-1)
    ix = _apply_inv_cov(x, cov_or_var)
    n2 = torch.dot(x, ix)
    J = (2.0 * ix if add_scale else ix)[None, :]
    return n2, J


def maha_norm(x, cov_or_var):
    """Mahalanobis norm ‖x‖_Σ (mahalanobis.h:87-106)."""
    return torch.sqrt(maha_squared_norm(x, cov_or_var))


def maha_norm_with_jac(x, cov_or_var):
    n2, J = maha_squared_norm_with_jac(x, cov_or_var, add_scale=False)
    n = torch.sqrt(n2)
    s = torch.where(n > float_epsilon(n.dtype), n, torch.ones_like(n))
    return n, J / s


def _solve_lower(L, b):
    """L⁻¹ b for a (d,) or (d, k) right-hand side."""
    if b.dim() == 1:
        return torch.linalg.solve_triangular(L, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


def maha_whitened(res, cov_stdevs):
    """Whitened residuals r' with ‖r'‖ = ‖r‖_Σ (mahalanobis.h:110-156):
    divided by an isotropic or per-coordinate standard deviation, or, for
    a full covariance, r' = L⁻¹ r with L its lower Cholesky factor."""
    res = torch.as_tensor(res)
    c = torch.as_tensor(cov_stdevs, dtype=res.dtype, device=res.device)
    if c.dim() <= 1:
        return res / c
    return _solve_lower(torch.linalg.cholesky(c), res)


def maha_whitened_with_jac(res, cov_stdevs):
    """(r', J) with J = d r'/d r (the whitening operator itself)."""
    res = torch.as_tensor(res)
    c = torch.as_tensor(cov_stdevs, dtype=res.dtype, device=res.device)
    if c.dim() == 0:
        return res / c, 1.0 / c
    if c.dim() == 1:
        return res / c, torch.diag(1.0 / c)
    L = torch.linalg.cholesky(c)
    eye = torch.eye(c.shape[0], dtype=res.dtype, device=res.device)
    return _solve_lower(L, res), _solve_lower(L, eye)


def maha_whitened_info_u(res, U):
    """Whitening by an upper-triangular information factor: r' = U·r
    (mahalanobis.h:161-172)."""
    res = torch.as_tensor(res)
    return torch.triu(torch.as_tensor(U, dtype=res.dtype,
                                      device=res.device)) @ res


def maha_whitened_info_u_with_jac(res, U):
    res = torch.as_tensor(res)
    Uu = torch.triu(torch.as_tensor(U, dtype=res.dtype, device=res.device))
    return Uu @ res, Uu
