"""Gradient checking against finite differences.

Counterpart of ``tinyopt_tpu.diff.gradient_check`` (reference:
include/tinyopt/diff/gradient_check.h:51-220): a user's (or automatic
differentiation's) gradient and Hessian of one instance against
manifold-aware central differences of the cost.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import manifold as mf
from .auto import _as_cost, flatten_residuals, residual_jacobian
from .num_diff import Method, estimate_num_jac


class GradientCheck(NamedTuple):
    ok: bool
    max_grad_diff: float
    max_h_diff: float


def check_gradient(x, acc: Callable, eps: float = 1e-5,
                   method: Method = Method.CENTRAL) -> GradientCheck:
    """The gradient of the manual accumulation function ``acc(x) -> (cost,
    grad[, H])`` against differences of its cost with step ``eps / 10``
    (``diff::CheckGradient``, gradient_check.h:51-103)."""
    x = mf.as_pytree(x)
    spec = mf.tangent_spec(x)
    out = acc(x)
    if not isinstance(out, (tuple, list)) or len(out) < 2:
        raise ValueError("acc must return (cost, grad[, H])")
    g_user = torch.as_tensor(out[1]).reshape(-1).to(spec.dtype)

    def cost_only(y):
        o = acc(y)
        # the cost slot may be a scalar, a (cost, n) pair or a Cost
        return _as_cost(o[0] if isinstance(o, (tuple, list)) else o
                        ).cost.reshape(())

    g_num = estimate_num_jac(cost_only, x, method, eps / 10.0,
                             spec).reshape(-1)
    gd = (torch.max(torch.abs(g_user - g_num)).item() if spec.dims
          else 0.0)
    return GradientCheck(ok=gd < eps, max_grad_diff=gd, max_h_diff=0.0)


def check_residuals_gradient(x, residual_fn: Callable, eps: float = 1e-5,
                             method: Method = Method.CENTRAL,
                             check_hessian: bool = True) -> GradientCheck:
    """Automatic differentiation's grad = JᵀR and H = JᵀJ of a residual
    function against central differences of ‖r‖² and the numeric JᵀJ
    (``diff::CheckResidualsGradient``, gradient_check.h:144-220)."""
    x = mf.as_pytree(x)
    spec = mf.tangent_spec(x)
    r, J = residual_jacobian(residual_fn, x, spec)
    g_ad = J.T @ r
    H_ad = J.T @ J

    def cost_only(y):
        ry = flatten_residuals(residual_fn(y)).to(spec.dtype)
        return torch.dot(ry, ry)

    g_num = estimate_num_jac(cost_only, x, method, eps / 10.0,
                             spec).reshape(-1)
    # cost = ‖r‖², so its gradient is 2·JᵀR
    gd = (torch.max(torch.abs(2.0 * g_ad - g_num)).item() if spec.dims
          else 0.0)
    hd = 0.0
    if check_hessian and spec.dims:
        J_num = estimate_num_jac(residual_fn, x, method, eps / 10.0, spec)
        hd = torch.max(torch.abs(H_ad - J_num.T @ J_num)).item()
    return GradientCheck(ok=(gd < eps) and (hd < eps), max_grad_diff=gd,
                         max_h_diff=hd)
