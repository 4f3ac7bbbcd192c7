"""Differentiation on the tangent space: automatic (``torch.func``),
numerical (finite differences) and the gradient checker."""

from .auto import (make_acc_system, make_cost_system, make_nlls_system,
                   residual_jacobian, value_and_jacfwd)
from .gradient_check import (GradientCheck, check_gradient,
                             check_residuals_gradient)
from .num_diff import (Method, default_step, estimate_num_jac, kCentral,
                       kFastCentral, kForward, make_num_diff_system,
                       num_eval)

__all__ = [
    "value_and_jacfwd", "make_cost_system", "residual_jacobian", "make_nlls_system", "make_acc_system", "Method",
    "kForward", "kCentral", "kFastCentral", "default_step", "num_eval",
    "estimate_num_jac", "make_num_diff_system", "GradientCheck",
    "check_gradient", "check_residuals_gradient",
]
