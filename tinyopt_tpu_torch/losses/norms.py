"""Norms (reference: include/tinyopt/losses/norms.h:19-153).

Counterpart of ``tinyopt_tpu.losses.norms``: plain functions under
``torch.func``, with analytic ``*_with_jac`` variants (value, 1 × n
Jacobian) for the gradient checker and manual accumulation functions.
"""

from __future__ import annotations

import torch


def _flat(x) -> torch.Tensor:
    return torch.as_tensor(x).reshape(-1)


def squared_l2(x, add_scale: bool = False):
    """‖x‖²; with add_scale, returns (loss, 2) mirroring norms.h:19-49."""
    x = _flat(x)
    l = torch.dot(x, x)
    return (l, 2.0) if add_scale else l


def l2(x, eps: float = 1e-12):
    """‖x‖, exact in value with an ε-guarded gradient at 0 (norms.h:52-81
    guards only the Jacobian).  The double where keeps the tangent finite
    at 0."""
    x = _flat(x)
    n2 = torch.dot(x, x)
    pos = n2 > eps
    return torch.where(pos, torch.sqrt(torch.where(pos, n2,
                                                   torch.ones_like(n2))),
                       n2 / torch.sqrt(torch.as_tensor(eps, dtype=n2.dtype)))


def l1(x):
    """Σ|xᵢ| (norms.h:84-114)."""
    return torch.sum(torch.abs(_flat(x)))


def linf(x):
    """max|xᵢ| (norms.h:117-153)."""
    return torch.max(torch.abs(_flat(x)))


def squared_l2_with_jac(x):
    x = _flat(x)
    return torch.dot(x, x), 2.0 * x[None, :]


def l2_with_jac(x, eps: float = 1e-12):
    """Exact ‖x‖ with the reference's ε-guarded Jacobian xᵀ/max(‖x‖, ε)
    (norms.h:52-81)."""
    x = _flat(x)
    n = l2(x, eps)
    return n, (x / torch.clamp(n, min=eps))[None, :]


def l1_with_jac(x):
    x = _flat(x)
    return torch.sum(torch.abs(x)), torch.sign(x)[None, :]


def linf_with_jac(x):
    x = _flat(x)
    i = torch.argmax(torch.abs(x))
    hot = torch.arange(x.shape[0], device=x.device) == i
    j = torch.where(hot, torch.sign(x), torch.zeros_like(x))
    return torch.abs(x[i]), j[None, :]
