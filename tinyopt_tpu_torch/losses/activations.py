"""Activation losses with diagonal Jacobians (reference:
include/tinyopt/losses/activations.h:15-31, helpers.h:13-100).

Counterpart of ``tinyopt_tpu.losses.activations``: elementwise functions,
and ``*_with_jac`` variants returning (value, diagonal Jacobian).
"""

from __future__ import annotations

import torch


def sigmoid(x):
    """1/(1+e⁻ˣ) (activations.h:15-17)."""
    return 1.0 / (1.0 + torch.exp(-torch.as_tensor(x)))


def sigmoid_with_jac(x):
    s = sigmoid(x)
    return s, torch.diag((s * (1.0 - s)).reshape(-1))


def tanh(x):
    """(eˣ−e⁻ˣ)/(eˣ+e⁻ˣ) (activations.h:20-22)."""
    return torch.tanh(torch.as_tensor(x))


def tanh_with_jac(x):
    t = tanh(x)
    return t, torch.diag((1.0 - t * t).reshape(-1))


def relu(x):
    """max(0, x) (activations.h:25-27)."""
    x = torch.as_tensor(x)
    return torch.clamp(x, min=0.0)


def relu_with_jac(x):
    x = torch.as_tensor(x)
    return relu(x), torch.diag((x > 0).to(x.dtype).reshape(-1))


def leaky_relu(x, a: float = 0.01):
    """x>0: x, else a·x (activations.h:30-31)."""
    x = torch.as_tensor(x)
    return torch.where(x > 0, x, a * x)


def leaky_relu_with_jac(x, a: float = 0.01):
    x = torch.as_tensor(x)
    slope = torch.where(x > 0, torch.ones_like(x), torch.full_like(x, a))
    return leaky_relu(x, a), torch.diag(slope.reshape(-1))
