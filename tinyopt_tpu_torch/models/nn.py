"""Tiny neural-network model: a perceptron trained as NLLS or by GD.

Counterpart of ``tinyopt_tpu.models.nn`` (reference tests/nn.cpp:62-296):
one linear + sigmoid layer whose parameters, a dict ``{"W", "b"}``
(inserted in sorted key order, so the tangent layout is the JAX
package's), are fit as least-squares residuals (LM / GN) or as a scalar
loss (the first-order solvers).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..losses.activations import sigmoid


class PerceptronData(NamedTuple):
    inputs: torch.Tensor     #: (N, in_dim)
    targets: torch.Tensor    #: (N, out_dim)


def init_perceptron(in_dim: int, out_dim: int, dtype=torch.float32, seed=0,
                    device="cuda"):
    """Random weights from a ``torch.Generator`` seeded with ``seed`` (not
    the JAX package's draws: ``interop.perceptron_from_numpy`` carries
    those across)."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "W": (0.5 * torch.randn((out_dim, in_dim), generator=gen,
                                dtype=dtype)).to(device),
        "b": (0.1 * torch.randn((out_dim,), generator=gen,
                                dtype=dtype)).to(device),
    }


def forward(params, x):
    """Batched forward: sigmoid(x Wᵀ + b) (nn.cpp batch forward)."""
    return sigmoid(x @ params["W"].mT + params["b"])


def residuals(params, data: PerceptronData):
    """Per-sample prediction residuals, flattened (NLLS training)."""
    return (forward(params, data.inputs) - data.targets).reshape(-1)


def mse_cost(params, data: PerceptronData):
    """Scalar cost = ‖residuals‖² (GD training)."""
    r = residuals(params, data)
    return torch.sum(r * r)


def manual_jacobian(params, data: PerceptronData):
    """The residual Jacobian by the chain rule: for y = σ(z), z = xWᵀ + b,
    dy/dW[o,i] = σ'(z_o)·x_i and dy/db_o = σ'(z_o); columns in the tangent
    layout of ``params`` (W row-major, then b)."""
    x = data.inputs
    s = sigmoid(x @ params["W"].mT + params["b"])
    ds = s * (1.0 - s)                                   # (N, out)
    n, out_dim = ds.shape
    in_dim = x.shape[1]
    eye = torch.eye(out_dim, dtype=x.dtype, device=x.device)
    # dres[n,o]/dW[p,i] = δ_op·ds[n,o]·x[n,i]; dres[n,o]/db[p] = δ_op·ds[n,o]
    JW = torch.einsum("no,op,ni->nopi", ds, eye, x)
    Jb = torch.einsum("no,op->nop", ds, eye)
    return torch.cat([JW.reshape(n * out_dim, out_dim * in_dim),
                      Jb.reshape(n * out_dim, out_dim)], dim=1)
