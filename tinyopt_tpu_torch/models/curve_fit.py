"""Robust curve fitting, batched: ``examples/robust_curve_fit.py``'s model.

y = a·exp(b·t) on n points t ∈ [0, 2], noise N(0, 0.05), a share of the
points (25 % by default) moved by a gross outlier of 3 to 12 either way;
the true (a, b) is (1.7, 0.8).  Three residual functions of one curve:
plain least squares, and the residuals whitened by Huber and by
Geman–McClure at the inlier scale th² = 0.09 (``losses.robust_norms.
robust_whiten``), whose squared norm is Σ ρ(rᵢ²).  None has a
hand-written K2 family: on the card, with ``solver="fused"`` (and
``save_last`` / ``carry_system`` off, the fused envelope), each runs K2 on
a family generated from its trace (``ops/residual_codegen.py``: d = 2, 60
residuals, the data row t then y), one launch a batch; with "cg" the
batch-native loop, with K1 at d = 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..losses.robust_norms import geman_mcclure, huber, robust_whiten

#: The curves' true (a, b).
TRUE_AB = (1.7, 0.8)
#: The inlier scale of the example, squared: 3 σ of the noise, squared.
TH2 = 0.09


class CurveData(NamedTuple):
    """Points of one curve (n,), or of a batch (B, n)."""
    t: torch.Tensor
    y: torch.Tensor


def make_curve_batch(batch: int, n: int = 60, outlier_frac: float = 0.25,
                     dtype=torch.float32, *, seed: int = 0, device="cuda"):
    """``batch`` curves of ``n`` points with ``outlier_frac`` gross
    outliers each, drawn on ``device`` (the card unless the caller asks
    for another) from a generator seeded with ``seed``, and the example's
    start (a, b) = (1, 0.5) for every curve.  Returns (CurveData, x0)."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.linspace(0.0, 2.0, n, dtype=dtype, device=device).expand(
        batch, n).contiguous()
    y = TRUE_AB[0] * torch.exp(TRUE_AB[1] * t) + 0.05 * torch.randn(
        (batch, n), generator=g, dtype=dtype, device=device)
    n_out = int(outlier_frac * n)
    idx = torch.rand((batch, n), generator=g, device=device).argsort(
        dim=1)[:, :n_out]
    size = 3.0 + 9.0 * torch.rand((batch, n_out), generator=g, dtype=dtype,
                                  device=device)
    sign = torch.where(torch.rand((batch, n_out), generator=g,
                                  device=device) < 0.5, -1.0, 1.0).to(dtype)
    y = y.scatter_add(1, idx, size * sign)
    x0 = torch.tensor([1.0, 0.5], dtype=dtype, device=device).expand(
        batch, 2).contiguous()
    return CurveData(t, y), x0


def exp_residuals(x, data: CurveData):
    """rᵢ = a·exp(b·tᵢ) − yᵢ, x = (a, b)."""
    return x[0] * torch.exp(x[1] * data.t) - data.y


def huber_residuals(x, data: CurveData):
    """Each residual Huber-whitened at th² = 0.09."""
    return torch.func.vmap(lambda r: robust_whiten(r[None], huber, TH2))(
        exp_residuals(x, data))


def geman_mcclure_residuals(x, data: CurveData):
    """Each residual Geman–McClure-whitened at th² = 0.09."""
    return torch.func.vmap(
        lambda r: robust_whiten(r[None], geman_mcclure, TH2))(
            exp_residuals(x, data))
