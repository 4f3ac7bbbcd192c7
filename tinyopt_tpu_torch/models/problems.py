"""Canonical optimization problems of the ported slice.

Counterparts of ``tinyopt_tpu.models.problems`` as residual functions of
ONE instance over torch tensors (batched by ``torch.func.vmap``):

  * sqrt2 scalar NLLS            (reference: tests/sqrt2.cpp)
  * the sparse diagonal problem  (benchmarks/sparse.cpp)
  * Gaussian prior (whitened)    (benchmarks/dense.cpp:53-114 — the
                                  headline benchmark, dims 2..50)
  * the easy and hard suites     (tests/optimize_easy.cpp,
                                  tests/optimize_hard.cpp): Rosenbrock,
                                  Powell singular, Beale, Himmelblau,
                                  Jennrich-Sampson, Wood, Freudenstein-Roth

``prior_residual``, ``jennrich_sampson_residuals``,
``powell_singular_residuals`` and ``wood_residuals`` are residual families
the K2 CUDA kernel implements by hand; this module registers them with
ops/cuda_solver.py.  The scalar costs (``rosenbrock_cost``,
``plateau_cost``, ``easom_cost``) are the easy suite's first-order
problems.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_solver


def sqrt2_residual(x):
    return x * x - 2.0


def make_circle(n=10, r=2.0, center=(2.0, 7.0), noise=1e-5, seed=0,
                dtype=torch.float32, device="cuda"):
    """Fit a circle to ``n`` noisy points on it: the residual of each point
    is |p − c|² − ρ² over x = (c_x, c_y, ρ), from the start (0, 0, 1).
    The points are drawn from ``numpy.random.default_rng(seed)`` as the
    JAX package draws them, so one seed gives the same problem; built on
    ``device`` (the card unless the caller asks for another)."""
    rng = np.random.default_rng(seed)
    ang = np.arange(n) * 2 * np.pi / (n - 1)
    obs = np.asarray(center)[None, :] + r * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    obs = obs + noise * rng.uniform(-1, 1, obs.shape)
    obs = torch.as_tensor(obs, dtype=dtype, device=device)

    def residuals(x):
        delta = obs - x[:2][None, :]
        return torch.sum(delta * delta, dim=-1) - x[2] * x[2]

    return residuals, torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                   device=device)


class PriorProblem(NamedTuple):
    """Whitened Gaussian prior: r = (x − y)/σ (benchmarks/dense.cpp:55-56)."""
    y: torch.Tensor
    inv_std: torch.Tensor

    def residuals(self, x):
        return (x - self.y) * self.inv_std


def make_prior_batch(batch: int, dims: int, dtype=torch.float32, *,
                     generator: torch.Generator | None = None, seed: int = 0,
                     device="cuda"):
    """Batched Gaussian-prior instances + random starts (the bench suite):
    y ~ U(-1, 1), σ ~ U(0.1, 1.1), x0 ~ U(-1, 1), drawn on ``device`` (the
    card unless the caller asks for another) from ``generator`` (or a new
    one seeded with ``seed``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi):
        u = torch.rand((batch, dims), generator=generator, dtype=dtype,
                       device=device)
        return u * (hi - lo) + lo

    y = uniform(-1.0, 1.0)
    std = uniform(0.1, 1.1)
    x0 = uniform(-1.0, 1.0)
    return PriorProblem(y=y, inv_std=1.0 / std), x0


def prior_residual(x, data: PriorProblem):
    return data.residuals(x)


def sparse_diag_residual(x):
    """Independent per-coordinate problem (benchmarks/sparse.cpp): block-
    diagonal JᵀJ.  r_i = x_i² − i."""
    targets = torch.arange(1, x.shape[0] + 1, device=x.device).to(x.dtype)
    return x * x - targets


def rosenbrock_residuals(p, a=1.0, b=100.0):
    """As NLLS residuals: [a − x, √b (y − x²)]."""
    return torch.stack([a - p[0], math.sqrt(b) * (p[1] - p[0] * p[0])])


def rosenbrock_cost(p, a=1.0, b=100.0):
    return (a - p[0]) ** 2 + b * (p[1] - p[0] ** 2) ** 2


def plateau_cost(p, eps=1e-2):
    """Flat plateau with a shallow quadratic well."""
    return torch.sum(torch.tanh(p * p) + eps * p * p)


def easom_cost(p):
    """Easom: 1 − cos(x)cos(y)e^{−((x−π)²+(y−π)²)}, global min at (π, π)
    on a near-flat plateau (tests/optimize_easy.cpp:90-143)."""
    dx = p[0] - math.pi
    dy = p[1] - math.pi
    return 1.0 - torch.cos(p[0]) * torch.cos(p[1]) * torch.exp(
        -(dx * dx + dy * dy))


def powell_singular_residuals(p):
    """Powell's singular function (4 params, singular Hessian at 0)."""
    x1, x2, x3, x4 = p
    return torch.stack([
        x1 + 10.0 * x2,
        math.sqrt(5.0) * (x3 - x4),
        (x2 - 2.0 * x3) ** 2,
        math.sqrt(10.0) * (x1 - x4) ** 2,
    ])


def beale_residuals(p):
    x, y = p
    return torch.stack([
        1.5 - x + x * y,
        2.25 - x + x * y * y,
        2.625 - x + x * y ** 3,
    ])


def himmelblau_residuals(p):
    x, y = p
    return torch.stack([x * x + y - 11.0, x + y * y - 7.0])


def wood_residuals(p):
    """Wood's function as 6 residuals, min at (1, 1, 1, 1)
    (tests/optimize_hard.cpp:112-144)."""
    x1, x2, x3, x4 = p
    s10 = math.sqrt(10.0)
    return torch.stack([
        10.0 * (x2 - x1 * x1),
        1.0 - x1,
        math.sqrt(90.0) * (x4 - x3 * x3),
        1.0 - x3,
        s10 * (x2 + x4 - 2.0),
        (x2 - x4) / s10,
    ])


def freudenstein_roth_residuals(p):
    """Freudenstein-Roth, global min at (5, 4)
    (tests/optimize_hard.cpp:155-214)."""
    x1, x2 = p
    return torch.stack([
        x1 - 13.0 + ((5.0 - x2) * x2 - 2.0) * x2,
        x1 - 29.0 + ((x2 + 1.0) * x2 - 14.0) * x2,
    ])


def jennrich_sampson_residuals(p, m: int = 10):
    """r_i = 2 + 2i − (e^{i x1} + e^{i x2}), i = 1..m."""
    x1, x2 = p[0], p[1]
    i = torch.arange(1, m + 1, device=p.device).to(p.dtype)
    return 2.0 + 2.0 * i - (torch.exp(i * x1) + torch.exp(i * x2))


cuda_solver.register_family(prior_residual, 0)
cuda_solver.register_family(
    jennrich_sampson_residuals, 1,
    accepts=lambda x_example, spec, data_example: spec.dims == 2)


def _four_params(x_example, spec, data_example):
    return spec.dims == 4 and spec.params == 4


cuda_solver.register_family(powell_singular_residuals, 3,
                            accepts=_four_params)
cuda_solver.register_family(wood_residuals, 4, accepts=_four_params)
