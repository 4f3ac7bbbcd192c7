"""Canonical optimization problems of the ported slice.

Counterparts of ``tinyopt_tpu.models.problems`` as residual functions of
ONE instance over torch tensors (batched by ``torch.func.vmap``):

  * sqrt2 scalar NLLS            (reference: tests/sqrt2.cpp)
  * Gaussian prior (whitened)    (benchmarks/dense.cpp:53-114 — the
                                  headline benchmark, dims 2..50)
  * Jennrich-Sampson             (tests/optimize_hard.cpp)

``prior_residual`` and ``jennrich_sampson_residuals`` are the residual
families the K2 CUDA kernel implements by hand (ops/cuda_solver.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def sqrt2_residual(x):
    return x * x - 2.0


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


def jennrich_sampson_residuals(p, m: int = 10):
    """r_i = 2 + 2i − (e^{i x1} + e^{i x2}), i = 1..m."""
    x1, x2 = p[0], p[1]
    i = torch.arange(1, m + 1, device=p.device).to(p.dtype)
    return 2.0 + 2.0 * i - (torch.exp(i * x1) + torch.exp(i * x2))
