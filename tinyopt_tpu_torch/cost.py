"""Cost value + metadata (reference: include/tinyopt/cost.h:18-99).

A dataclass of tensors: ``cost``, ``num_residuals`` (int32) and
``inlier_ratio`` (float32), with a leading instance axis where the loop
batches them, 0-d for one instance (``optimize`` squeezes a batch of one,
a manual accumulation function returns one).  ``log_str`` is the
reference's user log suffix (cost.h:96), one string for the whole batch.
"""

from __future__ import annotations

import dataclasses

import torch


def rss(r) -> torch.Tensor:
    """Σ r² over every entry of ``r``: square, then sum (the JAX package
    takes ``vdot`` for float64; both are one exact reduction here)."""
    r = torch.as_tensor(r).reshape(-1)
    return torch.sum(r * r)


@dataclasses.dataclass
class Cost:
    cost: torch.Tensor              #: cost value (per instance)
    num_residuals: torch.Tensor     #: number of residuals (int32)
    inlier_ratio: torch.Tensor      #: ratio of inlier residuals in [0, 1]
    #: user-extensible log suffix (reference cost.h:96 ``log_str``)
    log_str: str = ""

    @staticmethod
    def make(cost, num_residuals=1, inlier_ratio=1.0,
             log_str: str = "") -> "Cost":
        """A Cost whose count and ratio take the shape of ``cost``."""
        cost = torch.as_tensor(cost)
        dev = cost.device
        n = torch.as_tensor(num_residuals, dtype=torch.int32, device=dev)
        inl = torch.as_tensor(inlier_ratio, dtype=torch.float32, device=dev)
        return Cost(cost=cost, num_residuals=n.expand(cost.shape),
                    inlier_ratio=inl.expand(cost.shape), log_str=log_str)

    @staticmethod
    def from_residuals(residuals, inlier_ratio=1.0) -> "Cost":
        """Cost = squared L2/Frobenius norm of the residuals (cost.h:28-31)."""
        r = torch.as_tensor(residuals).reshape(-1)
        return Cost.make(rss(r), r.numel(), inlier_ratio)

    def __add__(self, other: "Cost") -> "Cost":
        """Accumulate two partial costs, merging inlier counts
        (reference: cost.h:51-64)."""
        n = self.num_residuals + other.num_residuals
        inl = (self.num_inliers() + other.num_inliers()).to(torch.float32)
        ratio = torch.where(n > 0, inl / torch.clamp(n, min=1).to(
            torch.float32), torch.ones_like(inl))
        # log_str merge with a separator, skipping empties (cost.h:55)
        sep = " " if (self.log_str and other.log_str) else ""
        return Cost(cost=self.cost + other.cost, num_residuals=n,
                    inlier_ratio=ratio,
                    log_str=self.log_str + sep + other.log_str)

    def is_valid(self) -> torch.Tensor:
        """n > 0 and cost below the float max sentinel (cost.h:83)."""
        return (self.num_residuals > 0) & (
            self.cost < torch.finfo(self.cost.dtype).max)

    def num_inliers(self) -> torch.Tensor:
        return (self.num_residuals * self.inlier_ratio).to(torch.int32)

    def num_outliers(self) -> torch.Tensor:
        return (self.num_residuals * (1.0 - self.inlier_ratio)).to(
            torch.int32)

    def __float__(self):
        return float(self.cost)

    def to_string(self, label: str = "ε", print_inliers: bool = False) -> str:
        """The reference's log form of one instance's cost."""
        n = int(self.num_residuals)
        s = f"{label}:{float(self.cost):.4e}, n:{n}"
        if n > 1:
            s += f", √{label}/n:{float(torch.sqrt(self.cost / n)):.2e}"
        if print_inliers:
            s += (f", in:{float(self.inlier_ratio) * 100:.2f}% "
                  f"({int(self.num_inliers())})")
        if self.log_str:
            s += " " + self.log_str
        return s


def normalize_cost(cost: Cost, opts) -> Cost:
    """Apply the cost-scaling options (reference: solvers/base.h:41-45):
    optional sqrt, then ×0.5, then ÷n."""
    c = cost.cost
    if not opts.use_squared_norm:
        c = torch.sqrt(c)
    if opts.downscale_by_2:
        c = 0.5 * c
    if opts.normalize:
        c = c / torch.clamp(cost.num_residuals, min=1).to(c.dtype)
    return dataclasses.replace(cost, cost=c)
