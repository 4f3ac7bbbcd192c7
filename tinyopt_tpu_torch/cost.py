"""Cost value + metadata (reference: include/tinyopt/cost.h:18-99).

A dataclass of tensors with a leading instance axis: ``cost`` (B,),
``num_residuals`` (B,) int32 and ``inlier_ratio`` (B,) float32.  A single
solve is a batch of one whose fields are squeezed to 0-d by ``optimize``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Cost:
    cost: torch.Tensor              #: cost value per instance
    num_residuals: torch.Tensor     #: number of residuals (int32)
    inlier_ratio: torch.Tensor      #: ratio of inlier residuals in [0, 1]

    @staticmethod
    def make(cost: torch.Tensor, num_residuals, inlier_ratio=1.0) -> "Cost":
        dev = cost.device
        n = torch.as_tensor(num_residuals, dtype=torch.int32, device=dev)
        inl = torch.as_tensor(inlier_ratio, dtype=torch.float32, device=dev)
        return Cost(cost=cost, num_residuals=n.expand(cost.shape),
                    inlier_ratio=inl.expand(cost.shape))

    def __float__(self):
        return float(self.cost)


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
