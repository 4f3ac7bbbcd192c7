"""Batched SE(3) pose refinement — the flagship model.

Counterpart of ``tinyopt_tpu.models.se3_refinement``.  Each instance
refines one SE(3) pose from K noisy 3D point correspondences:

    r_k = T · p_k − q_k           (K×3 residuals, 6-dim tangent)

The pose is an ``SE3`` manifold parameter (7 stored values, 6 tangent
dimensions); the solvers linearize δ ↦ r(T ⊞ δ) at δ = 0 and apply steps
through the right-multiplicative retraction.  ``se3_residual`` is also a
residual family of the K2 CUDA kernel, registered here with
ops/cuda_solver.py for one SE3 pose and (K, 3) points and targets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..manifolds import SE3, SO3
from ..ops import cuda_solver


class SE3RefinementData(NamedTuple):
    points: torch.Tensor   #: (..., K, 3) source points
    targets: torch.Tensor  #: (..., K, 3) observed transformed points


def se3_residual(pose: SE3, data: SE3RefinementData):
    """Per-instance residuals: T·p − q, flattened to (K·3,)."""
    pred = pose.rotation.apply(data.points) + pose.translation[..., None, :]
    return (pred - data.targets).reshape(-1)


def _se3_family_accepts(x_example, spec, data_example) -> bool:
    """Whether K2's SE3 family takes this instance: one SE3 pose (P = 7,
    D = 6) and SE3RefinementData with (K, 3) points and targets."""
    if not isinstance(x_example, SE3) or (spec.params, spec.dims) != (
            cuda_solver.SE3_P, cuda_solver.SE3_D):
        return False
    if not isinstance(data_example, SE3RefinementData):
        return False
    pts, tgt = (torch.as_tensor(a) for a in data_example)
    return (pts.dim() == 2 and pts.shape[-1] == 3 and pts.shape[0] > 0
            and tuple(tgt.shape) == tuple(pts.shape))


cuda_solver.register_family(se3_residual, 2, accepts=_se3_family_accepts)


def make_se3_refinement(batch: int, n_points: int = 16, noise: float = 1e-3,
                        dtype=torch.float32, seed: int = 0, *,
                        generator: torch.Generator | None = None,
                        device="cuda"):
    """Generate batched instances on ``device`` (the card unless the caller
    asks for another) from ``generator`` (or a new one seeded with
    ``seed``): (data, x0 poses, true poses).  Points ~ U(-1, 1), true
    tangents ~ U(-0.5, 0.5), Gaussian target noise of std ``noise``, starts
    perturbed by 0.1 · N(0, 1) in the tangent.  The draws are torch's, not
    the JAX package's (tests carry JAX's data across with ``interop``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return u * (hi - lo) + lo

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    points = uniform((batch, n_points, 3), -1.0, 1.0)
    w_true = uniform((batch, 6), -0.5, 0.5)
    true_pose = SE3.exp(w_true)
    # each instance's rotation over its K points
    rot_b = SO3(true_pose.rotation.wxyz[:, None, :])
    targets = rot_b.apply(points) + true_pose.translation[:, None, :]
    targets = targets + noise * normal(targets.shape)
    x0 = SE3.exp(w_true + 0.1 * normal((batch, 6)))
    return SE3RefinementData(points, targets), x0, true_pose
