"""Mini bundle adjustment: joint camera-pose and landmark refinement.

Counterpart of ``tinyopt_tpu.models.bundle_adjustment``, the canonical
large NLLS problem of the reference's domain (visual SLAM / SfM;
reference README.md:165-167):

* the parameters are ``{"points": (n_pts, 3), "poses": SE3 (n_cams
  batched)}``; the port lays a dict out by sorted keys, as the JAX package
  does (``manifold.tree_flatten_sorted``), so the tangent holds the
  points' 3·n_pts dims first, then the poses' 6·n_cams, in whatever order
  the keys were inserted (here sorted, as the JAX package's maker);
* the observations are a dense (n_cams, n_pts, 2) tensor with a
  visibility mask (a masked pair contributes a zero residual and a zero
  Jacobian): the dense and matrix-free paths solve ``ba_residuals``, and
  ``sparse.schur_optimize`` takes the pair form
  ``project(pose, point[None])[0] - obs``;
* ``make_ba_problem_sparse`` is the point-major layout of the
  sparse-observation solver (ROADMAP item 16, not ported yet); here it
  makes the data and ``reprojection_rmse_sparse`` measures it.

The makers draw from ``numpy.random.default_rng(seed)`` in the JAX
package's order, so one seed gives the same problem, and build it on
``device`` (the card unless the caller asks for another).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..manifolds import SE3, SO3


class BAData(NamedTuple):
    observations: torch.Tensor  #: (n_cams, n_pts, 2) normalized pixels
    mask: torch.Tensor          #: (n_cams, n_pts) 1.0 = visible


def _pinhole(pc: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(pc[..., 2:3], min=1e-6)
    return pc[..., :2] / z


def project(pose: SE3, points: torch.Tensor) -> torch.Tensor:
    """Normalized pinhole projection of world points (n, 3) into one
    camera, ``pose`` mapping world to camera: (n, 2) = (x/z, y/z)."""
    return _pinhole(pose.rotation.apply(points) + pose.translation[None, :])


def _in_cameras(poses: SE3, points: torch.Tensor) -> torch.Tensor:
    """Every point in every camera's frame, (n_cams, n_pts, 3): the
    arithmetic of :func:`project` for each pair, by broadcasting."""
    return (SO3(poses.rotation.wxyz[:, None, :]).apply(points[None, :, :])
            + poses.translation[:, None, :])


def ba_residuals(params, data: BAData) -> torch.Tensor:
    """Masked reprojection residuals, flattened (n_cams · n_pts · 2,)."""
    pc = _in_cameras(params["poses"], params["points"])
    res = (_pinhole(pc) - data.observations) * data.mask[..., None]
    return res.reshape(-1)


def make_ba_problem(n_cams: int = 4, n_pts: int = 24, noise: float = 0.0,
                    visibility: float = 1.0, pose_noise: float = 0.05,
                    point_noise: float = 0.05, dtype=torch.float64,
                    seed: int = 0, device="cuda"):
    """Synthetic BA instance: cameras on a ring looking at a point cloud.

    Returns ``(data, x0, x_true)``.  The first camera's pose and the first
    point are not perturbed in ``x0`` (gauge anchoring: their columns
    still take part, as in the prior-anchored formulation)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n_pts, 3))
    pts[:, 2] += 4.0                       # cloud in front of the cameras

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # Ring spacing 0.25 rad between neighbours for small rigs, capped to a
    # ±0.75 rad arc for large ones (100+ cameras would otherwise wrap and
    # look away from the cloud).
    spacing = min(0.25, 1.5 / max(n_cams - 1, 1))
    ang = np.asarray([spacing * (i - (n_cams - 1) / 2)
                      for i in range(n_cams)])
    w = t(np.stack([np.zeros(n_cams), ang, np.zeros(n_cams)], 1))
    c = t(np.stack([2.0 * np.sin(ang), np.zeros(n_cams),
                    4.0 - 4.0 * np.cos(ang)], 1))
    Rwc = SO3.exp(w).inverse()             # world -> cam: R^T (x_w - c)
    true_poses = SE3(Rwc, -Rwc.apply(c))
    true_points = t(pts)

    pc = _in_cameras(true_poses, true_points)
    obs = _pinhole(pc)
    obs = obs + noise * t(rng.normal(size=tuple(obs.shape)))

    # Cheirality: only points comfortably in front of a camera are seen
    # (the margin exceeds the depth shift the x0 perturbations can cause).
    mask = t(rng.uniform(size=(n_cams, n_pts)) < visibility)
    mask = mask * (pc[..., 2] > 1.0).to(dtype)

    # Perturbed start, anchored at camera 0 and point 0.
    dw = pose_noise * rng.normal(size=(n_cams, 6))
    dw[0] = 0.0
    x0_poses = true_poses @ SE3.exp(t(dw))
    dp = point_noise * rng.normal(size=(n_pts, 3))
    dp[0] = 0.0
    x0_points = true_points + t(dp)

    x0 = {"points": x0_points, "poses": x0_poses}
    x_true = {"points": true_points, "poses": true_poses}
    return BAData(obs, mask), x0, x_true


def reprojection_rmse(params, data: BAData) -> torch.Tensor:
    """√(Σ r² / (2 · observed pairs))."""
    r = ba_residuals(params, data)
    n = torch.clamp(torch.sum(data.mask) * 2.0, min=1.0)
    return torch.sqrt(torch.sum(r * r) / n)


def _slot_residuals(poses: SE3, points, obs, cam_idx, mask):
    """(n_pts, K, 2) masked residuals of the point-major layout."""
    cams = cam_idx.long()
    pc = (SO3(poses.rotation.wxyz[cams]).apply(points[:, None, :])
          + poses.translation[cams])
    return (_pinhole(pc) - obs) * mask[..., None]


def make_ba_problem_sparse(n_cams: int = 200, n_pts: int = 2000,
                           k_obs: int = 8, noise: float = 0.0,
                           pose_noise: float = 0.02,
                           point_noise: float = 0.02, dtype=torch.float64,
                           seed: int = 0, device="cuda"):
    """Sparse-visibility BA in the point-major layout.

    A corridor rig: cameras along a straight rail looking forward (+z),
    landmarks scattered in front of it, each seen by its ``k_obs`` nearest
    cameras — O(n_pts · k_obs) observations instead of the grid's
    O(n_cams · n_pts).  Returns ``((obs, cam_idx, mask), x0, x_true)``
    with obs (n_pts, k_obs, 2), cam_idx (n_pts, k_obs) int32, mask
    (n_pts, k_obs) all ones, and x0 / x_true ``{"points", "poses"}``."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    rail = 0.5 * np.arange(n_cams)                     # camera x positions
    px = rng.uniform(rail[0], rail[-1] if n_cams > 1 else 1.0, n_pts)
    py = rng.uniform(-1.0, 1.0, n_pts)
    pz = rng.uniform(3.0, 5.0, n_pts)
    true_points = t(np.stack([px, py, pz], 1))

    # identity rotations, camera centres on the rail: x_c = x_w - c
    qs = np.zeros((n_cams, 4))
    qs[:, 0] = 1.0
    ts = np.stack([-rail, np.zeros(n_cams), np.zeros(n_cams)], 1)
    true_poses = SE3(SO3(t(qs)), t(ts))

    # each landmark: the k_obs cameras nearest in x
    nearest = np.clip(np.searchsorted(rail, px), 0, n_cams - 1)
    lo = np.clip(nearest - k_obs // 2, 0, max(n_cams - k_obs, 0))
    cam_idx = t((lo[:, None] + np.arange(k_obs)[None, :]).astype(np.int32),
                torch.int32)
    mask = torch.ones((n_pts, k_obs), dtype=dtype, device=device)
    obs = _slot_residuals(true_poses, true_points,
                          torch.zeros((n_pts, k_obs, 2), dtype=dtype,
                                      device=device), cam_idx, mask)
    obs = obs + noise * t(rng.normal(size=tuple(obs.shape)))

    # Perturbed start, camera 0 and point 0 anchored.  The perturbation
    # multiplies from the left, T' = exp(w)·T, in the camera frame, where
    # the lever arm is the scene depth; a right perturbation's lever arm
    # is the camera's distance to the world origin, hundreds of units down
    # the rail.
    dw = pose_noise * rng.normal(size=(n_cams, 6))
    dw[0] = 0.0
    x0_poses = SE3.exp(t(dw)) @ true_poses
    dp = point_noise * rng.normal(size=(n_pts, 3))
    dp[0] = 0.0
    x0_points = true_points + t(dp)

    x0 = {"points": x0_points, "poses": x0_poses}
    x_true = {"points": true_points, "poses": true_poses}
    return (obs, cam_idx, mask), x0, x_true


def reprojection_rmse_sparse(params, obs, cam_idx, mask) -> torch.Tensor:
    """Reprojection RMSE in the point-major layout."""
    r = _slot_residuals(params["poses"], params["points"], obs, cam_idx,
                        mask)
    n = torch.clamp(torch.sum(mask) * 2.0, min=1.0)
    return torch.sqrt(torch.sum(r * r) / n)
