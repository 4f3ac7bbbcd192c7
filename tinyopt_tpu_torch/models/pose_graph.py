"""Pose-graph optimization (SLAM backend).

Counterpart of ``tinyopt_tpu.models.pose_graph``: N poses on SE(3) linked
by noisy relative-pose measurements; the residual of edge (i, j) with
measurement Ẑᵢⱼ is

    r_ij = log(Ẑᵢⱼ⁻¹ · Xᵢ⁻¹ · Xⱼ)      ∈ ℝ⁶

The edge list is a static (E, 2) index tensor; edge residuals are
gathered and computed for every edge at once, and the poses are one
batched SE3.  The gauge is fixed by a prior residual on pose 0.  Large
graphs solve through the chain solver (``chain.py``), whose float32 run
on the card needs TF32 off (torch's default for matmuls).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..manifolds import SE3, SO3


class PoseGraphData(NamedTuple):
    edges: torch.Tensor     #: (E, 2) int64 — (i, j) vertex indices
    meas_q: torch.Tensor    #: (E, 4) measured relative rotation (wxyz)
    meas_t: torch.Tensor    #: (E, 3) measured relative translation
    anchor_q: torch.Tensor  #: (4,) prior pose-0 rotation
    anchor_t: torch.Tensor  #: (3,) prior pose-0 translation


def _rel(poses: SE3, i, j) -> SE3:
    """Xᵢ⁻¹ · Xⱼ for gathered vertex indices."""
    Xi = SE3(SO3(poses.rotation.wxyz[..., i, :]), poses.translation[..., i, :])
    Xj = SE3(SO3(poses.rotation.wxyz[..., j, :]), poses.translation[..., j, :])
    return Xi.inverse() @ Xj


def pose_graph_residuals(poses: SE3, data: PoseGraphData) -> torch.Tensor:
    """Stacked edge residuals + the gauge-anchoring prior on pose 0."""
    e = data.edges.to(poses.translation.device)
    rel = _rel(poses, e[:, 0], e[:, 1])
    r_edges = (SE3(SO3(data.meas_q), data.meas_t).inverse() @ rel).log()
    anchor = SE3(SO3(data.anchor_q), data.anchor_t)
    x0 = SE3(SO3(poses.rotation.wxyz[0]), poses.translation[0])
    r_anchor = (anchor.inverse() @ x0).log()
    return torch.cat([r_edges.reshape(-1), r_anchor])


def make_pose_graph(n_poses: int = 12, extra_loops: int = 4,
                    noise: float = 0.0, init_noise: float = 0.1,
                    dtype=torch.float64, seed: int = 0, device="cuda"):
    """Synthetic pose graph on ``device`` (the card unless the caller asks
    for another): a chain (odometry) plus random loop closures.

    Returns ``(data, x0 poses, true poses)``.  The draws are the JAX
    package's, from ``np.random.default_rng(seed)`` in its order (the
    deltas, the loop pairs, the measurement noise, the initial noise), so
    one seed gives both packages the same graph; the true trajectory is
    composed pose by pose, as the JAX package's scan does."""
    rng = np.random.default_rng(seed)
    deltas = 0.4 * rng.uniform(-1, 1, (n_poses - 1, 6))
    steps = SE3.exp(torch.as_tensor(deltas, dtype=dtype, device=device))
    ident = SE3.identity(dtype, device=device)
    qs, ts = [ident.rotation.wxyz], [ident.translation]
    for k in range(n_poses - 1):
        nxt = SE3(SO3(qs[-1]), ts[-1]) @ SE3(
            SO3(steps.rotation.wxyz[k]), steps.translation[k])
        qs.append(nxt.rotation.wxyz)
        ts.append(nxt.translation)
    true_poses = SE3(SO3(torch.stack(qs)), torch.stack(ts))

    edges = [(k, k + 1) for k in range(n_poses - 1)]
    for _ in range(extra_loops):
        i, j = sorted(rng.choice(n_poses, size=2, replace=False))
        if j - i > 1:
            edges.append((int(i), int(j)))
    edges = torch.as_tensor(np.asarray(edges, np.int64), device=device)

    dq = noise * rng.normal(size=(edges.shape[0], 6))
    noisy = _rel(true_poses, edges[:, 0], edges[:, 1]) @ SE3.exp(
        torch.as_tensor(dq, dtype=dtype, device=device))
    data = PoseGraphData(
        edges=edges, meas_q=noisy.rotation.wxyz, meas_t=noisy.translation,
        anchor_q=true_poses.rotation.wxyz[0],
        anchor_t=true_poses.translation[0])

    # perturbed initial guess (anchor kept exact)
    dw = init_noise * rng.normal(size=(n_poses, 6))
    dw[0] = 0.0
    x0 = true_poses @ SE3.exp(torch.as_tensor(dw, dtype=dtype,
                                              device=device))
    return data, x0, true_poses


def pose_graph_edge_fn(x_i: SE3, x_j: SE3, data_e) -> torch.Tensor:
    """One relative-pose residual log(Ẑᵢⱼ⁻¹ · Xᵢ⁻¹ · Xⱼ) for
    :func:`tinyopt_tpu_torch.chain.chain_optimize` (``data_e = (q, t)``)."""
    q, t = data_e
    return (SE3(SO3(q), t).inverse() @ (x_i.inverse() @ x_j)).log()


def _anchor_fn(x_n: SE3, dd):
    q, t = dd
    return (SE3(SO3(q), t).inverse() @ x_n).log()


def _graph(data: PoseGraphData):
    return dict(edges=data.edges.cpu().numpy(),
                edge_data=(data.meas_q, data.meas_t), unary_fn=_anchor_fn,
                unary_nodes=np.asarray([0]),
                unary_data=(data.anchor_q[None], data.anchor_t[None]))


def pose_graph_optimize(x0: SE3, data: PoseGraphData, options=None, **kw):
    """Direct large-scale pose-graph solve by the chain solver: odometry
    edges (j == i+1) form the block-tridiagonal backbone, loop closures
    enter through the Woodbury low-rank correction — an iteration costs
    O(N·d³ + N·d²·m + m³), whatever the conditioning, and no dense H
    exists.  ``kw`` goes to :func:`tinyopt_tpu_torch.chain.chain_optimize`
    (``method=``)."""
    from ..chain import chain_optimize

    g = _graph(data)
    return chain_optimize(x0, pose_graph_edge_fn, g.pop("edges"),
                          g.pop("edge_data"), options, **g, **kw)


def pose_graph_marginals(x: SE3, data: PoseGraphData,
                         rescaled: bool = False):
    """Per-pose (6, 6) posterior marginal covariance blocks at the
    solution, by the selected-inverse recursion off the chain solver's
    block-tridiagonal factor with the Woodbury loop-closure downdate
    (:func:`tinyopt_tpu_torch.chain.chain_marginals`); O(N·d³), never
    dense in H.  The tangent order is SE3's, translation then rotation."""
    from ..chain import chain_marginals

    g = _graph(data)
    return chain_marginals(x, pose_graph_edge_fn, g.pop("edges"),
                           g.pop("edge_data"), rescaled=rescaled, **g)
