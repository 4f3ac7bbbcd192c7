"""Iterative Closest Point (ICP) point-cloud registration, batched.

Counterpart of ``tinyopt_tpu.models.icp``.  Aligns each source cloud to
its destination cloud with UNKNOWN correspondences by alternating

  1. correspondence search: the nearest destination point of every
     (currently transformed) source point, from one dense (N, M) squared
     distance matrix whose cross term is one batched matmul (brute force
     is the accelerator's spatial query);
  2. pose refinement: the batch loop (``optimizers.loop``) on the SE(3)
     tangent of the point-to-point residuals of the matched pairs,
     optionally Huber-whitened per point.

Every pair of a batch (src (B, N, 3), dst (B, M, 3)) runs all
``n_outer`` alternations; each inner solve is one batched loop on the
(B,) poses.  With the "cg" (or "fused") solver that loop calls K1
(``ops.cuda_cg``) at (B, 6, 6) on a CUDA device; K2 does not run here.

Float32 products on a card must not run in TF32
(``torch.backends.cuda.matmul.allow_tf32``, False by default): near-ties
in the correspondence search would flip, and the alternation would part
from the CPU's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..diff.auto import make_nlls_system
from ..losses.robust_norms import huber, robust_whiten
from ..manifolds import SE3, SO3
from ..optimizers.loop import optimize_from_acc
from ..options import Options
from ..output import map_output


def nearest_neighbors(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Index of the nearest ``dst`` point of every ``src`` point, batched
    over leading axes: src (..., N, 3), dst (..., M, 3) -> (..., N).

    ‖s − d‖² = ‖s‖² − 2·s·d + ‖d‖²; the first index of the row minimum,
    as ``jnp.argmin``.  The (N, M) matrix is formed in place on the
    product (the same values: ‖s‖² + (−2·s·d) rounds as ‖s‖² − 2·s·d), so
    one such matrix exists at a time."""
    d2 = torch.matmul(src, dst.mT).mul_(-2.0)
    d2.add_(torch.sum(src * src, dim=-1)[..., :, None])
    d2.add_(torch.sum(dst * dst, dim=-1)[..., None, :])
    return torch.argmin(d2, dim=-1)


def _transform(pose: SE3, pts: torch.Tensor) -> torch.Tensor:
    """T·p for one pose and (N, 3) points, or (B,) poses and (B, N, 3)."""
    rot = SO3(pose.rotation.wxyz[..., None, :])
    return rot.apply(pts) + pose.translation[..., None, :]


def icp_residual(pose: SE3, src: torch.Tensor, matched_dst: torch.Tensor,
                 robust_th: float | None = None) -> torch.Tensor:
    """Point-to-point residuals T·sᵢ − dᵢ of one pair, flattened (3N,),
    optionally Huber-whitened per point (threshold ``robust_th`` on the
    point distance)."""
    r = _transform(pose, src) - matched_dst          # (N, 3)
    if robust_th is not None:
        th2 = robust_th * robust_th
        r = torch.func.vmap(lambda ri: robust_whiten(ri, huber, th2))(r)
    return r.reshape(-1)


def _gather(dst: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(dst, -2, idx[..., None].expand(idx.shape + (3,)))


def icp(src: torch.Tensor, dst: torch.Tensor, pose0: SE3 | None = None,
        options: Options | None = None, *, n_outer: int = 10,
        robust_th: float | None = None):
    """Register ``src`` (B, N, 3) onto ``dst`` (B, M, 3), or one pair
    (N, 3) onto (M, 3).  Returns ``(pose, Output)``: ``pose`` maps source
    into destination frame, ``Output`` is the last inner solve's.

    ICP is non-convex: a far initial pose can land in a correspondence
    local minimum; :func:`icp_multi_start` restarts from several poses."""
    if src.dim() == 2:
        p0 = None if pose0 is None else pytree.tree_map(
            lambda a: a[None], pose0)
        pose, out = icp(src[None], dst[None], p0, options, n_outer=n_outer,
                        robust_th=robust_th)
        return (pytree.tree_map(lambda a: a[0], pose),
                map_output(lambda v: v[0], out))
    options = options or Options(max_iters=8, max_consec_failures=0)
    B = src.shape[0]
    dtype = torch.promote_types(src.dtype, torch.float32)
    if pose0 is None:
        pose0 = SE3.identity(dtype, (B,), src.device)
    pose_ex = pytree.tree_map(lambda a: a[0], pose0)
    spec = mf.tangent_spec(pose_ex)

    def residual(pose, data):
        return icp_residual(pose, data[0], data[1], robust_th)

    def inner_solve(pose, matched):
        acc, ev, _ = make_nlls_system(residual, pose_ex, spec,
                                      (src, matched), (src[0], matched[0]))
        x, out = optimize_from_acc(mf.flatten_batch(pose, spec), acc, ev,
                                   options, spec)
        return mf.unflatten(x, spec), out

    pose = pose0
    for _ in range(max(n_outer - 1, 0)):
        idx = nearest_neighbors(_transform(pose, src), dst)
        pose, _ = inner_solve(pose, _gather(dst, idx))
    idx = nearest_neighbors(_transform(pose, src), dst)
    return inner_solve(pose, _gather(dst, idx))


def multi_start_tangents(n_starts: int, spread: float = 0.5, seed: int = 0,
                         dtype=torch.float32) -> torch.Tensor:
    """The (n_starts, 6) start tangents of :func:`icp_multi_start`: zero
    (the identity) first, then ``spread`` · N(0, 1) from a CPU generator
    seeded ``seed`` (the JAX package draws them with ``jax.random``, whose
    bits are not reproducible here)."""
    gen = torch.Generator().manual_seed(seed)
    w = spread * torch.randn((n_starts - 1, 6), generator=gen,
                             dtype=torch.float64)
    return torch.cat([torch.zeros((1, 6), dtype=torch.float64), w]).to(dtype)


def icp_multi_start(src: torch.Tensor, dst: torch.Tensor, n_starts: int = 8,
                    options: Options | None = None, *, n_outer: int = 10,
                    robust_th: float | None = None, spread: float = 0.5,
                    seed: int = 0):
    """ICP of one pair, src (N, 3) onto dst (M, 3), from ``n_starts``
    rotated initial poses (:func:`multi_start_tangents`) in one batch,
    keeping the lowest final cost (the first on a tie) — the escape from
    correspondence local minima when no pose prior exists.  Returns
    ``(pose, Output)`` of the winner."""
    dtype = torch.promote_types(src.dtype, torch.float32)
    w = multi_start_tangents(n_starts, spread, seed, dtype).to(src.device)
    poses, outs = icp(src.expand((n_starts,) + tuple(src.shape)),
                      dst.expand((n_starts,) + tuple(dst.shape)),
                      SE3.exp(w), options, n_outer=n_outer,
                      robust_th=robust_th)
    best = int(torch.argmin(outs.final_cost.cost))
    return (pytree.tree_map(lambda a: a[best], poses),
            map_output(lambda v: v[best], outs))


class ICPProblem(NamedTuple):
    src: torch.Tensor     #: (..., N, 3)
    dst: torch.Tensor     #: (..., M, 3)
    true_pose: SE3


def make_icp_problem(batch: int | None = None, n_src: int = 128,
                     n_dst: int = 160, noise: float = 1e-3,
                     outlier_frac: float = 0.0, pose_scale: float = 0.3,
                     dtype=torch.float32, seed: int = 0, *,
                     generator: torch.Generator | None = None,
                     device="cuda") -> ICPProblem:
    """Synthetic registration instances on ``device`` (the card unless the
    caller asks for another), drawn from ``generator`` (or a new one
    seeded with ``seed``): ``dst`` ~ U(-1, 1) is a transformed superset of
    ``src`` (partial overlap: ``n_dst > n_src``), true tangents ~
    ``pose_scale`` · U(-1, 1), Gaussian noise of std ``noise`` and a
    share ``outlier_frac`` of the source replaced by gross outliers ~
    U(-4, 4).  The draws are torch's, not the JAX package's (tests carry
    JAX's problems across with ``interop.icp_problem_from_numpy``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    shape = () if batch is None else (batch,)

    def uniform(s, lo, hi):
        u = torch.rand(s, generator=generator, dtype=dtype, device=device)
        return u * (hi - lo) + lo

    dst = uniform(shape + (n_dst, 3), -1.0, 1.0)
    true_pose = SE3.exp(pose_scale * uniform(shape + (6,), -1.0, 1.0))
    # src = T⁻¹ · (first n_src dst points) + noise, so T·src ≈ dst[:n_src]
    src = _transform(true_pose.inverse(), dst[..., :n_src, :])
    src = src + noise * torch.randn(src.shape, generator=generator,
                                    dtype=dtype, device=device)
    if outlier_frac > 0:
        n_out = int(outlier_frac * n_src)
        out_pts = uniform(shape + (n_out, 3), -4.0, 4.0)
        src = torch.cat([src[..., n_out:, :], out_pts], dim=-2)
    return ICPProblem(src=src, dst=dst, true_pose=true_pose)
