"""Bundle Adjustment in the Large (BAL) camera model and problem loader.

Counterpart of ``tinyopt_tpu.models.bal``: the canonical large-scale BA
benchmark (Agarwal, Snavely, Seitz, Szeliski, "Bundle Adjustment in the
Large", ECCV 2010; grail.cs.washington.edu/projects/bal), the dataset
family the point-major layout of ``ops/schur_obs.py`` is built for.

Camera model (the BAL convention, 9 parameters):

* ``R`` — world→camera rotation (the file stores a Rodrigues angle-axis
  vector; in memory it is an :class:`~tinyopt_tpu_torch.manifolds.SO3`
  quaternion),
* ``t`` — translation, ``P = R·X + t``,
* ``f, k1, k2`` — focal length and two radial-distortion coefficients:
  ``p = -(P.x, P.y)/P.z`` (BAL cameras look down −z, hence the minus),
  ``r(p) = 1 + k1·‖p‖² + k2·‖p‖⁴``, ``p' = f·r(p)·p``.

A camera is the pytree ``{"intr": (3,), "pose": SE3}`` — tangent dims
3 + 6 = 9 — laid out by sorted key as every dict of the port
(``manifold.tree_flatten_sorted``), so the tangent holds the intrinsics
first, as the JAX package's; the makers insert the keys in that order
too, so ``torch.utils._pytree`` lists the leaves as JAX does.

:func:`load_bal` reads the published text format into the point-major
padded layout (obs (n_pts, K, 2), cam_idx, mask) or into its K-buckets;
:func:`write_bal` emits it.  :func:`make_bal_problem` draws synthetic
instances in the same convention from ``numpy.random.default_rng(seed)``
in the JAX package's order, so one seed gives the same problem.  Tensors
are made on ``device``, the card unless the caller asks for another.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..manifolds import SE3, SO3


def bal_project(camera, point: torch.Tensor) -> torch.Tensor:
    """Project one world point through one BAL camera → (2,) pixels.

    ``camera`` = {"pose": SE3 (world→camera), "intr": (f, k1, k2)}."""
    pose = camera["pose"]
    f, k1, k2 = camera["intr"][0], camera["intr"][1], camera["intr"][2]
    P = pose.rotation.apply(point[None, :])[0] + pose.translation
    # BAL looks down −z: z is negative for points in front of the camera
    z = P[2]
    z = torch.where(torch.abs(z) < 1e-8,
                    torch.where(z < 0, -1e-8, 1e-8).to(z.dtype), z)
    p = -P[:2] / z
    n2 = p[0] * p[0] + p[1] * p[1]
    r = 1.0 + k1 * n2 + k2 * n2 * n2
    return f * r * p


def bal_residual(camera, point: torch.Tensor,
                 obs: torch.Tensor) -> torch.Tensor:
    """Reprojection residual — the ``pair_fn`` of the Schur BA paths."""
    return bal_project(camera, point) - obs


def _axis_angle_to_wxyz(aa: np.ndarray) -> np.ndarray:
    """Rodrigues vectors (n, 3) → quaternions (n, 4) wxyz (host-side)."""
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    half = 0.5 * theta
    # the sinc form is exact at theta → 0
    small = theta < 1e-12
    k = np.where(small, 0.5, np.sin(half) / np.where(small, 1.0, theta))
    return np.concatenate([np.cos(half), k * aa], axis=1)


def _wxyz_to_axis_angle(q: np.ndarray) -> np.ndarray:
    """Quaternions (n, 4) wxyz → Rodrigues vectors (n, 3) (host-side)."""
    q = q * np.sign(q[:, :1] + (q[:, :1] == 0))    # the w >= 0 branch
    w = np.clip(q[:, :1], -1.0, 1.0)
    v = q[:, 1:]
    vn = np.linalg.norm(v, axis=1, keepdims=True)
    theta = 2.0 * np.arctan2(vn, w)
    small = vn < 1e-12
    return np.where(small, 2.0 * v, theta * v / np.where(small, 1.0, vn))


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def cameras_from_bal(params9: np.ndarray, dtype=torch.float64,
                     device="cuda"):
    """(n_cams, 9) BAL rows [aa(3), t(3), f, k1, k2] → a batched camera
    pytree on ``device``."""
    params9 = np.asarray(params9, np.float64)
    q = _axis_angle_to_wxyz(params9[:, :3])
    return {"intr": _t(params9[:, 6:9], dtype, device),
            "pose": SE3(SO3(_t(q, dtype, device)),
                        _t(params9[:, 3:6], dtype, device))}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cameras_to_bal(cameras) -> np.ndarray:
    """Batched camera pytree → (n_cams, 9) BAL parameter rows."""
    q = _np(cameras["pose"].rotation.wxyz).astype(np.float64)
    t = _np(cameras["pose"].translation).astype(np.float64)
    intr = _np(cameras["intr"]).astype(np.float64)
    return np.concatenate([_wxyz_to_axis_angle(q), t, intr], axis=1)


def _to_point_major(cam_i: np.ndarray, pt_i: np.ndarray, xy: np.ndarray,
                    n_pts: int, K: int | None, dtype, device):
    """Observation triplets → point-major padded (obs, cam_idx, mask)."""
    order = np.argsort(pt_i, kind="stable")
    cam_i, pt_i, xy = cam_i[order], pt_i[order], xy[order]
    counts = np.bincount(pt_i, minlength=n_pts)
    kmax = int(counts.max()) if len(counts) else 0
    if K is None:
        K = kmax
    elif kmax > K:
        raise ValueError(f"K={K} < densest landmark's {kmax} observations")
    slot = np.arange(len(pt_i)) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[pt_i]
    cam_idx = np.zeros((n_pts, K), np.int32)
    mask = np.zeros((n_pts, K), np.float64)
    obs = np.zeros((n_pts, K, 2), np.float64)
    cam_idx[pt_i, slot] = cam_i
    mask[pt_i, slot] = 1.0
    obs[pt_i, slot] = xy
    return (_t(obs, dtype, device),
            torch.as_tensor(cam_idx, device=device),
            _t(mask, dtype, device))


def load_bal(path: str, dtype=torch.float64, K: int | None = None,
             layout: str = "padded", bucket_growth: float = 2.0,
             min_bucket: int = 256, device="cuda"):
    """Read a BAL problem file into the point-major layout.

    Format (grail.cs.washington.edu/projects/bal): a header ``n_cams n_pts
    n_obs``, then ``n_obs`` lines ``cam_idx pt_idx x y``, then ``9·n_cams``
    camera parameters (angle-axis rotation, translation, f, k1, k2) and
    ``3·n_pts`` point coordinates.  ``.bz2`` paths are decompressed
    transparently; parsing is one vectorized numpy pass.

    ``layout="padded"`` returns ``((obs, cam_idx, mask), x0)`` for
    :func:`tinyopt_tpu_torch.schur_sparse_optimize`: one slab padded to
    ``K`` (default: the densest landmark's count; raises if capped below
    it).  Published BAL visibility is heavy-tailed (a few observations a
    landmark, hundreds for the densest), so that slab is mostly padding:
    ``layout="bucketed"`` returns ``(slabs, x0)`` for
    :func:`tinyopt_tpu_torch.schur_sparse_optimize_buckets` instead, the
    landmarks grouped by observation count into padded slabs whose caps
    grow by ``bucket_growth`` (``ops.schur_obs.bucket_caps``; buckets under
    ``min_bucket`` points merge), each slab ``(obs, cam_idx, mask, ids)``
    built straight from the observation triplets, never through an (n_pts,
    K_max) array.  ``x0 = (cameras, points)`` in the file's order for both
    layouts."""
    if layout not in ("padded", "bucketed"):
        raise ValueError(f"layout must be padded|bucketed, got {layout!r}")
    cam_i, pt_i, xy, params9, pts = _parse_bal(path)
    n_pts = pts.shape[0]
    x0 = (cameras_from_bal(params9, dtype, device), _t(pts, dtype, device))
    if layout == "padded":
        return _to_point_major(cam_i, pt_i, xy, n_pts, K, dtype, device), x0
    from ..ops.schur_obs import bucket_caps
    cap_of, used = bucket_caps(np.bincount(pt_i, minlength=n_pts),
                               bucket_growth, min_bucket)
    cap_of_rows = cap_of[pt_i]
    slabs = []
    for cap in used:
        ids = np.nonzero(cap_of == cap)[0]
        sel = cap_of_rows == cap
        slabs.append(_to_point_major(
            cam_i[sel], np.searchsorted(ids, pt_i[sel]), xy[sel], len(ids),
            cap, dtype, device) + (ids,))
    return slabs, x0


def _parse_bal(path: str):
    """Parse a BAL text file → (cam_i, pt_i, xy, params9, pts) numpy, one
    ``np.fromstring(..., sep=" ")`` over the whole token stream (every BAL
    token is a plain decimal; the indices round-trip exactly through
    float64)."""
    if str(path).endswith(".bz2"):
        import bz2
        opener = bz2.open
    else:
        opener = open
    with opener(path, "rt") as fh:
        text = fh.read()
    import warnings
    try:
        with warnings.catch_warnings():
            # the binary mode of np.fromstring is deprecated; its text mode
            # (sep set) is not, but some numpy versions warn on any use
            warnings.simplefilter("ignore", DeprecationWarning)
            vals = np.fromstring(text, dtype=np.float64, sep=" ")
    except (AttributeError, ValueError):
        # np.fromstring may be removed in a later numpy
        vals = np.array(text.split(), dtype=np.float64)
    del text
    n_cams, n_pts, n_obs = int(vals[0]), int(vals[1]), int(vals[2])
    expect = 3 + 4 * n_obs + 9 * n_cams + 3 * n_pts
    if vals.size != expect:
        raise ValueError(
            f"malformed BAL file: header says {n_cams} cams / {n_pts} "
            f"pts / {n_obs} obs = {expect} tokens, found {vals.size}")
    tri = vals[3:3 + 4 * n_obs].reshape(n_obs, 4)
    cam_i = tri[:, 0].astype(np.int64)
    pt_i = tri[:, 1].astype(np.int64)
    xy = np.ascontiguousarray(tri[:, 2:4])
    off = 3 + 4 * n_obs
    params9 = vals[off:off + 9 * n_cams].reshape(n_cams, 9)
    pts = vals[off + 9 * n_cams:].reshape(n_pts, 3)
    return cam_i, pt_i, xy, params9, pts


def write_bal(path: str, cameras, points, obs, cam_idx, mask) -> None:
    """Write a point-major problem as a BAL-format text file."""
    cam_idx = _np(cam_idx)
    mask_np = _np(mask)
    obs_np = _np(obs).astype(np.float64)
    pts = _np(points).astype(np.float64)
    rows = []
    for j in range(cam_idx.shape[0]):
        for k in range(cam_idx.shape[1]):
            if mask_np[j, k]:
                rows.append((cam_idx[j, k], j, obs_np[j, k, 0],
                             obs_np[j, k, 1]))
    params9 = cameras_to_bal(cameras)
    with open(path, "w") as fh:
        fh.write(f"{params9.shape[0]} {pts.shape[0]} {len(rows)}\n")
        for c, j, x, y in rows:
            fh.write(f"{int(c)} {int(j)} {float(x)!r} {float(y)!r}\n")
        for v in params9.reshape(-1):
            fh.write(f"{float(v)!r}\n")
        for v in pts.reshape(-1):
            fh.write(f"{float(v)!r}\n")


def _slot_project(cameras, points, cam_idx):
    """(n_pts, K, 2): every point through each camera of its slots."""
    cam = torch.as_tensor(cam_idx).long()
    n_pts, K = cam.shape
    cams = pytree.tree_map(lambda l: l[cam.reshape(-1)], cameras)
    pts = points[:, None, :].expand(n_pts, K, 3).reshape(n_pts * K, 3)
    return torch.func.vmap(bal_project)(cams, pts).reshape(n_pts, K, 2)


def make_bal_problem(n_cams: int = 12, n_pts: int = 120, k_obs: int = 4,
                     noise: float = 0.0, outlier_frac: float = 0.0,
                     pose_noise: float = 0.005, point_noise: float = 0.01,
                     intr_noise: float = 0.0, dtype=torch.float64,
                     seed: int = 0, device="cuda"):
    """Synthetic BAL-convention instance (a corridor rig viewing −z).

    Cameras sit on a rail along +x looking down −z at a slab of landmarks;
    the intrinsics vary by camera (f ~ 500 ± 50 px, mild k1 / k2) so the
    distortion parameters are observable.  ``outlier_frac`` replaces that
    fraction of the observations with gross uniform garbage, drawn from a
    dedicated generator so the clean instance of the same seed is the
    exact counterpart.  Returns ``((obs, cam_idx, mask), x0, x_true,
    outliers)`` with x0 / x_true = (cameras pytree, points (n_pts, 3)) and
    ``outliers`` the (n_pts, k_obs) bool slot-corruption mask.  Camera 0
    and point 0 are not perturbed in x0 (gauge)."""
    rng = np.random.default_rng(seed)
    rail = 0.5 * np.arange(n_cams)
    px = rng.uniform(rail[0], rail[-1] if n_cams > 1 else 1.0, n_pts)
    py = rng.uniform(-1.0, 1.0, n_pts)
    pz = rng.uniform(-5.0, -3.0, n_pts)          # in FRONT = −z in BAL
    true_points = np.stack([px, py, pz], 1)

    aa = np.zeros((n_cams, 3))                   # identity rotations
    t = np.stack([-rail, np.zeros(n_cams), np.zeros(n_cams)], 1)
    f = 500.0 + 50.0 * rng.standard_normal(n_cams)
    k1 = 1e-2 * rng.standard_normal(n_cams)
    k2 = 1e-3 * rng.standard_normal(n_cams)
    params9 = np.concatenate([aa, t, f[:, None], k1[:, None], k2[:, None]],
                             axis=1)
    true_cams = cameras_from_bal(params9, dtype, device)
    true_pts = _t(true_points, dtype, device)

    nearest = np.clip(np.searchsorted(rail, px), 0, n_cams - 1)
    lo = np.clip(nearest - k_obs // 2, 0, max(n_cams - k_obs, 0))
    cam_idx = (lo[:, None] + np.arange(k_obs)[None, :]).astype(np.int32)

    obs = _np(_slot_project(true_cams, true_pts, cam_idx)).astype(
        np.float64)
    obs += noise * rng.standard_normal(obs.shape)
    bad = np.zeros(obs.shape[:2], bool)
    if outlier_frac > 0.0:
        rng_o = np.random.default_rng(seed + 10_007)
        bad = rng_o.uniform(size=obs.shape[:2]) < outlier_frac
        scale = np.abs(obs).max()
        obs = np.where(bad[..., None],
                       rng_o.uniform(-2 * scale, 2 * scale, obs.shape), obs)
    mask = torch.ones((n_pts, k_obs), dtype=dtype, device=device)

    # perturbed start, camera 0 / point 0 anchored (gauge)
    dw = pose_noise * rng.standard_normal((n_cams, 6))
    dw[0] = 0.0
    x0_pose = SE3.exp(_t(dw, dtype, device)) @ true_cams["pose"]
    di = np.zeros((n_cams, 3))
    if intr_noise:
        di = intr_noise * rng.standard_normal((n_cams, 3)) \
            * np.array([100.0, 0.02, 0.002])
        di[0] = 0.0
    dp = point_noise * rng.standard_normal((n_pts, 3))
    dp[0] = 0.0
    x0 = ({"intr": true_cams["intr"] + _t(di, dtype, device),
           "pose": x0_pose}, true_pts + _t(dp, dtype, device))
    return ((_t(obs, dtype, device), torch.as_tensor(cam_idx, device=device),
             mask), x0, (true_cams, true_pts),
            torch.as_tensor(bad, device=device))


def bal_rmse(cameras, points, obs, cam_idx, mask) -> torch.Tensor:
    """Reprojection RMSE (pixels) in the point-major layout."""
    r = (_slot_project(cameras, points, cam_idx) - obs) * mask[..., None]
    n = torch.clamp(torch.sum(mask) * 2.0, min=1.0)
    return torch.sqrt(torch.sum(r * r) / n)
