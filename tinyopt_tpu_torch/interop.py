"""Carry state across from the JAX package without importing JAX.

``options_from_reference`` copies any ``tinyopt_tpu.Options`` (or any
dataclass with its fields) into this package's ``Options``, nested option
groups and the solver-type enum included.  ``prior_problem_from_numpy``,
``so3_from_numpy``, ``se3_from_numpy``, ``se23_from_numpy``,
``sen3_from_numpy``, ``se3_refinement_data_from_numpy``,
``icp_problem_from_numpy``, ``ba_problem_from_numpy``,
``bal_cameras_from_numpy`` and ``pose_graph_data_from_numpy`` build the
port's problems and poses from host arrays, e.g. the ones a JAX
``PriorProblem``, ``SO3``, ``SE3``, ``SE23``, ``SEn3``, ``ICPProblem``,
bundle-adjustment problem, BAL camera pytree or ``PoseGraphData`` holds
after ``np.asarray``;
``perceptron_from_numpy`` the perceptron's parameter dict
(``models/nn.py``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import options as _opt
from .manifolds import SE3, SE23, SO3, SEn3
from .models.bundle_adjustment import BAData
from .models.icp import ICPProblem
from .models.pose_graph import PoseGraphData
from .models.problems import PriorProblem
from .models.se3_refinement import SE3RefinementData

_NESTED = {
    "hessian": _opt.HessianOptions, "cost": _opt.CostScalingOptions,
    "log": _opt.LogOptions, "lm": _opt.LMOptions, "gd": _opt.GDOptions,
    "sgd": _opt.SGDOptions, "adam": _opt.AdamOptions,
    "lbfgs": _opt.LBFGSOptions,
}


def _copy(cls, obj):
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(obj, f.name):
            continue
        v = getattr(obj, f.name)
        if f.name in _NESTED and dataclasses.is_dataclass(v):
            v = _copy(_NESTED[f.name], v)
        elif isinstance(v, enum.Enum):
            v = _opt.SolverType[v.name]
        kw[f.name] = v
    return cls(**kw)


def options_from_reference(obj) -> _opt.Options:
    """Copy a reference ``Options`` (any dataclass with its fields) into
    ``tinyopt_tpu_torch.Options``; fields it lacks keep their defaults."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected an Options dataclass, got {type(obj)}")
    return _copy(_opt.Options, obj)


def prior_problem_from_numpy(y, inv_std, device="cuda",
                             dtype=torch.float32) -> PriorProblem:
    """``PriorProblem`` on ``device`` (the card unless the caller asks for
    another) from host arrays (B, d)."""
    return PriorProblem(
        y=torch.as_tensor(np.asarray(y), dtype=dtype, device=device),
        inv_std=torch.as_tensor(np.asarray(inv_std), dtype=dtype,
                                device=device))


def perceptron_from_numpy(params, device="cuda",
                          dtype=torch.float32) -> dict:
    """The perceptron's parameters ``{"W", "b"}`` (inserted in sorted key
    order, the JAX package's layout) on ``device`` from a mapping of host
    arrays, e.g. ``tinyopt_tpu.models.nn.init_perceptron``'s."""
    return {k: _tensor(params[k], device, dtype) for k in sorted(params)}


def _tensor(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def so3_from_numpy(wxyz, device="cuda", dtype=torch.float32) -> SO3:
    """``SO3`` on ``device`` from host quaternions (..., 4), scalar first."""
    return SO3(_tensor(wxyz, device, dtype))


def se3_from_numpy(wxyz, translation, device="cuda",
                   dtype=torch.float32) -> SE3:
    """``SE3`` on ``device`` from host quaternions (..., 4) and
    translations (..., 3)."""
    return SE3(so3_from_numpy(wxyz, device, dtype),
               _tensor(translation, device, dtype))


def se3_refinement_data_from_numpy(points, targets, device="cuda",
                                   dtype=torch.float32) -> SE3RefinementData:
    """``SE3RefinementData`` on ``device`` from host arrays (..., K, 3)."""
    return SE3RefinementData(points=_tensor(points, device, dtype),
                             targets=_tensor(targets, device, dtype))


def se23_from_numpy(wxyz, velocity, position, device="cuda",
                    dtype=torch.float32) -> SE23:
    """``SE23`` on ``device`` from host quaternions (..., 4), velocities
    (..., 3) and positions (..., 3)."""
    return SE23(so3_from_numpy(wxyz, device, dtype),
                _tensor(velocity, device, dtype),
                _tensor(position, device, dtype))


def sen3_from_numpy(wxyz, vectors, device="cuda",
                    dtype=torch.float32) -> SEn3:
    """``SEn3`` on ``device`` from host quaternions (..., 4) and
    translational parts (..., n, 3)."""
    return SEn3(so3_from_numpy(wxyz, device, dtype),
                _tensor(vectors, device, dtype))


def icp_problem_from_numpy(src, dst, true_wxyz, true_translation,
                           device="cuda", dtype=torch.float32) -> ICPProblem:
    """``ICPProblem`` on ``device`` from host clouds src (..., N, 3), dst
    (..., M, 3) and the true pose's quaternion (..., 4) and translation
    (..., 3), e.g. a JAX ``make_icp_problem``'s."""
    return ICPProblem(src=_tensor(src, device, dtype),
                      dst=_tensor(dst, device, dtype),
                      true_pose=se3_from_numpy(true_wxyz, true_translation,
                                               device, dtype))


def ba_problem_from_numpy(data, poses_wxyz, poses_translation, points,
                          device="cuda", dtype=torch.float32):
    """A bundle-adjustment problem ``(data, x0)`` on ``device`` from host
    arrays, e.g. a JAX ``make_ba_problem``'s or ``make_ba_problem_sparse``'s
    after ``np.asarray``.

    ``data`` is the grid pair ``(observations, mask)``, which becomes a
    ``BAData``, or the point-major triple ``(obs, cam_idx, mask)``, whose
    ``cam_idx`` stays int32; the poses are quaternions (n_cams, 4) and
    translations (n_cams, 3), the points (n_pts, 3).  ``x0`` is
    ``{"points": ..., "poses": SE3}``, keys in the JAX package's (sorted)
    order."""
    if len(data) == 2:
        out = BAData(*(_tensor(a, device, dtype) for a in data))
    else:
        obs, cam_idx, mask = data
        out = (_tensor(obs, device, dtype),
               torch.as_tensor(np.array(cam_idx), dtype=torch.int32,
                               device=device),
               _tensor(mask, device, dtype))
    return out, {"points": _tensor(points, device, dtype),
                 "poses": se3_from_numpy(poses_wxyz, poses_translation,
                                         device, dtype)}


def bal_cameras_from_numpy(wxyz, translation, intr, device="cuda",
                           dtype=torch.float32) -> dict:
    """A batch of BAL cameras ``{"intr": (n, 3), "pose": SE3}``
    (``models/bal.py``; keys in the JAX package's sorted order) on
    ``device`` from host quaternions (n, 4), translations (n, 3) and
    intrinsics (f, k1, k2) (n, 3), e.g. a JAX ``cameras_from_bal``
    pytree's leaves after ``np.asarray``."""
    return {"intr": _tensor(intr, device, dtype),
            "pose": se3_from_numpy(wxyz, translation, device, dtype)}


def pose_graph_data_from_numpy(edges, meas_q, meas_t, anchor_q, anchor_t,
                               device="cuda",
                               dtype=torch.float32) -> PoseGraphData:
    """``PoseGraphData`` on ``device`` from host arrays, e.g. a JAX
    ``PoseGraphData``'s fields after ``np.asarray``: edges (E, 2) (int64
    here, JAX's int32), measured rotations (E, 4) and translations (E, 3),
    and pose 0's prior (4,) and (3,)."""
    return PoseGraphData(
        edges=torch.as_tensor(np.array(edges), dtype=torch.int64,
                              device=device),
        meas_q=_tensor(meas_q, device, dtype),
        meas_t=_tensor(meas_t, device, dtype),
        anchor_q=_tensor(anchor_q, device, dtype),
        anchor_t=_tensor(anchor_t, device, dtype))
