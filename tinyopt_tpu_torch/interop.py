"""Carry state across from the JAX package without importing JAX.

``options_from_reference`` copies any ``tinyopt_tpu.Options`` (or any
dataclass with its fields) into this package's ``Options``, nested option
groups and the solver-type enum included.  ``prior_problem_from_numpy``
builds the port's ``PriorProblem`` from host arrays, e.g. the ones a JAX
``PriorProblem`` holds after ``np.asarray``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import options as _opt
from .models.problems import PriorProblem

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
