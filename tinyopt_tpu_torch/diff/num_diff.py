"""Numerical differentiation on manifold tangent spaces.

Counterpart of ``tinyopt_tpu.diff.num_diff`` (reference:
include/tinyopt/diff/num_diff.h:20-311): forward, central and fast-central
differences along the tangent basis, taken through the retraction
(``manifold.retract_flat``), so manifold leaves (SO3, SE3...) are
differenced on their tangent space.  The perturbed evaluations of a batch
are one ``torch.func.vmap`` call over (dims × B) parameter rows.

Default steps follow the reference's ``FloatEpsilon`` policy
(math.h:297-301): 1e-4 for float32, 1e-7 for float64.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost
from ..utils import float_epsilon
from .auto import instance_residuals, num_residuals


class Method(enum.Enum):
    """Finite-difference scheme (reference: diff/num_diff.h:20-52)."""

    #: (f(x ⊞ h·e) − f(x)) / h — first order, dims+1 evaluations.
    FORWARD = 0
    #: (f(x ⊞ h·e) − f(x ⊞ −h·e)) / 2h — second order, 2·dims evaluations.
    CENTRAL = 1
    #: (f(x⁺) − f(x⁺ ⊞ −2h·e)) / 2h with x⁺ = x ⊞ h·e: the minus point is
    #: reached by a second retraction from the plus point
    #: (reference: num_diff.h:42-51).
    FAST_CENTRAL = 2


# Reference-style aliases
kForward = Method.FORWARD
kCentral = Method.CENTRAL
kFastCentral = Method.FAST_CENTRAL


def default_step(dtype) -> float:
    """FloatEpsilon: 1e-4 (float32 and below) / 1e-7 (float64)."""
    return float_epsilon(dtype)


def _repeat(tree, n: int):
    """Every leaf of ``tree`` (leading axis B) stacked ``n`` times: (n·B, ...)."""
    return pytree.tree_map(
        lambda a: a.repeat(n, *([1] * (a.dim() - 1))), tree)


def batch_num_jac(res, x: torch.Tensor, spec: mf.TangentSpec,
                  method: Method = Method.CENTRAL, h: float | None = None,
                  data=None):
    """(r, J) of a batch by finite differences: ``res(x_rows[, data_rows])``
    maps flat parameters (N, P) to residuals (N, n); ``x`` is (B, P);
    r is (B, n) and J (B, n, dims), J[b, i, j] = ∂r_i/∂δ_j on the tangent
    space of instance b."""
    B, D = x.shape[0], spec.dims
    if h is None:
        h = default_step(spec.dtype)
    h = torch.tensor(h, dtype=spec.dtype, device=x.device)
    extra = () if data is None else (data,)
    r0 = res(x, *extra)
    # row j·B + b: instance b perturbed along tangent direction j
    steps = h * torch.eye(D, dtype=spec.dtype, device=x.device)
    steps = steps[:, None, :].expand(D, B, D).reshape(D * B, D)
    xs = x.repeat(D, 1)
    extra_d = () if data is None else (_repeat(data, D),)

    def at(xr):
        return res(xr, *extra_d).reshape(D, B, -1)

    x_plus = mf.retract_flat(xs, steps, spec)
    if method == Method.FORWARD:
        J = (at(x_plus) - r0[None]) / h
    elif method == Method.CENTRAL:
        J = (at(x_plus) - at(mf.retract_flat(xs, -steps, spec))) / (2.0 * h)
    elif method == Method.FAST_CENTRAL:
        J = (at(x_plus) - at(mf.retract_flat(x_plus, -2.0 * steps, spec))
             ) / (2.0 * h)
    else:
        raise ValueError(f"Unknown method {method!r}")
    return r0, J.permute(1, 2, 0)


def num_eval(f: Callable, x, method: Method = Method.CENTRAL,
             h: float | None = None, spec: mf.TangentSpec | None = None):
    """(residuals, J) of ``f`` at one instance ``x`` by finite differences,
    J (n_res, dims) on the tangent space (``diff::NumEval``, num_diff.h:
    57-124)."""
    x = mf.as_pytree(x)
    if spec is None:
        spec = mf.tangent_spec(x)
    xv = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x), spec)
    r, J = batch_num_jac(torch.func.vmap(instance_residuals(f, spec, False)),
                         xv, spec, method, h)
    return r[0], J[0]


def estimate_num_jac(f: Callable, x, method: Method = Method.CENTRAL,
                     h: float | None = None,
                     spec: mf.TangentSpec | None = None) -> torch.Tensor:
    """Jacobian only (reference: ``diff::EstimateNumJac``, num_diff.h:131)."""
    return num_eval(f, x, method, h, spec)[1]


def make_num_diff_system(residual_fn: Callable, x_example,
                         spec: mf.TangentSpec | None = None,
                         data_batch=None, data_example=None,
                         first_order: bool = False,
                         method: Method = Method.CENTRAL,
                         h: float | None = None):
    """Batched (accumulate, evaluate, n_res) by finite differences: the
    counterpart of ``diff.auto.make_nlls_system`` (the reference's
    ``CreateNumDiffFunc2``, grad and H = JᵀJ, num_diff.h:284-309; with
    ``first_order``, ``CreateNumDiffFunc1``, grad only, num_diff.h:198-221)
    over flat (B, P) parameters; ``residual_fn(x, data)`` with
    ``data_batch``."""
    if spec is None:
        spec = mf.tangent_spec(x_example)
    n_res = num_residuals(residual_fn, x_example, data_example)
    res = torch.func.vmap(instance_residuals(residual_fn, spec,
                                             data_batch is not None))
    extra = () if data_batch is None else (data_batch,)

    def accumulate(x):
        r, J = batch_num_jac(res, x, spec, method, h, data_batch)
        g = torch.matmul(J.mT, r[..., None])[..., 0]
        cost = Cost.make(torch.sum(r * r, dim=-1), n_res)
        if first_order:
            return None, g, cost
        return torch.matmul(J.mT, J), g, cost

    def evaluate(x):
        r = res(x, *extra)
        return Cost.make(torch.sum(r * r, dim=-1), n_res)

    return accumulate, evaluate, n_res
