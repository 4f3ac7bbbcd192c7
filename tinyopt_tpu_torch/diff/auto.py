"""Automatic differentiation of residual functions (``torch.func``).

Counterpart of ``tinyopt_tpu.diff.auto``: the residual function of ONE
instance is differentiated on its tangent space, as δ ↦ r(x ⊞ δ) at δ = 0
(``manifold.retract_flat``: ``x + δ`` for Euclidean parameters), with
``torch.func.jacfwd``, and mapped over the leading instance axis with
``torch.func.vmap``.  ``make_nlls_system`` returns batched
``accumulate(x) -> (H, g, Cost)`` and ``evaluate(x) -> Cost`` closures over
flat (B, P) parameters for the optimizer loop; H is (B, D, D) and g
(B, D).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost


def flatten_residuals(res) -> torch.Tensor:
    """Flatten a residual pytree into one 1-D vector (row-major per leaf)."""
    leaves = pytree.tree_leaves(res)
    if not leaves:
        return torch.zeros((0,))
    flat = [torch.reshape(torch.as_tensor(l), (-1,)) for l in leaves]
    return flat[0] if len(flat) == 1 else torch.cat(flat)


def residual_jacobian(residual_fn, x, spec: mf.TangentSpec | None = None):
    """(residuals, J) of ``residual_fn`` at one instance ``x``, with J of
    shape (num_residuals, tangent_dims) the Jacobian of δ ↦ r(x ⊞ δ) at
    δ = 0 — ``diff::CalculateJac``."""
    if spec is None:
        spec = mf.tangent_spec(x)
    xv = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x), spec)[0]

    def r_of_delta(delta):
        r = flatten_residuals(residual_fn(
            mf.unflatten(mf.retract_flat(xv, delta, spec), spec)))
        return r, r

    J, r = torch.func.jacfwd(r_of_delta, has_aux=True)(
        torch.zeros((spec.dims,), dtype=xv.dtype, device=xv.device))
    return r, J


def instance_residuals(residual_fn, spec: mf.TangentSpec, has_data: bool):
    """``r(xv[, data]) -> (n_res,)`` of one instance on flat parameters
    (P,)."""
    if has_data:
        def r1(xv, data):
            return flatten_residuals(
                residual_fn(mf.unflatten(xv, spec), data)).to(spec.dtype)
    else:
        def r1(xv):
            return flatten_residuals(
                residual_fn(mf.unflatten(xv, spec))).to(spec.dtype)
    return r1


def num_residuals(residual_fn, x_example, data_example=None) -> int:
    """Residual count of one instance (evaluated once on the example)."""
    out = (residual_fn(x_example) if data_example is None
           else residual_fn(x_example, data_example))
    return int(flatten_residuals(out).numel())


def make_nlls_system(residual_fn, x_example, spec: mf.TangentSpec,
                     data_batch=None, data_example=None):
    """Batched (accumulate, evaluate, n_res) for the NLLS path.

    accumulate(x) -> (H, g, Cost) with H = JᵀJ (B, D, D), g = JᵀR (B, D)
    and cost = ‖r‖² (reference: diff/optimize_autodiff.h:149-164), for flat
    parameters x (B, P), J the tangent Jacobian of δ ↦ r(x ⊞ δ) at
    δ = 0.  evaluate(x) computes the cost only.  With
    ``data_batch``, ``residual_fn(x, data)`` receives each instance's data.
    """
    has_data = data_batch is not None
    n_res = num_residuals(residual_fn, x_example, data_example)
    r1 = instance_residuals(residual_fn, spec, has_data)

    def r_aux(delta, xv, *data):
        r = r1(mf.retract_flat(xv, delta, spec), *data)
        return r, r

    jac = torch.func.vmap(torch.func.jacfwd(r_aux, has_aux=True))
    res = torch.func.vmap(r1)
    extra = (data_batch,) if has_data else ()

    def accumulate(x):
        zero = torch.zeros((x.shape[0], spec.dims), dtype=x.dtype,
                           device=x.device)
        J, r = jac(zero, x, *extra)
        g = torch.matmul(J.mT, r[..., None])[..., 0]
        H = torch.matmul(J.mT, J)
        return H, g, Cost.make(torch.sum(r * r, dim=-1), n_res)

    def evaluate(x):
        r = res(x, *extra)
        return Cost.make(torch.sum(r * r, dim=-1), n_res)

    return accumulate, evaluate, n_res
