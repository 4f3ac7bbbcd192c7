"""Automatic differentiation of residual functions (``torch.func``).

Counterpart of ``tinyopt_tpu.diff.auto``: the residual function of ONE
instance is differentiated on its tangent space, as δ ↦ r(x ⊞ δ) at δ = 0
(``manifold.retract_flat``: ``x + δ`` for Euclidean parameters), with
``torch.func.jacfwd``, and mapped over the leading instance axis with
``torch.func.vmap``.  ``make_nlls_system`` returns batched
``accumulate(x) -> (H, g, Cost)`` and ``evaluate(x) -> Cost`` closures over
flat (B, P) parameters for the optimizer loop; H is (B, D, D) and g
(B, D).  ``make_acc_system`` wraps a user's manual accumulation function
of one instance the same way, and ``make_cost_system`` a scalar cost (the
first-order solvers), differentiated in reverse mode.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost


def value_and_jacfwd(f, x: torch.Tensor):
    """Forward-mode value and Jacobian: ``(f(x), J)`` with J[..., j] =
    ∂f/∂x_j, the last axis over x's entries (``torch.func.jacfwd``, one jvp
    a basis vector, as the JAX package's vmap of ``jax.jvp``)."""
    return f(x), torch.func.jacfwd(f)(x)


def flatten_residuals(res) -> torch.Tensor:
    """Flatten a residual pytree into one 1-D vector (row-major per leaf,
    a dict's leaves by sorted key, as the JAX package)."""
    leaves = mf.tree_leaves_sorted(res)
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
    return r, J.to(r.dtype)     # see make_nlls_system


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
                     data_batch=None, data_example=None, print_J=False):
    """Batched (accumulate, evaluate, n_res) for the NLLS path.

    accumulate(x) -> (H, g, Cost) with H = JᵀJ (B, D, D), g = JᵀR (B, D)
    and cost = ‖r‖² (reference: diff/optimize_autodiff.h:149-164), for flat
    parameters x (B, P), J the tangent Jacobian of δ ↦ r(x ⊞ δ) at
    δ = 0.  evaluate(x) computes the cost only.  With
    ``data_batch``, ``residual_fn(x, data)`` receives each instance's data.
    ``print_J=True`` prints each instance's J on every accumulation
    (``options.log.print_J_jet``, reference optimize_autodiff.h:158-161).
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
        # torch.func's forward mode gives a float64 tangent to a 0-d float32
        # tensor times a Python float (``x1 + 10.0 * x2`` of an unpacked
        # x), so J is cast to the parameters' type
        J = J.to(x.dtype)
        if print_J:
            for Jb in J.detach().cpu().numpy():
                print(f"J:{Jb}", flush=True)
        g = torch.matmul(J.mT, r[..., None])[..., 0]
        H = torch.matmul(J.mT, J)
        return H, g, Cost.make(torch.sum(r * r, dim=-1), n_res)

    def evaluate(x):
        r = res(x, *extra)
        return Cost.make(torch.sum(r * r, dim=-1), n_res)

    return accumulate, evaluate, n_res


def make_cost_system(cost_fn, x_example, spec: mf.TangentSpec,
                     data_batch=None, data_example=None):
    """Batched (accumulate, evaluate, n_res=1) of a scalar cost of one
    instance, for the first-order solvers.

    accumulate(x) -> (None, g, Cost): the gradient of δ ↦ c(x ⊞ δ) at
    δ = 0 by reverse mode (``torch.func.grad`` under ``torch.func.vmap``;
    one pass whatever the dimension), for flat parameters x (B, P).  A
    cost function whose output is not a scalar raises ``ValueError``, as
    in ``tinyopt_tpu.diff.auto.make_cost_system``."""
    out = (cost_fn(x_example) if data_example is None
           else cost_fn(x_example, data_example))
    leaves = pytree.tree_leaves(out)
    if leaves and any(torch.as_tensor(l).numel() != 1 for l in leaves):
        shapes = [tuple(torch.as_tensor(l).shape) for l in leaves]
        raise ValueError(
            "GradientDescent / first-order optimization requires a scalar "
            "cost function (reference: optimize.h:59-72); got non-scalar "
            f"output {shapes}. Use LM/GN for residual vectors.")
    has_data = data_batch is not None
    extra = (data_batch,) if has_data else ()

    def c1(xv, *data):
        return flatten_residuals(
            cost_fn(mf.unflatten(xv, spec), *data)).reshape(())

    def c_of_delta(delta, xv, *data):
        c = c1(mf.retract_flat(xv, delta, spec), *data)
        return c, c

    grad = torch.func.vmap(torch.func.grad(c_of_delta, has_aux=True))
    value = torch.func.vmap(c1)

    def accumulate(x):
        zero = torch.zeros((x.shape[0], spec.dims), dtype=x.dtype,
                           device=x.device)
        g, c = grad(zero, x, *extra)
        return None, g.to(spec.dtype), Cost.make(c, 1)

    def evaluate(x):
        return Cost.make(value(x, *extra), 1)

    return accumulate, evaluate, 1


def _as_cost(c) -> Cost:
    """A manual accumulation function's cost slot (a scalar, a (cost,
    num_residuals[, inlier_ratio]) tuple, or a Cost) as a Cost."""
    if isinstance(c, Cost):
        return c
    if isinstance(c, (tuple, list)):
        if len(c) in (2, 3):
            return Cost.make(torch.as_tensor(c[0]).reshape(()), *c[1:])
        raise ValueError(f"Cannot interpret cost tuple of length {len(c)}")
    return Cost.make(torch.as_tensor(c).reshape(()), 1)


def make_acc_system(acc_fn, x_example, spec: mf.TangentSpec,
                    first_order: bool, H_is_full: bool = True,
                    data_batch=None):
    """Batched (accumulate, evaluate, None) of a manual accumulation
    function of one instance, ``acc_fn(x[, data]) -> (cost_like, grad)``
    (first-order) or ``(cost_like, grad, H)`` — the functional form of the
    reference's ``Cost acc(x, grad&, H&)`` (optimizers/optimizer.h:114-131,
    docs/API.md:37-57), mapped over the batch with ``torch.func.vmap``.
    ``cost_like`` is a scalar, a (cost, num_residuals) pair or a Cost.

    With ``H_is_full=False`` the function may fill only the upper triangle
    of H: the strict lower part is ignored and rebuilt from it
    (gn.h:139-145, docs/API.md:170).
    """
    has_data = data_batch is not None
    extra = (data_batch,) if has_data else ()

    def one(xv, *data):
        out = acc_fn(mf.unflatten(xv, spec), *data)
        if not isinstance(out, (tuple, list)) or len(out) < 2:
            raise ValueError(
                "Manual acc function must return (cost, grad[, H]); got "
                f"{type(out)}")
        c = _as_cost(out[0])
        g = torch.as_tensor(out[1]).reshape(-1).to(spec.dtype)
        if first_order:
            return c.cost, c.num_residuals, c.inlier_ratio, g
        if len(out) < 3:
            raise ValueError("GN/LM require the acc function to also return "
                             "H (reference: optimize.h:40-76)")
        return (c.cost, c.num_residuals, c.inlier_ratio, g,
                torch.as_tensor(out[2]).to(spec.dtype))

    batched = torch.func.vmap(one)

    def accumulate(x):
        outs = batched(x, *extra)
        cost = Cost(*outs[:3])
        if first_order:
            return None, outs[3], cost
        H = outs[4]
        if not H_is_full:
            H = torch.triu(H) + torch.triu(H, 1).mT
        return H, outs[3], cost

    def evaluate(x):
        return accumulate(x)[2]

    return accumulate, evaluate, None
