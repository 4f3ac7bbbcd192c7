"""Differentiable solves: implicit differentiation of the optimum.

Counterpart of ``tinyopt_tpu.implicit``: ``θ ↦ x*(θ) = argmin_x
‖r(x, θ)‖²`` made differentiable WITHOUT backpropagating through the
iterations.  At the optimum g(x*, θ) = J(x*, θ)ᵀ r(x*, θ) = 0, and the
implicit function theorem gives dx*/dθ = −H⁻¹ ∂g/∂θ with H ≈ JᵀJ
(Gauss-Newton), so the vector–Jacobian product of a cotangent v is
−(∂g/∂θ)ᵀ λ with (JᵀJ) λ = v: one linear solve and one reverse pass
through g, whatever the iteration count.

The solve is a ``torch.autograd.Function``: its forward is the port's
batched solve (the batch-native loop, no graph recorded), its backward
the solve for λ and ``torch.func.vjp`` of the batched g in θ.  Where the
solve for λ is not finite (a rank-deficient H) an instance takes the
minimum-norm least-squares λ (the pseudo-inverse), the JAX function's
rule.  x0 receives a zero gradient.  Parameters must be Euclidean (no
registered manifold leaf: the cotangent would need the tangent-space
pullback); θ is a tensor or a pytree of tensors.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .diff.auto import flatten_residuals
from .optimize import build_batch_solver
from .options import Options


def implicit_solver(residual_fn: Callable, options: Options | None = None,
                    *, x_example=None, batched: bool = False):
    """Build a differentiable solve ``(theta, x0) -> x_opt``.

    ``residual_fn(x, theta)`` returns one instance's residual pytree.
    With ``batched=True`` every tensor of ``theta`` and ``x0`` has a
    leading instance axis and so has ``x_opt``; otherwise each is one
    instance (a batch of one inside).  Gradients flow to ``theta`` by the
    implicit function theorem.  θ's structure is read at each call; the
    batched solver is built once for each structure, leaf shape and type.
    """
    options = options or Options()
    if x_example is None:
        raise ValueError("x_example is required")
    x_example = mf.as_pytree(x_example)
    spec = mf.tangent_spec(x_example)
    if spec.has_manifold:
        raise NotImplementedError(
            "implicit_solver supports Euclidean parameter pytrees only")

    def r_of_delta(xv, theta):
        """δ ↦ r(x ⊞ δ, θ) of one instance."""
        return lambda delta: flatten_residuals(residual_fn(
            mf.unflatten(mf.retract_flat(xv, delta, spec), spec),
            theta)).to(spec.dtype)

    def g_one(xv, theta):
        """g(x, θ) = JᵀR of one instance on the tangent space."""
        r, vjp_fn = torch.func.vjp(r_of_delta(xv, theta),
                                   torch.zeros_like(xv))
        return vjp_fn(r)[0]

    def jac_one(xv, theta):
        return torch.func.jacfwd(r_of_delta(xv, theta))(torch.zeros_like(xv))

    built = {}

    def batch_solver(theta_def, theta_leaves):
        """The forward's solver, built at the first call with this θ."""
        key = (theta_def, tuple((t.shape[1:], t.dtype, t.device)
                                for t in theta_leaves))
        if key not in built:
            theta = mf.tree_unflatten_sorted(list(theta_leaves), theta_def)
            theta_ex = pytree.tree_map(lambda a: a[0], theta)
            built[key] = build_batch_solver(residual_fn, options, "residuals",
                                            x_example, theta_ex)
        return built[key]

    def make_function(theta_def):
        class _ImplicitSolve(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x0_flat, *theta_leaves):
                theta = mf.tree_unflatten_sorted(list(theta_leaves), theta_def)
                solve = batch_solver(theta_def, theta_leaves)
                with torch.no_grad():
                    x_opt, _ = solve(mf.unflatten(x0_flat, spec), theta)
                x_opt = mf.flatten_batch(x_opt, spec).detach()
                ctx.save_for_backward(x_opt, *theta_leaves)
                return x_opt

            @staticmethod
            def backward(ctx, v):
                x_opt, *theta_leaves = ctx.saved_tensors
                theta = mf.tree_unflatten_sorted(theta_leaves, theta_def)
                J = torch.func.vmap(jac_one)(x_opt, theta)
                H = torch.matmul(J.mT, J)
                v = v.to(spec.dtype)
                lam = torch.linalg.solve_ex(H, v)[0]
                bad = ~torch.all(torch.isfinite(lam), dim=-1)
                if bool(bad.any()):
                    # rank-deficient H: the minimum-norm least-squares λ
                    lam_ls = torch.matmul(torch.linalg.pinv(H),
                                          v[..., None])[..., 0]
                    lam = torch.where(bad[:, None], lam_ls, lam)

                def g_all(*leaves):
                    th = mf.tree_unflatten_sorted(list(leaves), theta_def)
                    return torch.func.vmap(g_one)(x_opt, th)

                _, vjp_fn = torch.func.vjp(g_all, *theta_leaves)
                theta_bar = vjp_fn(lam)
                return (torch.zeros_like(x_opt),
                        *(-t for t in theta_bar))

        return _ImplicitSolve

    def solve(theta, x0):
        x0 = mf.as_pytree(x0)
        if not batched:
            theta = pytree.tree_map(lambda a: torch.as_tensor(a)[None], theta)
            x0 = pytree.tree_map(lambda a: a[None], x0)
        leaves, theta_def = mf.tree_flatten_sorted(theta)
        fn = make_function(theta_def)
        x_opt = mf.unflatten(fn.apply(mf.flatten_batch(x0, spec), *leaves),
                             spec)
        return x_opt if batched else pytree.tree_map(lambda a: a[0], x_opt)

    return solve
