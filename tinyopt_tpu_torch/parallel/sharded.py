"""Residual-block sharding: normal equations summed over the mesh.

Counterpart of ``tinyopt_tpu.parallel.sharded``.  One large problem's
residual blocks are split over a mesh axis: each rank linearizes its
blocks (forward-mode ``torch.func`` on the tangent space) and sums its
partial (JᵀJ, JᵀR, cost); one all-reduce completes the three.  The outer
loop then runs replicated: every rank holds the same (H, g) and takes the
same steps, so the solve (K1 on the card with ``solver="cg"``) and the λ
schedule need no further communication.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost
from ..diff.auto import flatten_residuals
from ..optimizers.loop import optimize_from_acc
from ..options import Options
from ._collectives import local_rows, on_device, psum, row_range


def make_block_system(block_fn: Callable, data, x0, mesh, axis="block",
                      spec=None):
    """``(accumulate, evaluate, n_res)`` over flat parameters (B, P), each
    sum completed over ``axis``.

    ``block_fn(x, block_data) -> residuals`` evaluates one residual block;
    ``data`` is the global pytree, leaves with a leading block axis that
    the mesh axis divides; this rank keeps its rows.  Each block's Jacobian
    is taken on the tangent space and contracted at once: the full J never
    exists."""
    x0 = mf.as_pytree(x0)
    if spec is None:
        spec = mf.tangent_spec(x0)
    n_blocks = int(pytree.tree_leaves(data)[0].shape[0])
    axis_size = mesh.size(axis)
    if n_blocks % axis_size != 0:
        raise ValueError(
            f"n_blocks={n_blocks} not divisible by mesh axis "
            f"'{axis}'={axis_size}; pad the block axis")
    local = local_rows(data, *row_range(n_blocks, mesh, axis), 0,
                       mesh.device)
    dtype = spec.dtype

    def r_blk(xv, bd):
        return flatten_residuals(
            block_fn(mf.unflatten(xv, spec), bd)).to(dtype)

    n_res = n_blocks * int(r_blk(
        mf.flatten_batch(pytree.tree_map(lambda a: a[None], x0), spec)[0],
        pytree.tree_map(lambda a: a[0], local)).numel())

    def one(xv, bd):
        def r_aux(delta):
            r = r_blk(mf.retract_flat(xv, delta, spec), bd)
            return r, r
        J, r = torch.func.jacfwd(r_aux, has_aux=True)(
            torch.zeros((spec.dims,), dtype=dtype, device=xv.device))
        J = J.to(dtype)
        return J.mT @ J, J.mT @ r, torch.sum(r * r)

    per_block = torch.func.vmap(torch.func.vmap(one, in_dims=(None, 0)),
                                in_dims=(0, None))
    cost_blk = torch.func.vmap(torch.func.vmap(
        lambda xv, bd: torch.sum(r_blk(xv, bd) ** 2), in_dims=(None, 0)),
        in_dims=(0, None))

    def accumulate(x):
        Hs, gs, cs = per_block(x, local)
        H, g, c = psum((Hs.sum(1), gs.sum(1), cs.sum(1)), mesh, axis)
        return H, g, Cost.make(c, n_res)

    def evaluate(x):
        (c,) = psum([cost_blk(x, local).sum(1)], mesh, axis)
        return Cost.make(c, n_res)

    return accumulate, evaluate, n_res


def sharded_optimize(x0, block_fn: Callable, data,
                     options: Options | None = None, *, mesh=None,
                     axis="block"):
    """Solve one large blocked NLLS problem sharded over the mesh.

    Every rank passes the same global ``x0`` and ``data`` (leaves with a
    leading block axis) and gets the same ``(x_opt, Output)``."""
    from ..sparse import _batch_of_one
    from .mesh import local_mesh

    options = options or Options()
    if mesh is None:
        mesh = local_mesh(axis)
    x0 = on_device(mf.as_pytree(x0), mesh.device)
    spec = mf.tangent_spec(x0)
    acc, ev, _ = make_block_system(block_fn, data, x0, mesh, axis, spec)
    xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, options, spec)
    return _batch_of_one(x, out, spec)
