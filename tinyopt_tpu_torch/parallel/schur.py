"""Mesh-sharded Schur-complement bundle adjustment (dense observation grid).

Counterpart of ``tinyopt_tpu.parallel.schur``.  One bipartite problem is
split over a mesh axis by its LANDMARK axis (the grid's axis 1):

* each rank holds its landmark columns of the observation grid and
  computes their linearization, C / E blocks and g_b;
* the camera-side partials (Ba, g_a, cost) are completed by ONE all-reduce,
  and so are the reduced camera system's partials (E C⁻¹ Eᵀ, E C⁻¹ g_b):
  the only cross-landmark sums of the algebra;
* the (n_a·da)² reduced solve runs replicated on every rank, and the
  landmark back-substitutions are gathered, so the loop's x, g and steps
  are whole on every rank and its accept / reject never parts.

LM, GN and DogLeg (gᵀHg by an arrow matvec completed over the axis).  The
trajectory is the unsharded ``schur_optimize``'s up to the order of the
sums.  n_b must be divisible by the axis: pad with mask-0 landmarks.
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
from ..ops.schur import (SchurSystem, _einsum, _schur_propose,
                         bipartite_perms, blocks_from, linearize_grid,
                         schur_eliminate)
from ._collectives import (all_gather, gather_rows, local_rows, on_device,
                           psum, row_range)


def _divisible(n_b: int, mesh, axis, pad: str) -> None:
    if n_b % mesh.size(axis) != 0:
        raise ValueError(
            f"n_b={n_b} not divisible by mesh axis '{axis}'="
            f"{mesh.size(axis)}; pad the landmark axis with mask=0 {pad}")


def make_sharded_schur_system(pair_fn: Callable, a0, b0, data, mask, mesh,
                              axis, spec: mf.TangentSpec):
    """Landmark-sharded ``(accumulate, evaluate, n_res, make_propose)`` over
    flat parameters (1, P), the contract of ``ops.schur.schur_system`` for
    one instance: ``data`` leaves are the global (n_a, n_b, ...) grid and
    ``mask`` (n_a, n_b); this rank keeps its landmark columns.  The
    ``SchurSystem`` the loop carries holds this rank's C and E only."""
    a0, b0 = mf.as_pytree(a0), mf.as_pytree(b0)
    n_a = pytree.tree_leaves(a0)[0].shape[0]
    n_b = pytree.tree_leaves(b0)[0].shape[0]
    a_ex = pytree.tree_map(lambda l: l[0], a0)
    b_ex = pytree.tree_map(lambda l: l[0], b0)
    spec_a, spec_b = mf.tangent_spec(a_ex), mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype
    dev = mesh.device
    _divisible(n_b, mesh, axis, "columns (masked pairs contribute zero "
               "residual and zero Jacobian)")
    r0, r1 = row_range(n_b, mesh, axis)
    mask = torch.as_tensor(mask)
    data_l = pytree.tree_map(lambda l: l[None],
                             local_rows(data, r0, r1, 1, dev))
    mask_l = mask[None, :, r0:r1].to(dev, dtype)
    d_ex = pytree.tree_map(lambda l: torch.as_tensor(l)[0, 0], data)
    m = int(flatten_residuals(pair_fn(a_ex, b_ex, d_ex)).numel())
    n_res = torch.full((1,), int(torch.count_nonzero(mask)) * m,
                       dtype=torch.int32, device=dev)
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db, dev)

    def to_em(v):
        return v if gl2em is None else v[..., gl2em]

    def to_gl(v):
        return v if em2gl is None else v[..., em2gl]

    def split(x):
        a, b = mf.unflatten(x, spec)
        return a, pytree.tree_map(lambda l: l[:, r0:r1], b)

    def parts(v):
        """(v_a (.., n_a, da), this rank's v_b rows) of a global vector."""
        v = to_em(v)
        lead = tuple(v.shape[:-1])
        return (v[..., :n_a * da].reshape(lead + (n_a, da)),
                v[..., n_a * da:].reshape(lead + (n_b, db))[..., r0:r1, :])

    def whole(v_a, v_b_l):
        return to_gl(torch.cat([v_a.flatten(-2), all_gather(
            v_b_l, mesh, axis, dim=-2).flatten(-2)], dim=-1))

    def accumulate(x):
        a, b_l = split(x)
        r, Ja, Jb = linearize_grid(pair_fn, a, b_l, data_l, mask_l, spec_a,
                                   spec_b, dtype)
        Ba_p, C_l, E_l, ga_p, gb_l, rss_p = blocks_from(r, Ja, Jb, dtype)
        Ba, g_a, rss = psum((Ba_p, ga_p, rss_p), mesh, axis)
        return (SchurSystem(Ba, C_l, E_l, em2gl, gl2em), whole(g_a, gb_l),
                Cost.make(rss, n_res))

    def evaluate(x):
        a, b_l = split(x)

        def instance(a, b, data, mask):
            def cam(a_i, d_i, m_i):
                return torch.func.vmap(
                    lambda b_j, d_ij, m_ij: flatten_residuals(
                        pair_fn(a_i, b_j, d_ij)).to(dtype) * m_ij)(
                            b, d_i, m_i)
            return torch.func.vmap(cam)(a, data, mask)

        r = torch.func.vmap(instance)(a, b_l, data_l, mask_l)
        (rss,) = psum([torch.sum(r * r, dim=(-3, -2, -1))], mesh, axis)
        return Cost.make(rss, n_res)

    def eliminate(H: SchurSystem, Bd, Cd_l, g, use_cholesky=True, refine=0,
                  cg_iters=0):
        """(dx, ok), replicated: the reduced system's partials completed
        over the axis, the landmark steps gathered (a non-finite one on any
        rank fails ok on all)."""
        g_a, g_b_l = parts(g)
        dx_a, dx_b_l, ok = schur_eliminate(
            H.E, Bd, Cd_l, g_a, g_b_l, use_cholesky=use_cholesky,
            reduce_fn=lambda t: psum([t], mesh, axis)[0], refine=refine,
            cg_iters=cg_iters)
        dx = whole(dx_a, dx_b_l)
        return dx, ok & torch.all(torch.isfinite(dx), dim=-1)

    def matvec(H: SchurSystem, v):
        """H·v, replicated, from this rank's blocks."""
        v_a, v_b_l = parts(v)
        (Ev,) = psum([_einsum("ijab,jb->ia", H.E, v_b_l)], mesh, axis)
        o_a = _einsum("iab,ib->ia", H.Ba, v_a) + Ev
        o_b_l = (_einsum("jab,jb->ja", H.C, v_b_l)
                 + _einsum("ijab,ia->jb", H.E, v_a))
        return whole(o_a, o_b_l)

    propose = _schur_propose(eliminate, matvec)

    def make_propose(opts: Options):
        return lambda H, g, lam, _opts: propose(H, g, lam, opts)

    return accumulate, evaluate, n_res, make_propose


def _check_pair(x0, name: str) -> tuple:
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError(f"{name} needs x0 = (a0, b0)")
    return x0


def sharded_schur_optimize(x0: tuple, pair_fn: Callable, data, mask,
                           options: Options | None = None, *, mesh=None,
                           axis="block"):
    """Landmark-sharded Schur BA over the mesh: ``((a, b), Output)``.

    The contract of ``sparse.schur_optimize`` — the same pair_fn / data /
    mask, Output semantics and trajectory up to the order of the sums.
    Every rank passes the same global inputs and returns the same result;
    ``Output.final_hessian`` is the whole ``SchurSystem``."""
    from ..sparse import _batch_of_one, _batch_tree
    from .mesh import local_mesh

    options = options or Options()
    if mesh is None:
        mesh = local_mesh(axis)
    a0, b0 = _check_pair(x0, "sharded_schur_optimize")
    x0 = tuple(on_device(mf.as_pytree(t), mesh.device) for t in (a0, b0))
    spec = mf.tangent_spec(x0)
    acc, ev, _, make_propose = make_sharded_schur_system(
        pair_fn, x0[0], x0[1], data, mask, mesh, axis, spec)
    x, out = optimize_from_acc(mf.flatten_batch(_batch_tree(x0), spec), acc,
                               ev, options, spec,
                               propose=make_propose(options))
    H = out.final_hessian
    if H is not None:
        n_b = pytree.tree_leaves(x0[1])[0].shape[0]
        C, E = gather_rows([H.C, H.E], slice(*row_range(n_b, mesh, axis)),
                           n_b, mesh, axis, dim=-3)
        out.final_hessian = SchurSystem(H.Ba, C, E, H.em2gl, H.gl2em)
    return _batch_of_one(x, out, spec)
