"""Schur-complement normal equations for bipartite NLLS (bundle
adjustment), batched.

Counterpart of ``tinyopt_tpu.ops.schur``.  Two parameter families A
(cameras) and B (landmarks), every residual block coupling exactly one
element of each, give normal equations of arrow shape

    [ Ba  E ] [dx_a]   [-g_a]
    [ Eᵀ  C ] [dx_b] = [-g_b]

with Ba block-diagonal over the A elements, C block-diagonal over the B
elements and E the coupling.  Eliminating B leaves the reduced camera
system

    S dx_a = -g_a + E C⁻¹ g_b,      S = Ba − E C⁻¹ Eᵀ
    dx_b   = C⁻¹ (−g_b − Eᵀ dx_a)

(Brown 1958; Triggs et al. 1999) — the regime the reference concedes
("not fast for large systems yet", reference README.md:30).

Observations live in a dense (n_a, n_b) grid with a visibility mask: a
masked pair contributes a zero residual and a zero Jacobian.  Every array
here has a leading instance axis (B = 1 for ``sparse.schur_optimize``):
the per-pair Jacobians come from ``torch.func`` forward-mode AD mapped
over landmarks, cameras and instances, the block products (Ba, C, E, g)
and S from einsums, the landmark inverses from
:func:`~.schur_obs.spd_inv_blocks`, and the reduced system is one dense
Cholesky of (n_a·da)² an instance (or, with ``hessian.schur_cg_iters``, a
block-Jacobi PCG on it).  J and the full H never exist; the largest array
is E at (B, n_a, n_b, da, db).

Float32 products are exact only while TF32 is off, which is torch's
default for matmuls; nothing here turns it on (the JAX package pins its
einsums to ``Precision.HIGHEST`` for the same reason).

It plugs into ``optimizers.loop.optimize_from_acc(propose=...)``:
``accumulate`` returns the :class:`SchurSystem` as the loop's Hessian and
``propose`` damps, eliminates and back-substitutes (multiplicative
(1+λ)·diag damping on Ba and C, reference lm.h:107-117; absolute λ on
exactly-zero diagonal entries, as ``ops.linalg.damp_diagonal``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost
from ..diff.auto import flatten_residuals
from ..options import SolverType
from ..solvers.step import dogleg_core
from .block import BlockDiag
from .linalg import inv_cov, pcg_core, refine_psd_solve, solve_psd
from .schur_obs import spd_inv_blocks
from .sparse_sym import _DenseCov


def _einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over any leading instance axes."""
    ins, out = spec.split("->")
    return torch.einsum(",".join("..." + s for s in ins.split(","))
                        + "->..." + out, *ops)


def _add_diag_blocks(S: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``S`` (..., n, n, d, d) with ``D`` (..., n, d, d) added to its
    diagonal blocks, as a product with the identity: no scatter and no
    ``index_add_``, so the sum is the same on every run on the card
    (``tinyopt_tpu.ops.schur``'s scatter-free add)."""
    n = D.shape[-3]
    eye = torch.eye(n, dtype=D.dtype, device=D.device)
    return S + eye[:, :, None, None] * D.unsqueeze(-3)


@dataclasses.dataclass
class SchurSystem:
    """Arrow-shaped normal equations, the loop's Hessian on the Schur path.

    ``matvec``, ``to_dense``, ``inv`` and the g / dx of the owning system
    use the loop's global leaf-major tangent layout; the block algebra is
    element-major.  ``em2gl`` / ``gl2em`` (None for single-leaf elements,
    where the layouts coincide) map between the two
    (:func:`tinyopt_tpu_torch.manifold.element_perm`).  They are pytree
    context, not leaves, so a per-instance select touches the blocks only.

    It has no ``diagonal()``: the loop's ``hessian.check_min_H_diag``
    raises a ``TypeError`` on it, as the JAX package's does."""

    Ba: torch.Tensor   #: (..., n_a, da, da) A-side diagonal blocks
    C: torch.Tensor    #: (..., n_b, db, db) B-side diagonal blocks
    E: torch.Tensor    #: (..., n_a, n_b, da, db) coupling blocks
    em2gl: Any = None  #: element-major -> global index (or None)
    gl2em: Any = None  #: global -> element-major index (or None)

    @property
    def dims(self) -> int:
        n_a, da = self.Ba.shape[-3], self.Ba.shape[-1]
        n_b, db = self.C.shape[-3], self.C.shape[-1]
        return n_a * da + n_b * db

    @property
    def shape(self):
        d = self.dims
        return (d, d)

    @property
    def dtype(self):
        return self.Ba.dtype

    def _to_gl(self, v: torch.Tensor) -> torch.Tensor:
        return v if self.em2gl is None else v[..., self.em2gl]

    def _to_em(self, v: torch.Tensor) -> torch.Tensor:
        return v if self.gl2em is None else v[..., self.gl2em]

    def _gl_matrix(self, M: torch.Tensor) -> torch.Tensor:
        if self.em2gl is None:
            return M
        return M[..., self.em2gl, :][..., :, self.em2gl]

    def to_dense(self) -> torch.Tensor:
        """The full arrow-shaped H (..., dims, dims), for covariance and
        tests, in the loop's global layout."""
        lead = tuple(self.Ba.shape[:-3])
        n_a, da = self.Ba.shape[-3], self.Ba.shape[-1]
        n_b, db = self.C.shape[-3], self.C.shape[-1]
        Ef = self.E.transpose(-3, -2).reshape(lead + (n_a * da, n_b * db))
        H = torch.cat([torch.cat([BlockDiag(self.Ba).to_dense(), Ef], dim=-1),
                       torch.cat([Ef.mT, BlockDiag(self.C).to_dense()], dim=-1)],
                      dim=-2)
        return self._gl_matrix(H)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H·v from the blocks (H is never assembled); ``v`` (..., dims)
        and the result in the loop's global layout."""
        lead = tuple(v.shape[:-1])
        n_a, da = self.Ba.shape[-3], self.Ba.shape[-1]
        n_b, db = self.C.shape[-3], self.C.shape[-1]
        v = self._to_em(v)
        v_a = v[..., :n_a * da].reshape(lead + (n_a, da))
        v_b = v[..., n_a * da:].reshape(lead + (n_b, db))
        o_a = (_einsum("iab,ib->ia", self.Ba, v_a)
               + _einsum("ijab,jb->ia", self.E, v_b))
        o_b = (_einsum("jab,jb->ja", self.C, v_b)
               + _einsum("ijab,ia->jb", self.E, v_a))
        return self._to_gl(torch.cat([o_a.reshape(lead + (-1,)),
                                      o_b.reshape(lead + (-1,))], dim=-1))

    def inv(self) -> _DenseCov:
        """Posterior covariance H⁻¹ by block inversion: cov_aa = S⁻¹,
        cov_ab = −S⁻¹EC⁻¹, cov_bb = C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹ — one (n_a·da)²
        inverse and batched (db×db) inverses, never a solve of the full
        system.  Non-finite where H is singular (``ops.linalg.inv_cov``)."""
        lead = tuple(self.Ba.shape[:-3])
        n_a, da = self.Ba.shape[-3], self.Ba.shape[-1]
        n_b, db = self.C.shape[-3], self.C.shape[-1]
        Cinv = torch.linalg.inv_ex(self.C)[0]
        EC = _einsum("ijab,jbc->ijac", self.E, Cinv)
        S_red = _einsum("ijac,kjdc->ikad", EC, self.E)
        S = _add_diag_blocks(-S_red, self.Ba).transpose(-3, -2).reshape(
            lead + (n_a * da, n_a * da))
        Sinv = inv_cov(S)
        ECf = EC.transpose(-3, -2).reshape(lead + (n_a * da, n_b * db))
        cov_ab = -(Sinv @ ECf)
        cov_bb = BlockDiag(Cinv).to_dense() + ECf.mT @ Sinv @ ECf
        cov = torch.cat([torch.cat([Sinv, cov_ab], dim=-1),
                         torch.cat([cov_ab.mT, cov_bb], dim=-1)], dim=-2)
        return _DenseCov(self._gl_matrix(cov))


pytree.register_pytree_node(
    SchurSystem, lambda s: ([s.Ba, s.C, s.E], (s.em2gl, s.gl2em)),
    lambda v, perms: SchurSystem(*v, *perms),
    serialized_type_name="tinyopt_tpu_torch.ops.schur.SchurSystem")


def bipartite_perms(a0, b0, n_a: int, n_b: int, da: int, db: int,
                    device=None):
    """Full-tangent ``(em2gl, gl2em)`` index tensors of a bipartite system
    on ``device``: the element-major layout is [camera 0's da dims,
    camera 1's, …, landmark 0's db dims, …], the global one the leaf-major
    ``mf.tangent_spec((a0, b0))``.  ``(None, None)`` where they coincide
    (both families single-leaf, the common case)."""
    p_a = mf.element_perm(a0, n_a)
    p_b = mf.element_perm(b0, n_b)
    if p_a is None and p_b is None:
        return None, None
    ia = p_a if p_a is not None else np.arange(n_a * da)
    ib = p_b if p_b is not None else np.arange(n_b * db)
    em2gl = np.concatenate([ia, n_a * da + ib])
    return (torch.as_tensor(em2gl, device=device),
            torch.as_tensor(np.argsort(em2gl), device=device))


def _damp_blocks(M: torch.Tensor, lam) -> torch.Tensor:
    """Multiplicative (1+λ) diagonal damping of every block of ``M``
    (..., n, d, d), λ one a leading index; absolute λ on exactly-zero
    diagonal entries (``ops.linalg.damp_diagonal``)."""
    d = M.shape[-1]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    lam = torch.as_tensor(lam, dtype=M.dtype, device=M.device)
    lam = lam.reshape(lam.shape + (1, 1))
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    add = torch.where(diag == 0, lam, diag * lam)
    return M + eye * add[..., None, :]


def linearize_grid(pair_fn: Callable, a, b, data, mask,
                   spec_a: mf.TangentSpec, spec_b: mf.TangentSpec, dtype):
    """Masked (r, Ja, Jb) of every A element against the given B elements,
    for every instance.

    ``a`` / ``b`` are pytrees of elements with leading axes (B, n_a) and
    (B, n_b); ``data`` leaves and ``mask`` carry the (B, n_a, n_b, ...)
    observation grid of exactly these B columns (the whole grid, or one
    device's landmark shard).  Shapes: r (B, n_a, n_b, m), Ja
    (B, n_a, n_b, m, da), Jb (B, n_a, n_b, m, db).

    The AD layout of the JAX package: da forward sweeps, each over a
    camera's whole (n_b, m) row; db sweeps mapped over the landmark axis;
    all of it mapped over the cameras, then over the instances."""
    da, db = spec_a.dims, spec_b.dims
    dev = mask.device

    def pair_r(a_i, b_j, d_ij):
        return flatten_residuals(pair_fn(a_i, b_j, d_ij)).to(dtype)

    def instance(a, b, data, mask):
        def cam_lin(a_i, d_i, m_i):
            def row_of_da(delta_a):
                a_r = mf.retract(a_i, delta_a, spec_a)
                r = torch.func.vmap(
                    lambda b_j, d_ij, m_ij: pair_r(a_r, b_j, d_ij) * m_ij)(
                        b, d_i, m_i)                      # (n_b, m)
                return r, r

            za = torch.zeros((da,), dtype=dtype, device=dev)
            Ja, r = torch.func.jacfwd(row_of_da, has_aux=True)(za)
            a_r0 = mf.retract(a_i, za, spec_a)

            def one_b(b_j, d_ij, m_ij):
                def r_of_db(delta_b):
                    return pair_r(a_r0, mf.retract(b_j, delta_b, spec_b),
                                  d_ij) * m_ij
                return torch.func.jacfwd(r_of_db)(
                    torch.zeros((db,), dtype=dtype, device=dev))

            Jb = torch.func.vmap(one_b)(b, d_i, m_i)      # (n_b, m, db)
            return r, Ja.to(dtype), Jb.to(dtype)

        return torch.func.vmap(cam_lin)(a, data, mask)

    return torch.func.vmap(instance)(a, b, data, mask)


def blocks_from(r, Ja, Jb, dtype):
    """Arrow-system blocks from the grid linearization:
    ``(Ba, C, E, g_a, g_b, rss)``, each with the leading instance axes of
    ``r``.  When (r, Ja, Jb) cover one landmark shard only, Ba, g_a and rss
    are partial sums over the shard's landmarks (to be reduced across
    shards) while C, E and g_b are the shard's own complete blocks."""
    Ba = _einsum("ijra,ijrb->iab", Ja, Ja).to(dtype)
    C = _einsum("ijra,ijrb->jab", Jb, Jb).to(dtype)
    E = _einsum("ijra,ijrb->ijab", Ja, Jb).to(dtype)
    g_a = _einsum("ijra,ijr->ia", Ja, r)
    g_b = _einsum("ijrb,ijr->jb", Jb, r)
    return Ba, C, E, g_a, g_b, torch.sum(r * r, dim=(-3, -2, -1))


def schur_eliminate(E, Bd, Cd, g_a, g_b, use_cholesky: bool = True,
                    reduce_fn: Callable | None = None, refine: int = 0,
                    cg_iters: int = 0):
    """Schur elimination and back-substitution of the (damped) arrow
    system [Bd, E; Eᵀ, Cd] dx = −g, for every instance.  Returns
    ``(dx_a, dx_b, ok)`` with dx_a (..., n_a, da), dx_b (..., n_b, db)
    and ok (...).

    ``reduce_fn`` completes the cross-landmark partial sums (the identity
    when E spans all landmarks; a sum over devices when it is one
    device's landmark shard).  ``ok`` covers the reduced solve and dx_a;
    the caller folds in dx_b.  ``refine`` is ``hessian.schur_refine``'s
    mixed-precision rounds on the reduced solve
    (:func:`~.linalg.refine_psd_solve`); ``cg_iters`` > 0
    (``hessian.schur_cg_iters``) solves the reduced system by that many
    block-Jacobi PCG iterations instead of a Cholesky, an inexact LM
    step."""
    red = reduce_fn if reduce_fn is not None else (lambda t: t)
    lead = tuple(g_a.shape[:-2])
    n_a, da = g_a.shape[-2], g_a.shape[-1]

    # the damped landmark blocks' inverses: NaN where a block is not PD,
    # which fails ok and escalates λ in the loop
    Cinv = spd_inv_blocks(Cd)
    EC = _einsum("ijab,jbc->ijac", E, Cinv)
    S_red = red(_einsum("ijac,kjdc->ikad", EC, E))
    S_blocks = _add_diag_blocks(-S_red, Bd)
    S = S_blocks.transpose(-3, -2).reshape(lead + (n_a * da, n_a * da))
    rhs = (-g_a + red(_einsum("ijac,jc->ia", EC, g_b))).reshape(
        lead + (n_a * da,))
    if cg_iters > 0:
        Minv = spd_inv_blocks(torch.diagonal(S_blocks, dim1=-4, dim2=-3)
                              .movedim(-1, -3))

        def prec(v):
            return _einsum("iab,ib->ia", Minv,
                           v.reshape(lead + (n_a, da))).reshape(v.shape)

        dx_a = pcg_core(lambda p: torch.matmul(S, p[..., None])[..., 0],
                        prec, rhs, cg_iters)
        ok = torch.all(torch.isfinite(dx_a), dim=-1)
    else:
        dx_a, ok = solve_psd(S, rhs, use_cholesky=use_cholesky)
        if refine > 0:
            dx_a = refine_psd_solve(S, rhs, dx_a, refine,
                                    use_cholesky=use_cholesky)
    ok = ok & torch.all(torch.isfinite(dx_a), dim=-1)
    dx_a = dx_a.reshape(lead + (n_a, da))
    dx_b = _einsum("jbc,jc->jb", Cinv,
                   -g_b - _einsum("ijab,ia->jb", E, dx_a))
    return dx_a, dx_b, ok


def schur_system(pair_fn: Callable, a0, b0, data, mask,
                 spec: mf.TangentSpec):
    """Batched ``(accumulate, evaluate, n_res, propose)`` of a bipartite
    NLLS problem over flat (B, P) parameters, for
    ``optimizers.loop.optimize_from_acc(propose=propose)``.

    ``pair_fn(a_i, b_j, data_ij) -> (m,)`` is one (A element, B element)
    observation; ``a0`` / ``b0`` are one instance's families (leading axes
    n_a and n_b); ``data`` leaves are (B, n_a, n_b, ...) and ``mask``
    (B, n_a, n_b), 1 for an observed pair (a masked pair contributes a
    zero residual and a zero Jacobian).  ``spec`` must be
    ``mf.tangent_spec((a0, b0))``: the loop's tangent is [A tangents; B
    tangents] (the pytree order of the pair).  ``n_res`` (B,) counts the
    observed pairs' residuals only, m · count_nonzero(mask), per
    instance: they feed inlier accounting, cost normalization and the
    rescaled covariance's (n − dims)."""
    a0, b0 = mf.as_pytree(a0), mf.as_pytree(b0)
    n_a = pytree.tree_leaves(a0)[0].shape[0]
    n_b = pytree.tree_leaves(b0)[0].shape[0]
    a_ex = pytree.tree_map(lambda l: l[0], a0)
    b_ex = pytree.tree_map(lambda l: l[0], b0)
    spec_a, spec_b = mf.tangent_spec(a_ex), mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype
    mask = torch.as_tensor(mask).to(dtype)
    dev = mask.device

    def pair_r(a_i, b_j, d_ij):
        return flatten_residuals(pair_fn(a_i, b_j, d_ij)).to(dtype)

    d_ex = pytree.tree_map(lambda l: l[0, 0, 0], data)
    m = int(pair_r(a_ex, b_ex, d_ex).numel())
    n_res = (torch.count_nonzero(mask, dim=(-2, -1)) * m).to(torch.int32)
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db, dev)

    def split(x):
        return mf.unflatten(x, spec)

    def accumulate(x):
        a, b = split(x)
        r, Ja, Jb = linearize_grid(pair_fn, a, b, data, mask, spec_a,
                                   spec_b, dtype)
        Ba, C, E, g_a, g_b, rss = blocks_from(r, Ja, Jb, dtype)
        g = torch.cat([g_a.flatten(-2), g_b.flatten(-2)], dim=-1)
        if em2gl is not None:
            g = g[..., em2gl]
        return SchurSystem(Ba, C, E, em2gl, gl2em), g, Cost.make(rss, n_res)

    def evaluate(x):
        a, b = split(x)

        def instance(a, b, data, mask):
            def cam(a_i, d_i, m_i):
                return torch.func.vmap(
                    lambda b_j, d_ij, m_ij: pair_r(a_i, b_j, d_ij) * m_ij)(
                        b, d_i, m_i)
            return torch.func.vmap(cam)(a, data, mask)

        r = torch.func.vmap(instance)(a, b, data, mask)
        return Cost.make(torch.sum(r * r, dim=(-3, -2, -1)), n_res)

    def eliminate(H: SchurSystem, Bd, Cd, g, use_cholesky=True, refine=0,
                  cg_iters=0):
        """(dx, ok) of the damped arrow system [Bd, E; Eᵀ, Cd] dx = −g;
        g and dx in the loop's global layout."""
        if gl2em is not None:
            g = g[..., gl2em]
        lead = tuple(g.shape[:-1])
        g_a = g[..., :n_a * da].reshape(lead + (n_a, da))
        g_b = g[..., n_a * da:].reshape(lead + (n_b, db))
        dx_a, dx_b, ok = schur_eliminate(H.E, Bd, Cd, g_a, g_b,
                                         use_cholesky=use_cholesky,
                                         refine=refine, cg_iters=cg_iters)
        dx = torch.cat([dx_a.flatten(-2), dx_b.flatten(-2)], dim=-1)
        if em2gl is not None:
            dx = dx[..., em2gl]
        return dx, ok & torch.all(torch.isfinite(dx_b.flatten(-2)), dim=-1)

    return accumulate, evaluate, n_res, _schur_propose(
        eliminate, lambda H, v: H.matvec(v))


def _schur_propose(eliminate: Callable, matvec: Callable) -> Callable:
    """``propose(H, g, lam, opts) -> (dx, ok)``, the damped Schur
    elimination of each solver type, from ``eliminate(H, Bd, Cd, g,
    use_cholesky, refine, cg_iters) -> (dx, ok)`` and the arrow matvec
    ``matvec(H, v)`` (g, v and dx in the loop's global layout)."""
    def propose(H, g, lam, opts):
        hs = opts.hessian
        kw = dict(use_cholesky=hs.use_ldlt, refine=hs.schur_refine,
                  cg_iters=hs.schur_cg_iters)
        if opts.solver_type == SolverType.DOGLEG:
            # the Gauss-Newton point from the undamped elimination, gᵀHg
            # by the block matvec, and the regularized fallback
            # re-eliminated with λ_eff block damping
            dx_gn, ok_gn = eliminate(H, H.Ba, H.C, g, **kw)
            return dogleg_core(
                g, lam, dx_gn, ok_gn, torch.sum(g * matvec(H, g), dim=-1),
                lambda le: eliminate(H, _damp_blocks(H.Ba, le),
                                     _damp_blocks(H.C, le), g, **kw))
        if opts.solver_type == SolverType.LEVENBERG_MARQUARDT:
            return eliminate(H, _damp_blocks(H.Ba, lam),
                             _damp_blocks(H.C, lam), g, **kw)
        return eliminate(H, H.Ba, H.C, g, **kw)

    return propose
