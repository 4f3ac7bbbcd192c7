"""Sparse / large-scale solves: block-diagonal, general sparse and
matrix-free Gauss-Newton with conjugate gradients.

Counterpart of the block, general-sparse and matrix-free parts of
``tinyopt_tpu.sparse`` (reference: solvers/gn.h:63-74, math.h:266-277,
tests/sparse.cpp:19-85 — a general ``SparseMatrix`` Hessian factored by
``SimplicialLDLT``, "not fast for large systems yet", README.md:30):

* **Block-diagonal** (``block_optimize``): independent parameter blocks,
  H a :class:`~.ops.block.BlockDiag` solved by one batched Cholesky over
  the blocks of every instance.
* **General sparse** (``sparse_optimize``): the Jacobian's nonzero
  structure is probed once on the host (or given), Curtis–Powell–Reid
  column coloring recovers J from one jvp sweep a color, and H = JᵀJ and
  g = Jᵀr are assembled on the static pattern as a
  :class:`~.ops.sparse_sym.SparseSym` by fixed-order segmented sums;
  multiplicative damping and Jacobi-PCG solve it.
* **Matrix-free** (``matfree_optimize``): neither J nor JᵀJ exists; g is
  one reverse-mode pass, the Gauss-Newton matvec v ↦ Jᵀ(Jv) one jvp and
  one vjp through the retraction, and the damping additive (λ times the
  Rayleigh quotient gᵀJᵀJg / gᵀg).
* **Schur complement** (``schur_optimize``): bipartite problems (bundle
  adjustment), the landmarks eliminated every iteration and only the
  reduced camera system solved (``ops/schur.py``); for sparse visibility
  ``schur_sparse_optimize`` takes exactly the observations in the
  point-major layout and ``schur_sparse_covariance`` gives the marginal
  covariance blocks at its solution (``ops/schur_obs.py``).

Every system here is batch-native like ``diff.auto.make_nlls_system``:
``accumulate(x) -> (H, g, Cost)`` and ``evaluate(x) -> Cost`` over flat
(B, P) parameters, for ``optimizers.loop.optimize_from_acc`` on a batch;
the ``*_optimize`` entry points are a batch of one.  The JAX
package's compile cache has no counterpart: nothing here is traced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .cost import Cost
from .diff.auto import flatten_residuals, instance_residuals, num_residuals
from .ops.block import BlockDiag
from .ops.coloring import _greedy_color, probe_structure
from .ops.linalg import cg_to_tol, cov_rescale
from .ops.schur import schur_system
from .ops.schur_obs import (obs_marginals, obs_marginals_buckets,
                            schur_obs_bucket_system, schur_obs_system)
from .ops.sparse_sym import Pattern, SegmentSum, SparseSym
from .optimizers.loop import optimize_from_acc
from .options import FIRST_ORDER_TYPES, Options, SolverType
from .output import map_output
from .solvers.step import dogleg_core


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _batch_of_one(x_flat, out, spec):
    return (pytree.tree_map(lambda a: a[0], mf.unflatten(x_flat, spec)),
            map_output(lambda v: v[0], out))


def _check_second_order(options: Options, name: str):
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            f"{name} is a Gauss-Newton/LM method; use to.optimize with a "
            "first-order solver type for gradient-only solves")


def _delta_residuals(residual_fn, spec: mf.TangentSpec):
    """``r(δ, xv) -> (n_res,)``: one instance's residuals at x ⊞ δ, x
    flat (P,)."""
    r1 = instance_residuals(residual_fn, spec, False)

    def r_of_delta(delta, xv):
        return r1(mf.retract_flat(xv, delta, spec))
    return r1, r_of_delta


# --------------------------------------------------------------------------
# Block-diagonal path
# --------------------------------------------------------------------------

def block_nlls_system(block_fn: Callable, x_example: torch.Tensor,
                      data_batch=None):
    """Batched (accumulate, evaluate, n_res) for independent parameter
    blocks.

    ``x_example`` (nb, bs) is one instance; the loop's x is (B, nb·bs).
    ``block_fn(x_block[, data_block])`` returns one block's residuals;
    ``data_batch`` leaves are (B, nb, ...).  Each block's Jacobian is one
    ``torch.func.jacfwd``, mapped over the blocks and the instances; H is
    a :class:`BlockDiag` (B, nb, bs, bs) — the (nb·bs)² matrix never
    exists."""
    nb, bs = x_example.shape
    dtype = x_example.dtype
    extra = () if data_batch is None else (data_batch,)
    data_ex = [] if data_batch is None else [
        pytree.tree_map(lambda a: a[0, 0], data_batch)]

    def r_blk(xb, *db):
        return flatten_residuals(block_fn(xb, *db)).to(dtype)

    n_res = nb * int(r_blk(x_example[0], *data_ex).numel())

    def one(xb, *db):
        def r_aux(v):
            r = r_blk(v, *db)
            return r, r
        J, r = torch.func.jacfwd(r_aux, has_aux=True)(xb)
        J = J.to(dtype)
        return J.mT @ J, J.mT @ r, torch.sum(r * r)

    per_block = torch.func.vmap(torch.func.vmap(one))
    cost_blk = torch.func.vmap(torch.func.vmap(
        lambda xb, *db: torch.sum(r_blk(xb, *db) ** 2)))

    def accumulate(x):
        Hs, gs, cs = per_block(x.reshape(x.shape[0], nb, bs), *extra)
        return (BlockDiag(Hs), gs.reshape(x.shape[0], -1),
                Cost.make(torch.sum(cs, dim=-1), n_res))

    def evaluate(x):
        cs = cost_blk(x.reshape(x.shape[0], nb, bs), *extra)
        return Cost.make(torch.sum(cs, dim=-1), n_res)

    return accumulate, evaluate, n_res


def block_optimize(x0: torch.Tensor, block_fn: Callable,
                   options: Options | None = None, *, data=None):
    """Solve an NLLS problem with independent (block-diagonal) parameter
    blocks: ``x0`` (nb, bs), ``data`` leaves (nb, ...).  Returns
    ``(x_opt, Output)``; ``Output.final_hessian`` is a :class:`BlockDiag`
    and ``Output.covariance()`` is blockwise (densified to (n, n))."""
    options = options or Options()
    x0 = torch.as_tensor(x0)
    spec = mf.tangent_spec(x0)
    data_batch = (None if data is None
                  else pytree.tree_map(lambda a: torch.as_tensor(a)[None],
                                       data))
    acc, ev, _ = block_nlls_system(block_fn, x0, data_batch)
    x, out = optimize_from_acc(x0.reshape(1, -1), acc, ev, options, spec)
    return _batch_of_one(x, out, spec)


# --------------------------------------------------------------------------
# General sparse path (colored J recovery -> COO JᵀJ)
# --------------------------------------------------------------------------

def _sparse_plan(structure: np.ndarray):
    """Static host plan for colored J recovery and COO JᵀJ assembly from a
    (n_res, dims) boolean structure (``tinyopt_tpu.sparse._sparse_plan``).

    Returns ``(probes, e_rows, e_colors, e_cols, pair_e1, pair_e2,
    pair_out, h_rows, h_cols, n_colors)``: the (C, dims) CPR probe per
    color; J entry ``e`` at ``(e_rows[e], e_cols[e])``, read from the
    compressed product at ``(e_colors[e], e_rows[e])``; and H entry
    ``pair_out[p]`` summing ``J[pair_e1[p]] * J[pair_e2[p]]`` over all
    ordered pairs of J entries sharing a row (both triangles)."""
    n_res, dims = structure.shape
    colors = _greedy_color(structure)
    n_colors = int(colors.max()) + 1 if dims else 1

    probes = np.zeros((n_colors, dims))
    probes[colors, np.arange(dims)] = 1.0

    e_rows, e_cols = np.nonzero(structure)       # row-major (sorted by row)
    e_colors = colors[e_cols]
    nnz = e_rows.size

    counts = np.bincount(e_rows, minlength=n_res)        # J entries per row
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    c_per_entry = counts[e_rows]
    pair_e1 = np.repeat(np.arange(nnz), c_per_entry)
    block_starts = np.repeat(starts[e_rows], c_per_entry)
    run_starts = np.repeat(np.cumsum(c_per_entry) - c_per_entry, c_per_entry)
    pair_e2 = block_starts + (np.arange(pair_e1.size) - run_starts)

    keys = e_cols[pair_e1].astype(np.int64) * dims + e_cols[pair_e2]
    uniq, pair_out = np.unique(keys, return_inverse=True)
    h_rows = uniq // dims
    h_cols = uniq % dims
    return (probes, e_rows, e_colors, e_cols, pair_e1, pair_e2,
            pair_out.reshape(-1), h_rows, h_cols, n_colors)


def sparse_system(residual_fn: Callable, x_example, spec: mf.TangentSpec,
                  structure: np.ndarray):
    """Batched (accumulate, evaluate, n_res) assembling H = JᵀJ as a
    :class:`SparseSym` from colored jvp sweeps, over flat (B, P)
    parameters; the plan's tables live on ``x_example``'s device.

    Each instance takes one jvp a color; J is read at its nonzeros, and H
    (on the static COO pattern) and g = Jᵀr are fixed-order segmented
    sums (:class:`SegmentSum`) — nothing dense in ``dims`` exists."""
    n_res, dims = structure.shape
    (probes_np, e_rows, e_colors, e_cols, pair_e1, pair_e2,
     pair_out, h_rows, h_cols, _) = _sparse_plan(np.asarray(structure, bool))
    dtype = spec.dtype
    dev = torch.as_tensor(pytree.tree_leaves(x_example)[0]).device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    probes = torch.as_tensor(probes_np, dtype=dtype, device=dev)
    e_rows_t, e_colors_t = t(e_rows), t(e_colors)
    pair_e1_t, pair_e2_t = t(pair_e1), t(pair_e2)
    h_sum = SegmentSum(pair_out, int(h_rows.size), dev)
    g_sum = SegmentSum(e_cols, dims, dev)
    pattern = Pattern(h_rows, h_cols, dims, dev)
    r1, r_of_delta = _delta_residuals(residual_fn, spec)

    def one(xv, zero):
        def sweep(p):
            return torch.func.jvp(lambda d: r_of_delta(d, xv), (zero,),
                                  (p,))[1]
        return r1(xv), torch.func.vmap(sweep)(probes)

    sweeps = torch.func.vmap(one, in_dims=(0, None))
    res = torch.func.vmap(r1)

    def accumulate(x):
        zero = torch.zeros((dims,), dtype=x.dtype, device=x.device)
        r, compressed = sweeps(x, zero)                  # (B, C, n_res)
        j_vals = compressed.to(dtype)[:, e_colors_t, e_rows_t]
        H = SparseSym(h_sum(j_vals[:, pair_e1_t] * j_vals[:, pair_e2_t]),
                      pattern)
        g = g_sum(j_vals * r[:, e_rows_t])
        return H, g, Cost.make(torch.sum(r * r, dim=-1), n_res)

    def evaluate(x):
        r = res(x)
        return Cost.make(torch.sum(r * r, dim=-1), n_res)

    return accumulate, evaluate, n_res


def sparse_optimize(x0, residual_fn: Callable,
                    options: Options | None = None, *,
                    structure: np.ndarray | None = None):
    """LM / GN / DogLeg with a general sparse JᵀJ Hessian (static
    sparsity pattern) — the reference's ``SparseMatrix`` Hessian with
    ``SimplicialLDLT`` (solvers/gn.h:63-74, math.h:266-277,
    tests/sparse.cpp:19-85).  The structure, a (n_res, dims) boolean array
    over the TANGENT dimensions, is probed on the host at a few perturbed
    points unless given; the damped system is solved by Jacobi-PCG
    (``options.hessian.cg_iters``; 0 means ``dims`` iterations).
    ``Output.final_hessian`` is a :class:`SparseSym` and
    ``Output.covariance()`` its dense inverse."""
    options = options or Options()
    _check_second_order(options, "sparse_optimize")
    x0 = mf.as_pytree(x0)
    spec = mf.tangent_spec(x0)
    n_res = num_residuals(residual_fn, x0)
    if structure is None:
        structure = probe_structure(residual_fn, x0, None, spec, n_res,
                                    spec.dims)
        if structure is None:
            raise ValueError(
                "could not detect the Jacobian's sparsity structure "
                "(non-finite or untraceable residuals); pass structure= "
                "explicitly or use to.optimize / matfree_optimize")
    else:
        structure = np.asarray(structure, bool)
        if structure.shape != (n_res, spec.dims):
            raise ValueError(
                f"structure shape {structure.shape} != "
                f"(n_res={n_res}, dims={spec.dims})")
    acc, ev, _ = sparse_system(residual_fn, x0, spec, structure)
    xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, options, spec)
    return _batch_of_one(x, out, spec)


# --------------------------------------------------------------------------
# Matrix-free GN-CG path
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LinPoint:
    """Hessian representation of the matrix-free path: the linearization
    points themselves (B, P).  The GN matvec is derived from them on
    demand, so the Rebuild(false) semantics (H frozen at the last build
    while probing) carry over: the carried LinPoint changes only on a
    rebuild."""

    x: Any


pytree.register_pytree_node(
    LinPoint, lambda s: ([s.x], None), lambda v, _: LinPoint(*v),
    serialized_type_name="tinyopt_tpu_torch.sparse.LinPoint")


def hutchinson_probes(n_probes: int, dims: int) -> torch.Tensor:
    """(n_probes, dims) Rademacher ±1 probes from a CPU generator seeded 0,
    the same on every device.  (The JAX package draws them with
    ``jax.random.bernoulli(PRNGKey(0))``; those bits are not reproducible
    here, so the probes differ from the JAX package's by design.)"""
    gen = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (n_probes, dims), generator=gen)
    return 2.0 * bits.to(torch.float64) - 1.0


def matfree_system(residual_fn: Callable, x_example, spec: mf.TangentSpec,
                   cg_iters: int, cg_tol: float, precond_probes: int = 0):
    """Batched (accumulate, evaluate, n_res, propose) for GN-CG.

    ``accumulate`` takes g from ONE reverse-mode pass per instance (J
    itself is never needed).  ``propose(H, g, λ, opts)`` solves
    (JᵀJ + λ·ray·I) dx = −g by CG with ``jax.scipy.sparse.linalg.cg``'s
    stopping rule (``cg_iters`` at most, ``tol=cg_tol``), ray the
    Rayleigh quotient gᵀJᵀJg / gᵀg standing in for the reference's
    multiplicative diag(JᵀJ) scaling; DogLeg runs over the same CG.

    ``precond_probes`` > 0 estimates diag(JᵀJ) by Hutchinson's
    mean of (JᵀJv) ⊙ v over ±1 probes (:func:`hutchinson_probes`, drawn
    once here): a Jacobi preconditioner, and the reference's
    multiplicative per-dimension damping in place of the Rayleigh scale.
    It helps badly scaled, loosely coupled systems and hurts strongly
    coupled ones (``tinyopt_tpu.sparse.matfree_system``).  On a diagonal
    JᵀJ the estimate is exact for any ±1 probe."""
    n_res = num_residuals(residual_fn, x_example)
    dims, dtype = spec.dims, spec.dtype
    r1, r_of_delta = _delta_residuals(residual_fn, spec)
    vs = (hutchinson_probes(precond_probes, dims)
          if precond_probes > 0 else None)

    def g_one(xv, zero):
        r, vjp_fn = torch.func.vjp(lambda d: r_of_delta(d, xv), zero)
        return vjp_fn(r)[0], r

    def jvp_one(xv, v, zero):
        return torch.func.jvp(lambda d: r_of_delta(d, xv), (zero,), (v,))[1]

    def gn_one(xv, v, zero):
        _, vjp_fn = torch.func.vjp(lambda d: r_of_delta(d, xv), zero)
        return vjp_fn(jvp_one(xv, v, zero))[0]

    grads = torch.func.vmap(g_one, in_dims=(0, None))
    jvps = torch.func.vmap(jvp_one, in_dims=(0, 0, None))
    gns = torch.func.vmap(gn_one, in_dims=(0, 0, None))
    res = torch.func.vmap(r1)

    def zero_like(x):
        return torch.zeros((dims,), dtype=x.dtype, device=x.device)

    def accumulate(x):
        g, r = grads(x, zero_like(x))
        return (LinPoint(x), g.to(dtype),
                Cost.make(torch.sum(r * r, dim=-1), n_res))

    def evaluate(x):
        r = res(x)
        return Cost.make(torch.sum(r * r, dim=-1), n_res)

    def propose(H: LinPoint, g, lam, opts):
        x = H.x
        zero = zero_like(x)

        def gn_matvec(v):
            return gns(x, v, zero).to(dtype)

        if vs is not None:
            probes = vs.to(dtype=g.dtype, device=g.device)
            d_est = torch.mean(torch.stack(
                [gn_matvec(v.expand_as(g)) * v for v in probes]), dim=0)
            floor = (torch.clamp(torch.amax(d_est, dim=-1), min=1.0)
                     * torch.finfo(g.dtype).eps)
            diag_h = torch.maximum(d_est, floor[:, None])
            dinv = 1.0 / diag_h
        else:
            diag_h = dinv = None

        def cg_solve(add_lam):
            add = add_lam[:, None]
            if diag_h is not None:
                # multiplicative per-dimension damping (lm.h:107-117 on the
                # estimated diagonal) and the Jacobi preconditioner
                dx = cg_to_tol(lambda v: gn_matvec(v) + add * diag_h * v,
                               -g, maxiter=cg_iters, tol=cg_tol,
                               precond=lambda v: v * dinv)
            else:
                dx = cg_to_tol(lambda v: gn_matvec(v) + add * v, -g,
                               maxiter=cg_iters, tol=cg_tol)
            return dx, torch.all(torch.isfinite(dx), dim=-1)

        # additive damping scaled by the Rayleigh quotient along g (one
        # extra jvp): λ · (gᵀJᵀJg / gᵀg)
        g2 = _dot(g, g)
        Jg = jvps(x, g, zero)
        gHg = _dot(Jg, Jg).to(g.dtype)
        one = torch.ones_like(g2)
        ray = torch.clamp(torch.where(g2 > 0, gHg / torch.where(g2 > 0, g2,
                                                                one), one),
                          min=torch.finfo(g.dtype).tiny)

        if opts.solver_type == SolverType.DOGLEG:
            # GN point from an undamped CG solve, gᵀHg = ‖Jg‖² exactly, the
            # regularized fallback re-solves damped (the estimated diagonal
            # already scales the damping, so no Rayleigh factor there)
            dx_gn, ok_gn = cg_solve(torch.zeros_like(g2))
            fallback = (cg_solve if diag_h is not None
                        else (lambda le: cg_solve(le * ray)))
            return dogleg_core(g, lam, dx_gn, ok_gn, gHg, fallback)
        if opts.solver_type == SolverType.LEVENBERG_MARQUARDT:
            add_lam = lam if diag_h is not None else lam * ray
        else:
            add_lam = torch.zeros_like(lam)
        return cg_solve(add_lam.to(g.dtype))

    return accumulate, evaluate, n_res, propose


def matfree_optimize(x0, residual_fn: Callable,
                     options: Options | None = None, *,
                     cg_iters: int = 0, cg_tol: float = 1e-10,
                     precond_probes: int = 0):
    """Matrix-free Gauss-Newton / LM / DogLeg with conjugate-gradient inner
    solves; neither J nor JᵀJ is ever formed — for very large tangent
    dimensions.  ``cg_iters=0`` means the tangent dimension.
    ``Output.final_hessian`` is None (``save_last`` is forced off).
    ``precond_probes`` > 0 adds the Hutchinson-estimated Jacobi
    preconditioner and multiplicative damping (:func:`matfree_system`)."""
    options = options or Options()
    _check_second_order(options, "matfree_optimize")
    x0 = mf.as_pytree(x0)
    spec = mf.tangent_spec(x0)
    if cg_iters <= 0:
        cg_iters = spec.dims
    opts = options.replace(
        hessian=dataclasses.replace(options.hessian, save_last=False))
    acc, ev, _, propose = matfree_system(residual_fn, x0, spec, cg_iters,
                                         cg_tol, precond_probes)
    xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, opts, spec, propose=propose)
    return _batch_of_one(x, out, spec)


# --------------------------------------------------------------------------
# Schur-complement path (bipartite problems)
# --------------------------------------------------------------------------

def schur_optimize(x0: tuple, pair_fn: Callable, data, mask,
                   options: Options | None = None):
    """Bipartite NLLS by Schur-complement elimination (bundle adjustment).

    ``x0 = (a0, b0)``: two families of elements with a leading axis each —
    e.g. cameras (a batched SE3) and landmarks ((n_b, 3)) — where every
    residual couples exactly one element of each.
    ``pair_fn(a_i, b_j, data_ij) -> (m,)`` evaluates one observation;
    ``data`` leaves are (n_a, n_b, ...) and ``mask`` is (n_a, n_b), 1 for
    an observed pair.  Every iteration eliminates the B family (batched
    db×db inverses) and solves only the (n_a·da)² reduced camera system
    (``ops/schur.py``).  Returns ``((a, b), Output)``;
    ``Output.final_hessian`` is a :class:`~.ops.schur.SchurSystem` when
    ``hessian.save_last`` is on and ``Output.covariance()`` inverts it by
    blocks; ``Cost.num_residuals`` counts the observed pairs only
    (m · count_nonzero(mask))."""
    options = options or Options()
    _check_second_order(options, "schur_optimize")
    x0 = _schur_pair(x0, "schur_optimize needs x0 = (a0, b0)")
    spec = mf.tangent_spec(x0)
    acc, ev, _, propose = schur_system(pair_fn, x0[0], x0[1],
                                       _batch_tree(data),
                                       _batch_tree(mask), spec)
    xb = mf.flatten_batch(_batch_tree(x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, options, spec, propose=propose)
    return _batch_of_one(x, out, spec)


def _schur_pair(x0, message: str) -> tuple:
    """``x0 = (a0, b0)`` as two pytrees; ``message`` if it is not a pair."""
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError(message)
    return (mf.as_pytree(x0[0]), mf.as_pytree(x0[1]))


def _batch_tree(tree):
    """Every leaf of ``tree`` with a leading instance axis of one."""
    return pytree.tree_map(lambda a: torch.as_tensor(a)[None], tree)


def schur_sparse_optimize(x0: tuple, pair_fn: Callable, obs, cam_idx, mask,
                          options: Options | None = None):
    """Sparse-observation bundle adjustment (point-major padded layout).

    The memory-scalable form of :func:`schur_optimize` for SPARSE
    visibility: instead of a dense (n_a, n_b) grid, pass exactly the
    observations — ``obs``, a pytree with leaves (n_b, K, ...): per-landmark
    data for up to ``K`` observations; ``cam_idx`` (n_b, K) ints: the
    camera of each slot; ``mask`` (n_b, K): 1 for real slots (a padded slot
    contributes exactly zero residual and Jacobian).  Memory is O(n_b · K)
    instead of O(n_a · n_b).  The same Schur elimination every iteration
    (``ops/schur_obs.py``); GN / LM / DogLeg; the reduced camera system
    is solved by cyclic reduction where the cameras are banded
    (``hessian.schur_banded``).  ``hessian.schur_sort`` is accepted and
    sorts nothing: the JAX package sorts landmarks only for its TPU
    window reduce.  ``ops.schur_obs.grid_to_obs`` converts grid-form
    data.  Returns ``((a, b), Output)``; ``Cost.num_residuals`` counts
    real slots only."""
    options = options or Options()
    _check_second_order(options, "schur_sparse_optimize")
    x0 = _schur_pair(x0, "schur_sparse_optimize needs x0 = (a0, b0)")
    spec = mf.tangent_spec(x0)
    acc, ev, _, propose = schur_obs_system(pair_fn, x0[0], x0[1],
                                           _batch_tree(obs), cam_idx, mask,
                                           spec)
    xb = mf.flatten_batch(_batch_tree(x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, options, spec, propose=propose)
    return _batch_of_one(x, out, spec)


def schur_sparse_covariance(x, pair_fn: Callable, obs, cam_idx, mask, *,
                            rescaled: bool = False, chunk: int = 1024):
    """Posterior marginal covariance blocks of a sparse-observation BA
    solution, the companion of :func:`schur_sparse_optimize`: call it at
    the solution ``x = (a, b)`` with the same observation layout.

    Returns ``(cov_a (n_a, da, da), cov_b (n_b, db, db))``, the per-camera
    and per-landmark marginal covariance blocks of H(x)⁻¹ (element-major
    tangent layout in each block), from the reduced camera system: S⁻¹ IS
    the camera marginal covariance and the landmark blocks follow as
    C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹ — one (n_a·da)² inverse and per-point algebra; the
    (dims)² dense H⁻¹ of the reference (math.h:88-189, output.h:80-93) is
    never formed.  ``rescaled=True`` applies the reference's
    overdetermined rescale ``cost²/(n_res − dims)``, as
    ``Output.covariance(rescaled=True)``.  Non-finite where H is singular
    (gauge not fixed), NaN for a landmark with no real observation."""
    x = _schur_pair(x, "schur_sparse_covariance needs x = (a, b)")
    spec = mf.tangent_spec(x)
    acc, _, _, _ = schur_obs_system(pair_fn, x[0], x[1], _batch_tree(obs),
                                    cam_idx, mask, spec, chunk)
    H, _, cost = acc(mf.flatten_batch(_batch_tree(x), spec))
    cov_a, cov_b = obs_marginals(H, chunk)
    if rescaled:
        f = cov_rescale(cost.cost, cost.num_residuals, spec.dims)
        cov_a = cov_a * f[:, None, None, None]
        cov_b = cov_b * f[:, None, None, None]
    return cov_a[0], cov_b[0]


def _batch_slabs(slabs) -> list:
    """Bucketed slabs ``(obs, cam_idx, mask, ids)`` with a leading instance
    axis of one on every obs leaf."""
    return [(_batch_tree(obs), ci, mk, ids) for obs, ci, mk, ids in slabs]


def schur_sparse_optimize_buckets(x0: tuple, pair_fn: Callable, slabs,
                                  options: Options | None = None):
    """Sparse-observation bundle adjustment over a K-bucketed point-major
    layout, for heavy-tailed visibility (published BAL problems: a few
    observations a landmark, hundreds for the densest), where one (n_b,
    K_max) padded slab would hold mostly padding.

    ``slabs`` groups the landmarks by observation count: each entry
    ``(obs, cam_idx, mask, ids)`` is a padded slab with its own cap K_g
    (obs leaves (n_g, K_g, ...), ``cam_idx`` / ``mask`` (n_g, K_g)) and the
    original landmark indices ``ids`` of its rows;
    ``ops.schur_obs.bucket_obs`` builds them from a padded layout,
    ``models.bal.load_bal(layout="bucketed")`` from a BAL file.  The same
    elimination as :func:`schur_sparse_optimize` (the reduced camera system
    sums over the buckets), so trajectories follow the single-slab
    layout's up to summation order.  ``x0 = (a0, b0)`` keeps the original
    landmark order.  GN / LM / DogLeg.  Returns ``((a, b), Output)``."""
    options = options or Options()
    _check_second_order(options, "schur_sparse_optimize_buckets")
    x0 = _schur_pair(x0, "schur_sparse_optimize_buckets needs x0 = (a0, b0)")
    spec = mf.tangent_spec(x0)
    acc, ev, _, propose = schur_obs_bucket_system(
        pair_fn, x0[0], x0[1], _batch_slabs(slabs), spec)
    xb = mf.flatten_batch(_batch_tree(x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, options, spec, propose=propose)
    return _batch_of_one(x, out, spec)


def schur_sparse_covariance_buckets(x, pair_fn: Callable, slabs, *,
                                    rescaled: bool = False,
                                    chunk: int = 1024):
    """Posterior marginal covariance blocks of a K-bucketed solution, the
    companion of :func:`schur_sparse_optimize_buckets` with
    :func:`schur_sparse_covariance`'s semantics: the camera marginals are
    the diagonal blocks of S⁻¹ with S summed over the buckets, the landmark
    blocks follow bucket by bucket, ``rescaled`` as there.  Returns
    ``(cov_a (n_a, da, da), cov_b (n_b, db, db))`` with ``cov_b`` in the
    original landmark order."""
    x = _schur_pair(x, "schur_sparse_covariance_buckets needs x = (a, b)")
    spec = mf.tangent_spec(x)
    acc, _, _, _ = schur_obs_bucket_system(pair_fn, x[0], x[1],
                                           _batch_slabs(slabs), spec, chunk)
    H, _, cost = acc(mf.flatten_batch(_batch_tree(x), spec))
    cov_a, cov_b = obs_marginals_buckets(H, [ids for *_, ids in slabs],
                                         chunk)
    if rescaled:
        f = cov_rescale(cost.cost, cost.num_residuals, spec.dims)
        cov_a = cov_a * f[:, None, None, None]
        cov_b = cov_b * f[:, None, None, None]
    return cov_a[0], cov_b[0]
