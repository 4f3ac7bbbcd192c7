"""Chain-structured NLLS: the direct pose-graph / odometry solver.

Counterpart of ``tinyopt_tpu.chain``.  ``chain_optimize`` solves graphs of
N parameter blocks (e.g. a batched SE3 trajectory) connected by binary
measurements.  Edges between CONSECUTIVE blocks (j == i+1, the odometry
backbone) assemble a block-tridiagonal Gauss-Newton Hessian, factored
exactly; every other edge (a loop closure) enters as columns of a low-rank
factor U handled by the Woodbury identity — so an iteration's solve is
O(N·d³ + N·d²·m + m³) with m = Σ loop residual dims, whatever the chain's
O(N²) condition number (``ops/tridiag.py``).

The system is batch-native like the port's other systems (``sparse.py``):
``chain_system`` returns ``accumulate(x) -> (ChainSystem, g, Cost)``,
``evaluate`` and ``propose`` over flat (B, P) parameters for
``optimizers.loop.optimize_from_acc``, and the :class:`ChainSystem` carries
the instance axis first.  ``chain_optimize`` and ``chain_marginals`` are a
batch of one.  The JAX package's compile caches and ``jit=`` have no
counterpart: nothing here is traced.

The tridiagonal backend (``method``): "scan", the sequential factor and
sweeps, the least arithmetic, or "cr", cyclic reduction, ⌈log₂N⌉ levels of
batched operations.  "auto" takes "cr" where the system's tensors are on
CUDA and "scan" on the CPU — the JAX package's rule with the card in the
TPU's place: a scan of tiny operations is bound by its launches there.

Float32 on the card needs TF32 off (torch's default for matmuls): the
JAX package pins every assembly and solve contraction of the chain to
``Precision.HIGHEST`` because truncated products made the float32
5,000-pose graph diverge.

Requirements: m ≪ N·d (many loop closures: ``sparse_optimize`` /
``matfree_optimize``); the gauge fixed by an anchoring unary residual, or
LM damping relied on for the Gauss-Newton-singular directions.
Covariance: :func:`chain_marginals` (per-pose (d, d) marginal blocks by
the selected-inverse recursion with the Woodbury downdate, never dense),
or ``Output.covariance()`` / ``ChainSystem.inv()`` for the full dense
H⁻¹ at small N.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .cost import Cost
from .diff.auto import flatten_residuals
from .ops.linalg import cov_rescale, inv_cov
from .ops.sparse_sym import SegmentSum, _DenseCov
from .ops.tridiag import tridiag_woodbury_marginals, tridiag_woodbury_solve
from .optimizers.loop import optimize_from_acc
from .options import FIRST_ORDER_TYPES, Options, SolverType
from .output import map_output
from .solvers.step import dogleg_core


@dataclasses.dataclass
class ChainSystem:
    """The loop's Hessian on the chain path: T = tridiag(D, B) plus the
    loop-closure factor U (H = T + U·Uᵀ); ``diag`` is the FULL Hessian
    diagonal (U's part included) for multiplicative LM damping.  Every
    field has the leading instance axes first (B for the loop; none after
    ``chain_optimize`` squeezes its batch of one).  Vectors and blocks are
    element-major: block i's d dims together."""

    D: torch.Tensor      #: (..., N, d, d) diagonal blocks of T
    B: torch.Tensor      #: (..., N-1, d, d) sub-diagonal blocks (T[i+1, i])
    U: torch.Tensor      #: (..., N, d, m) loop-closure factor
    diag: torch.Tensor   #: (..., N, d) full diag(H)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H·v for flat element-major tangents ``v`` (..., N·d)."""
        N, d = self.D.shape[-3], self.D.shape[-1]
        v2 = v.reshape(v.shape[:-1] + (N, d))
        o = torch.einsum("...nab,...nb->...na", self.D, v2)
        if N > 1:
            lo = torch.einsum("...nab,...nb->...na", self.B, v2[..., :-1, :])
            hi = torch.einsum("...nba,...nb->...na", self.B, v2[..., 1:, :])
            o = o.clone()
            o[..., 1:, :] += lo
            o[..., :-1, :] += hi
        if self.U.shape[-1]:
            w = torch.einsum("...ndm,...nd->...m", self.U, v2)
            o = o + torch.einsum("...ndm,...m->...nd", self.U, w)
        return o.reshape(v.shape)

    @property
    def dims(self) -> int:
        return self.D.shape[-3] * self.D.shape[-1]

    @property
    def shape(self):
        return (self.dims, self.dims)

    @property
    def dtype(self):
        return self.D.dtype

    def marginals(self) -> torch.Tensor:
        """Per-block marginal covariance (..., N, d, d): the diagonal blocks
        of H⁻¹ by the selected-inverse recursion off the block-tridiagonal
        factor, Woodbury-downdated for the loop closures
        (``ops/tridiag.tridiag_woodbury_marginals``) — O(N·d³ + N·d²·m),
        never dense.  NaN for an instance whose H is singular (gauge not
        fixed; ``inv_cov``'s contract)."""
        marg, ok = tridiag_woodbury_marginals(self.D, self.B, self.U)
        return torch.where(ok[..., None, None, None], marg,
                           torch.full_like(marg, float("nan")))

    def to_dense(self) -> torch.Tensor:
        """The full H (..., N·d, N·d), element-major (testing and small-N
        covariance)."""
        N, d = self.D.shape[-3], self.D.shape[-1]
        lead = self.D.shape[:-3]
        eye = torch.eye(N, dtype=self.dtype, device=self.D.device)
        sub = torch.diag(torch.ones(max(N - 1, 0), dtype=self.dtype,
                                    device=self.D.device), -1)
        Bp = torch.cat([self.B, self.D.new_zeros(lead + (1, d, d))], dim=-3)
        Hb = (eye[:, :, None, None] * self.D.unsqueeze(-4)
              + sub[:, :, None, None] * Bp.unsqueeze(-4)
              + sub.T[:, :, None, None] * Bp.mT.unsqueeze(-3))
        H = Hb.transpose(-3, -2).reshape(lead + (N * d, N * d))
        Uf = self.U.reshape(lead + (N * d, self.U.shape[-1]))
        return H + Uf @ Uf.mT

    def inv(self) -> _DenseCov:
        """Full dense H⁻¹ (``Output.covariance``'s contract, small N only:
        it densifies); at scale use :meth:`marginals` /
        :func:`chain_marginals`."""
        return _DenseCov(inv_cov(self.to_dense()))


pytree.register_pytree_node(
    ChainSystem, lambda s: ([s.D, s.B, s.U, s.diag], None),
    lambda v, _: ChainSystem(*v),
    serialized_type_name="tinyopt_tpu_torch.chain.ChainSystem")


def _edges_np(edges) -> np.ndarray:
    if isinstance(edges, torch.Tensor):
        edges = edges.cpu()
    return np.asarray(edges)


def _vmap2(fn, n_args: int, data) -> Callable:
    """``fn`` mapped over (instances, elements) for ``n_args`` parameter
    arguments and a data argument that may be None."""
    dims = (0,) * n_args + (None if data is None else 0,)
    return torch.func.vmap(torch.func.vmap(fn, in_dims=dims), in_dims=dims)


def chain_system(x0, edge_fn: Callable, edges, edge_data,
                 unary_fn: Callable | None, unary_nodes, unary_data,
                 spec: mf.TangentSpec, method: str = "auto"):
    """Batched (accumulate, evaluate, n_res, propose) for a chain graph.

    ``x0`` is one instance's parameter pytree of N blocks (a leading axis N
    on every leaf, e.g. a batched SE3) and ``spec`` its
    ``mf.tangent_spec``; the loop's x is (B, P).  ``edge_fn(x_i, x_j,
    data_e) -> (me,)`` is one binary measurement of the static (E, 2)
    ``edges``; ``edge_data`` leaves are (B, E, ...) (or None).
    ``unary_fn(x_n, data_n) -> (mu,)`` over the static ``unary_nodes``
    fixes the gauge (e.g. the pose-0 anchor), ``unary_data`` leaves
    (B, len(unary_nodes), ...).  Edges with j == i+1 form the tridiagonal
    backbone; every other edge owns ``me`` columns of U.  Sums over edges
    (g, D, B) are fixed-order :class:`~.ops.sparse_sym.SegmentSum`\\ s, so
    a run on the card gives the same sums every time."""
    x0 = mf.as_pytree(x0)
    leaves = pytree.tree_leaves(x0)
    N = int(leaves[0].shape[0])
    dev = leaves[0].device
    x_ex = pytree.tree_map(lambda l: l[0], x0)
    spec_e = mf.tangent_spec(x_ex)
    d = spec_e.dims
    dtype = spec.dtype

    edges = _edges_np(edges)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2) ints, got {edges.shape}")
    if np.any(edges[:, 0] == edges[:, 1]):
        raise ValueError("self-edges (i == j) are not binary "
                         "measurements; use unary_fn for priors")
    edges = edges.astype(np.int64)
    E = edges.shape[0]
    chain_sel = np.where(edges[:, 1] == edges[:, 0] + 1)[0]
    loop_sel = np.where(edges[:, 1] != edges[:, 0] + 1)[0]
    Lc = int(loop_sel.size)

    def first(data):
        return None if data is None else pytree.tree_map(
            lambda l: l[0, 0], data)

    def edge_r(a, b, dd):
        return flatten_residuals(edge_fn(a, b, dd)).to(dtype)

    me = int(edge_r(x_ex, x_ex, first(edge_data)).numel())
    mu = 0
    if unary_fn is not None:
        unary_nodes = np.asarray(unary_nodes, np.int64).ravel()

        def unary_r(a, dd):
            return flatten_residuals(unary_fn(a, dd)).to(dtype)

        mu = int(unary_r(x_ex, first(unary_data)).numel())
    n_res = E * me + (len(unary_nodes) * mu if unary_fn is not None else 0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    ei, ej = t(edges[:, 0]), t(edges[:, 1])
    cc = edges[chain_sel, 0]
    # g over every edge endpoint (loops included) and the unary nodes; D
    # over the chain edges' endpoints and the unary nodes; B over the
    # chain edges
    un = unary_nodes if unary_fn is not None else np.zeros(0, np.int64)
    g_sum = SegmentSum(np.concatenate([edges[:, 0], edges[:, 1], un]), N,
                       dev)
    D_sum = SegmentSum(np.concatenate([cc, cc + 1, un]), N, dev)
    B_sum = SegmentSum(cc, max(N - 1, 0), dev)
    chain_t, loop_t = t(chain_sel), t(loop_sel)
    li, lj, ar = t(edges[loop_sel, 0]), t(edges[loop_sel, 1]), t(
        np.arange(Lc))
    un_t = t(un)
    em2gl = mf.element_perm(x0, N)
    gl2em = None
    if em2gl is not None:
        gl2em = t(np.argsort(em2gl))
        em2gl = t(em2gl)

    def gather(x, idx):
        return pytree.tree_map(lambda l: l[:, idx], x)

    # (r, J) of one edge: one joint 2d-tangent Jacobian, sharing the primal
    # across both blocks.  Reverse mode, where the JAX package takes
    # jacfwd: torch's forward mode runs a Python decomposition for every
    # operation that mixes a constant with a dual tensor (its zero
    # tangent), and an LM iteration of the 5,000-pose graph on an H100
    # took 214 ms with it against 103 ms in reverse mode (chip_smoke.py
    # phase 17, run alone)
    def lin_edge(a, b, dd):
        def r_of(tv):
            return edge_r(mf.retract(a, tv[:d], spec_e),
                          mf.retract(b, tv[d:], spec_e), dd)

        def r_aux(tv):
            r = r_of(tv)
            return r, r

        z = torch.zeros((2 * d,), dtype=dtype, device=dev)
        J, r = torch.func.jacrev(r_aux, has_aux=True)(z)
        return r, J.to(dtype)

    def lin_unary(a, dd):
        def r_aux(tv):
            r = unary_r(mf.retract(a, tv, spec_e), dd)
            return r, r

        z = torch.zeros((d,), dtype=dtype, device=dev)
        J, r = torch.func.jacrev(r_aux, has_aux=True)(z)
        return r, J.to(dtype)

    edge_lin = _vmap2(lin_edge, 2, edge_data)
    edge_res = _vmap2(edge_r, 2, edge_data)
    if unary_fn is not None:
        unary_lin = _vmap2(lin_unary, 1, unary_data)
        unary_res = _vmap2(unary_r, 1, unary_data)

    def seg(summer, v):
        """Segment sum over axis 1 of ``v`` (B, k, ...)."""
        v = v.movedim(1, -1)
        return summer(v).movedim(-1, 1)

    def accumulate(x):
        xp = mf.unflatten(x, spec)
        Bn = x.shape[0]
        r, J = edge_lin(gather(xp, ei), gather(xp, ej), edge_data)
        Ji, Jj = J[..., :d], J[..., d:]                  # (B, E, me, d)
        rss = torch.sum(r * r, dim=(-2, -1))
        gi = torch.einsum("bema,bem->bea", Ji, r)
        gj = torch.einsum("bema,bem->bea", Jj, r)
        Jic, Jjc = Ji[:, chain_t], Jj[:, chain_t]
        Dparts = [torch.einsum("bema,bemc->beac", Jic, Jic),
                  torch.einsum("bema,bemc->beac", Jjc, Jjc)]
        gparts = [gi, gj]
        if unary_fn is not None:
            ru, Ju = unary_lin(gather(xp, un_t), unary_data)
            rss = rss + torch.sum(ru * ru, dim=(-2, -1))
            gparts.append(torch.einsum("bnma,bnm->bna", Ju, ru))
            Dparts.append(torch.einsum("bnma,bnmc->bnac", Ju, Ju))
        g = seg(g_sum, torch.cat(gparts, dim=1))      # (B, N, d)
        D = seg(D_sum, torch.cat(Dparts, dim=1))      # (B, N, d, d)
        Bs = seg(B_sum, torch.einsum("bema,bemc->beac", Jjc, Jic))
        # loop closures: Woodbury columns, each edge owning its me columns
        U4 = x.new_zeros((Bn, N, Lc, d, me), dtype=dtype)
        if Lc:
            U4[:, li, ar] = Ji[:, loop_t].mT
            U4[:, lj, ar] = Jj[:, loop_t].mT
        U = U4.permute(0, 1, 3, 2, 4).reshape(Bn, N, d, Lc * me)
        diag = (torch.diagonal(D, dim1=-2, dim2=-1)
                + torch.einsum("bndm,bndm->bnd", U, U))
        g_flat = g.reshape(Bn, N * d)
        if em2gl is not None:
            g_flat = g_flat[:, em2gl]
        return (ChainSystem(D, Bs, U, diag), g_flat,
                Cost.make(rss, n_res))

    def evaluate(x):
        xp = mf.unflatten(x, spec)
        r = edge_res(gather(xp, ei), gather(xp, ej), edge_data)
        rss = torch.sum(r * r, dim=(-2, -1))
        if unary_fn is not None:
            ru = unary_res(gather(xp, un_t), unary_data)
            rss = rss + torch.sum(ru * ru, dim=(-2, -1))
        return Cost.make(rss, n_res)

    eye = torch.eye(d, dtype=dtype, device=dev)

    def damped(H: ChainSystem, lam):
        lam = lam.to(H.dtype)[:, None, None]
        add = torch.where(H.diag == 0, lam, H.diag * lam)
        return H.D + eye * add[..., None, :]

    if method not in ("auto", "scan", "cr"):
        raise ValueError(f"method must be auto|scan|cr, got {method!r}")

    def solve_at(H: ChainSystem, g, lam_or_none):
        Dd = H.D if lam_or_none is None else damped(H, lam_or_none)
        how = method if method != "auto" else (
            "cr" if H.D.is_cuda else "scan")
        g2 = (g if gl2em is None else g[:, gl2em]).reshape(-1, N, d)
        dx2, ok = tridiag_woodbury_solve(Dd, H.B, H.U, -g2, method=how)
        dx = dx2.reshape(-1, N * d)
        if em2gl is not None:
            dx = dx[:, em2gl]
        return dx, ok

    def propose(H: ChainSystem, g, lam, opts):
        if opts.solver_type == SolverType.DOGLEG:
            dx_gn, ok_gn = solve_at(H, g, None)
            g_em = g if gl2em is None else g[:, gl2em]
            gHg = torch.sum(g_em * H.matvec(g_em), dim=-1)
            return dogleg_core(g, lam, dx_gn, ok_gn, gHg,
                               lambda le: solve_at(H, g, le))
        is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
        return solve_at(H, g, lam if is_lm else None)

    return accumulate, evaluate, n_res, propose


def _batch_data(data):
    return None if data is None else pytree.tree_map(
        lambda a: torch.as_tensor(a)[None], data)


def chain_optimize(x0, edge_fn: Callable, edges, edge_data=None,
                   options: Options | None = None, *,
                   unary_fn: Callable | None = None, unary_nodes=None,
                   unary_data=None, method: str = "auto"):
    """Solve a chain-structured NLLS graph (pose graph / odometry SLAM).

    ``x0``: a parameter pytree of N blocks, a leading axis N on every leaf
    (e.g. a batched SE3 trajectory).  ``edge_fn(x_i, x_j, data_e) ->
    (me,)`` evaluates one binary measurement of the static (E, 2)
    ``edges`` (``edge_data`` leaves have a leading axis E).  Edges with
    j == i+1 form the block-tridiagonal odometry backbone, solved exactly;
    every other edge is a loop closure folded in by the Woodbury identity.
    ``unary_fn(x_n, data_n)`` over ``unary_nodes`` adds priors (fix the
    gauge by anchoring a pose).  ``method``: "auto" ("cr" on CUDA, "scan"
    on the CPU), "scan" or "cr".  Returns ``(x_opt, Output)``; LM / GN /
    DogLeg.  ``Output.final_hessian`` is a :class:`ChainSystem`."""
    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "chain_optimize is a Gauss-Newton/LM method; use to.optimize "
            "with a first-order solver type for gradient-only solves")
    x0 = mf.as_pytree(x0)
    spec = mf.tangent_spec(x0)
    acc, ev, _, propose = chain_system(
        x0, edge_fn, edges, _batch_data(edge_data), unary_fn, unary_nodes,
        _batch_data(unary_data), spec, method=method)
    xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x0), spec)
    x, out = optimize_from_acc(xb, acc, ev, options, spec, propose=propose)
    return (pytree.tree_map(lambda a: a[0], mf.unflatten(x, spec)),
            map_output(lambda v: v[0], out))


def chain_marginals(x, edge_fn: Callable, edges, edge_data=None, *,
                    unary_fn: Callable | None = None, unary_nodes=None,
                    unary_data=None, rescaled: bool = False):
    """Per-block posterior marginal covariance of a chain-graph solution.

    The covariance companion of :func:`chain_optimize`: call it at the
    solution ``x`` with the same graph.  Returns ``marg (N, d, d)``, the
    diagonal blocks of H(x)⁻¹ (element-major tangent layout a block) by
    the selected-inverse recursion off the block-tridiagonal factor with
    the Woodbury loop-closure downdate — O(N·d³ + N·d²·m), so a 5,000-pose
    graph's marginals cost about one more factorization instead of the
    (N·d)² dense inverse.  ``rescaled=True`` applies the reference's
    overdetermined rescale ``cost²/(n_res − dims)`` (output.h:80-93), as
    ``Output.covariance(rescaled=True)`` does.  NaN if H is singular (gauge
    not fixed)."""
    x = mf.as_pytree(x)
    spec = mf.tangent_spec(x)
    acc, _, _, _ = chain_system(
        x, edge_fn, edges, _batch_data(edge_data), unary_fn, unary_nodes,
        _batch_data(unary_data), spec)
    xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x), spec)
    H, _, cost = acc(xb)
    marg = H.marginals()[0]
    if rescaled:
        marg = marg * cov_rescale(cost.cost[0], cost.num_residuals[0],
                                  spec.dims).to(marg.dtype)
    return marg
