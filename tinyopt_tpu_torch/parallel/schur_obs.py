"""Mesh-sharded sparse-observation Schur bundle adjustment.

Counterpart of ``tinyopt_tpu.parallel.schur_obs``: the point-major
observation layout (``ops/schur_obs.py``, O(n_obs) state) split over a mesh
axis by its LANDMARK axis.  The algebra is the single-device path's:

* each rank holds a contiguous slab of landmarks (its rows of obs /
  cam_idx / mask and of the C / E / g_b state) and runs the slab's
  per-point passes, planned once from its own host indices
  (``make_obs_kernels``: the camera and camera-pair ``SegmentSum``\\ s);
* the camera-side partials (Ba, g_a, cost) are completed by ONE
  all-reduce, and so are the reduced camera system's (the flat
  (n_a², da²) S grid and E C⁻¹ g_b): the only cross-landmark sums;
* the reduced solve runs replicated (its route, dense / banded / PCG, is
  picked from the GLOBAL ``cam_idx``, so every rank picks the same), and
  the landmark back-substitutions are gathered: the loop's x, g and steps
  are whole on every rank and its accept / reject never parts.

K-bucketed layouts (:func:`sharded_schur_sparse_optimize_buckets`) split
every bucket over the axis, padded to a multiple of it with mask-0 rows;
the buckets' partials are summed on the rank before the one all-reduce.
The JAX package's windowed and planned sharded reduces, its band storage
and its landmark sort are TPU layouts it runs on the TPU alone; the
per-rank ``SegmentSum`` plan takes their place here.  n_b must be
divisible by the axis: pad with mask-0 points.
"""

from __future__ import annotations

import types
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost
from ..ops.linalg import cov_rescale
from ..ops.schur import bipartite_perms
from ..ops.schur_obs import (BucketLayout, ObsLayout, SchurObsBuckets,
                             SchurObsSystem, _damp_flat, _einsum, _host,
                             _pad_rows, _point_slab, _propose,
                             _residual_dims, _slab_marginals,
                             detect_camera_bandwidth, pick_band_group)
from ..optimizers.loop import optimize_from_acc
from ..options import Options
from ._collectives import (all_gather, gather_rows, local_rows, on_device,
                           psum, row_range)
from .schur import _check_pair, _divisible


class _Problem:
    """The shapes, tangent maps and element-major views of one bipartite
    problem over flat parameters (B, P)."""

    def __init__(self, a0, b0, spec, device):
        self.a0, self.b0 = a0, b0
        self.n_a = pytree.tree_leaves(a0)[0].shape[0]
        self.n_b = pytree.tree_leaves(b0)[0].shape[0]
        self.a_ex = pytree.tree_map(lambda l: l[0], a0)
        self.b_ex = pytree.tree_map(lambda l: l[0], b0)
        self.spec = spec
        self.spec_a = mf.tangent_spec(self.a_ex)
        self.spec_b = mf.tangent_spec(self.b_ex)
        self.da, self.db = self.spec_a.dims, self.spec_b.dims
        self.em2gl, self.gl2em = bipartite_perms(
            a0, b0, self.n_a, self.n_b, self.da, self.db, device)

    def split(self, x):
        return mf.unflatten(x, self.spec)

    def parts(self, v):
        """(v_a (B, n_a, da), v_b (B, n_b, db)) of a global vector."""
        if self.gl2em is not None:
            v = v[:, self.gl2em]
        return (v[:, :self.n_a * self.da].reshape(-1, self.n_a, self.da),
                v[:, self.n_a * self.da:].reshape(-1, self.n_b, self.db))

    def whole(self, v_a, v_b):
        v = torch.cat([v_a.flatten(-2), v_b.flatten(-2)], dim=-1)
        return v if self.em2gl is None else v[:, self.em2gl]


def _ghg_slab(C, E, cam, v_a, v_b_l):
    """One slab's share of vᵀHv off the camera blocks, 2 vₐᵀE v_b +
    v_bᵀC v_b (C (B, n, db²), E (B, n, K·da·db), cam (n, K), v_b_l the
    slab's rows of v_b)."""
    K = cam.shape[1]
    da, db = v_a.shape[-1], v_b_l.shape[-1]
    E4 = E.reshape(E.shape[:-1] + (K, da, db))
    C3 = C.reshape(C.shape[:-1] + (db, db))
    Evb = _einsum("jkab,jb->jka", E4, v_b_l)
    return (2.0 * torch.sum(v_a[:, cam] * Evb, dim=(-3, -2, -1))
            + torch.sum(v_b_l * _einsum("jab,jb->ja", C3, v_b_l),
                        dim=(-2, -1)))


def _ghg_cams(Ba, v_a):
    """vₐᵀBa vₐ, replicated."""
    return torch.sum(v_a * _einsum("iab,ib->ia", Ba, v_a), dim=(-2, -1))


def make_sharded_schur_obs_system(pair_fn: Callable, a0, b0, obs, cam_idx,
                                  mask, mesh, axis, spec: mf.TangentSpec,
                                  chunk: int = 1024):
    """Landmark-sharded ``(accumulate, evaluate, n_res, make_propose)`` over
    flat parameters (1, P), the contract of ``ops.schur_obs.schur_obs_system``
    for one instance: ``obs`` leaves (n_b, K, ...) and ``cam_idx`` / ``mask``
    (n_b, K) are global; this rank keeps its landmark rows.  The
    ``SchurObsSystem`` the loop carries holds this rank's C and E."""
    a0, b0 = mf.as_pytree(a0), mf.as_pytree(b0)
    dev = mesh.device
    pb = _Problem(a0, b0, spec, dev)
    n_a, n_b, da, db, dtype = pb.n_a, pb.n_b, pb.da, pb.db, spec.dtype
    _divisible(n_b, mesh, axis, "points (padded points contribute zero "
               "residual and zero Jacobian)")
    r0, r1 = row_range(n_b, mesh, axis)
    nb_loc = r1 - r0
    cam_np = _host(cam_idx).astype(np.int64)
    real_np = _host(mask) != 0
    sl = _point_slab(pair_fn, a0, pb.spec_a, pb.spec_b, dtype, n_a,
                     pytree.tree_map(lambda l: l[None],
                                     local_rows(obs, r0, r1, 0, dev)),
                     cam_np[r0:r1], real_np[r0:r1], chunk)
    acc_slab, eval_slab, reduce_pass, backsub_pass = sl.kernels
    m = _residual_dims(pair_fn, pb.a_ex, pb.b_ex, sl.obs)
    n_res = torch.full((1,), int(np.count_nonzero(real_np)) * m,
                       dtype=torch.int32, device=dev)
    # the route from the GLOBAL co-observations: the same on every rank
    band_g = pick_band_group(detect_camera_bandwidth(cam_np, real_np), n_a,
                             da)
    layout = ObsLayout(torch.as_tensor(sl.cam_np, device=dev), sl.real,
                       pb.em2gl, pb.gl2em)

    def slab_b(x):
        a, b = pb.split(x)
        return a, pytree.tree_map(lambda l: torch.cat(
            [l[:, r0:r1], l[:, r0:r0 + 1].expand(
                (l.shape[0], sl.pad) + tuple(l.shape[2:]))], dim=1), b)

    def whole(v_a, v_b_l):
        return pb.whole(v_a, all_gather(v_b_l, mesh, axis, dim=-2))

    def accumulate(x):
        Ba_p, ga_p, E_f, C_f, g_b, rss_p = acc_slab(*slab_b(x), sl.obs,
                                                     sl.cam, sl.mask)
        Ba, g_a, rss = psum((Ba_p, ga_p, rss_p), mesh, axis)
        H = SchurObsSystem(Ba, C_f[:, :nb_loc], E_f[:, :nb_loc], layout)
        return H, whole(g_a, g_b[:, :nb_loc]), Cost.make(rss, n_res)

    def evaluate(x):
        (rss,) = psum([eval_slab(*slab_b(x), sl.obs, sl.cam, sl.mask)],
                      mesh, axis)
        return Cost.make(rss, n_res)

    def reduce_inputs(H: SchurObsSystem, Cd_flat, g):
        g_a, g_b = pb.parts(g)
        return (g_a, _pad_rows(g_b[:, r0:r1], sl.pad),
                _pad_rows(H.E, sl.pad), _pad_rows(Cd_flat, sl.pad))

    def reduce(E_p, Cd_p, g_b):
        S_f, rhs, Cinv = reduce_pass(E_p, Cd_p, sl.cam, g_b)
        S_f, rhs = psum((S_f, rhs), mesh, axis)
        return S_f, rhs, Cinv

    def backsub(E_p, Cinv_f, g_b, dx_a):
        return all_gather(backsub_pass(E_p, Cinv_f, sl.cam, g_b,
                                       dx_a)[:, :nb_loc], mesh, axis, dim=-2)

    def ghg(H: SchurObsSystem, g):
        v_a, v_b = pb.parts(g)
        t = _ghg_slab(H.C, H.E, layout.cam, v_a, v_b[:, r0:r1])
        return _ghg_cams(H.Ba, v_a) + psum([t], mesh, axis)[0]

    propose = _propose(
        types.SimpleNamespace(reduce_inputs=reduce_inputs, reduce=reduce,
                              backsub=backsub, band_group=band_g, ghg=ghg),
        pb.em2gl, lambda C, lam: _damp_flat(C, db, lam))

    def make_propose(opts: Options):
        return lambda H, g, lam, _opts: propose(H, g, lam, opts)

    return accumulate, evaluate, n_res, make_propose


def _solve(x0, spec, acc, ev, propose, options):
    from ..sparse import _batch_tree
    return optimize_from_acc(mf.flatten_batch(_batch_tree(x0), spec), acc,
                             ev, options, spec, propose=propose)


def sharded_schur_sparse_optimize(x0: tuple, pair_fn: Callable, obs, cam_idx,
                                  mask, options: Options | None = None, *,
                                  mesh=None, axis="block", chunk: int = 1024):
    """Landmark-sharded sparse-observation BA over the mesh: ``((a, b),
    Output)``.

    The contract of ``sparse.schur_sparse_optimize`` — the same point-major
    obs / cam_idx / mask, Output semantics and trajectory up to the order of
    the sums.  Every rank passes the same global inputs and returns the
    same result; ``Output.final_hessian`` is the whole
    ``SchurObsSystem``."""
    from ..sparse import _batch_of_one
    from .mesh import local_mesh

    options = options or Options()
    if mesh is None:
        mesh = local_mesh(axis)
    a0, b0 = _check_pair(x0, "sharded_schur_sparse_optimize")
    x0 = tuple(on_device(mf.as_pytree(t), mesh.device) for t in (a0, b0))
    spec = mf.tangent_spec(x0)
    acc, ev, _, make_propose = make_sharded_schur_obs_system(
        pair_fn, x0[0], x0[1], obs, cam_idx, mask, mesh, axis, spec, chunk)
    x, out = _solve(x0, spec, acc, ev, make_propose(options), options)
    H = out.final_hessian
    if H is not None:
        n_b = pytree.tree_leaves(x0[1])[0].shape[0]
        C, E = gather_rows([H.C, H.E], slice(*row_range(n_b, mesh, axis)),
                           n_b, mesh, axis, dim=-2)
        out.final_hessian = SchurObsSystem(
            H.Ba, C, E, ObsLayout(torch.as_tensor(cam_idx, device=C.device),
                                  mask, H.em2gl, H.gl2em))
    return _batch_of_one(x, out, spec)


def sharded_schur_sparse_covariance(x, pair_fn: Callable, obs, cam_idx, mask,
                                    *, mesh=None, axis="block",
                                    chunk: int = 1024,
                                    rescaled: bool = False):
    """Posterior marginal covariance blocks over the mesh, the companion of
    :func:`sharded_schur_sparse_optimize` with
    ``sparse.schur_sparse_covariance``'s contract: ``(cov_a (n_a, da, da),
    cov_b (n_b, db, db))`` on every rank.  Each rank re-linearizes its
    landmark slab; S is completed over the axis, S⁻¹ and the camera
    marginals computed replicated, each rank's landmark blocks gathered."""
    from ..sparse import _batch_tree
    from .mesh import local_mesh

    if mesh is None:
        mesh = local_mesh(axis)
    a0, b0 = _check_pair(x, "sharded_schur_sparse_covariance")
    x = tuple(on_device(mf.as_pytree(t), mesh.device) for t in (a0, b0))
    spec = mf.tangent_spec(x)
    acc, _, _, _ = make_sharded_schur_obs_system(
        pair_fn, x[0], x[1], obs, cam_idx, mask, mesh, axis, spec, chunk)
    H, _, cost = acc(mf.flatten_batch(_batch_tree(x), spec))
    cov_a, (cov_b,) = _slab_marginals(
        H.Ba, [(H.E, H.C, H.layout)], chunk,
        complete=lambda S: psum([S], mesh, axis)[0])
    cov_b = all_gather(cov_b, mesh, axis, dim=-3)
    if rescaled:
        f = cov_rescale(cost.cost, cost.num_residuals, spec.dims)
        cov_a = cov_a * f[:, None, None, None]
        cov_b = cov_b * f[:, None, None, None]
    return cov_a[0], cov_b[0]


def sharded_schur_sparse_optimize_buckets(
        x0: tuple, pair_fn: Callable, slabs, options: Options | None = None,
        *, mesh=None, axis="block", chunk: int = 1024):
    """Landmark-sharded K-bucketed sparse-observation BA over the mesh:
    ``((a, b), Output)``, the contract of
    ``sparse.schur_sparse_optimize_buckets`` (``slabs`` of ``(obs, cam_idx,
    mask, ids)``, ``x0`` in the original landmark order).

    Every bucket's rows are split over the axis, padded to a multiple of it
    with mask-0 rows (exact zero contributions); each rank runs its rows of
    every bucket through the bucket's per-point passes, sums the camera-side
    and reduced-system partials over its buckets, and ONE all-reduce each
    completes them; the reduced solve covers all buckets, replicated, and
    the landmark steps of every bucket are gathered in one all-reduce."""
    from ..sparse import _batch_of_one
    from .mesh import local_mesh

    options = options or Options()
    if mesh is None:
        mesh = local_mesh(axis)
    a0, b0 = _check_pair(x0, "sharded_schur_sparse_optimize_buckets")
    x0 = tuple(on_device(mf.as_pytree(t), mesh.device) for t in (a0, b0))
    spec = mf.tangent_spec(x0)
    dev = mesh.device
    pb = _Problem(x0[0], x0[1], spec, dev)
    n_a, n_b, da, db, dtype = pb.n_a, pb.n_b, pb.da, pb.db, spec.dtype
    size, rank = mesh.size(axis), mesh.index(axis)

    ids_np = [_host(s[3]).astype(np.int64).reshape(-1) for s in slabs]
    ids_all = np.concatenate(ids_np)
    if ids_all.size != n_b or np.any(np.sort(ids_all) != np.arange(n_b)):
        raise ValueError(
            "bucket ids must partition the landmark axis: every "
            f"landmark index 0..{n_b - 1} exactly once "
            f"(got {ids_all.size} ids)")
    buckets, n_real_slots = [], 0
    for (obs, ci, mk, _), ids in zip(slabs, ids_np):
        ci_np, real_np = _host(ci).astype(np.int64), _host(mk) != 0
        n_g = ci_np.shape[0]
        n_real_slots += int(np.count_nonzero(real_np))
        ng_loc = -(-n_g // size)              # the bucket padded to the mesh
        q0 = rank * ng_loc
        n_own = max(0, min(ng_loc, n_g - q0))  # this rank's real rows
        pad = ng_loc - n_own

        def own(a, n_own=n_own, q0=q0, pad=pad):
            return np.concatenate([a[q0:q0 + n_own],
                                   np.zeros((pad,) + a.shape[1:], a.dtype)])

        obs_l = pytree.tree_map(
            lambda l, pad=pad: torch.cat(
                [l, l.new_zeros((pad,) + tuple(l.shape[1:]))])[None],
            local_rows(obs, q0, q0 + n_own, 0, dev))
        bk = _point_slab(pair_fn, x0[0], pb.spec_a, pb.spec_b, dtype, n_a,
                         obs_l, own(ci_np), own(real_np), chunk)
        bk.n_own = n_own
        bk.ids = torch.as_tensor(np.concatenate(
            [ids[q0:q0 + n_own], np.full(pad, ids[0])]), device=dev)
        bk.q0, bk.n_g = q0, n_g
        bk.global_layout = (ci, mk, ids)
        buckets.append(bk)
    m = _residual_dims(pair_fn, pb.a_ex, pb.b_ex, buckets[0].obs)
    n_res = torch.full((1,), n_real_slots * m, dtype=torch.int32, device=dev)
    # the route from the union of the GLOBAL buckets' co-observations
    band_g = pick_band_group(max(
        (detect_camera_bandwidth(_host(ci), _host(mk)) for _, ci, mk, _ in
         slabs), default=0), n_a, da)
    own_ids = torch.cat([bk.ids[:bk.n_own] for bk in buckets])
    layout = BucketLayout(
        [ObsLayout(torch.as_tensor(bk.cam_np, device=dev), bk.real,
                   ids=bk.ids) for bk in buckets], None, pb.em2gl, pb.gl2em)

    def slab_b(b, bk):
        """The bucket's rows on this rank (mesh-pad rows: a copy of the
        bucket's first landmark, masked), padded to its chunks."""
        def leaf(l):
            l = l[:, bk.ids]
            return torch.cat([l, l[:, :1].expand(
                (l.shape[0], bk.pad) + tuple(l.shape[2:]))], dim=1)
        return pytree.tree_map(leaf, b)

    def landmark_rows(rows):
        """(B, n_b, k) from each bucket's own rows (B, n_own, k), in the
        original landmark order, replicated (one all-reduce)."""
        return gather_rows([torch.cat(rows, dim=-2)], own_ids, n_b, mesh,
                           axis, dim=-2)[0]

    def bucket_rows(v_b, bk):
        """This rank's rows of the bucket of a (B, n_b, k) array (mesh-pad
        rows zero)."""
        rows = v_b[:, bk.ids]
        return torch.cat([rows[:, :bk.n_own], torch.zeros_like(
            rows[:, bk.n_own:])], dim=1)

    def accumulate(x):
        a, b = pb.split(x)
        parts, C, E, g_b = None, [], [], []
        for bk in buckets:
            Ba_g, ga_g, E_f, C_f, gb_g, rss_g = bk.kernels[0](
                a, slab_b(b, bk), bk.obs, bk.cam, bk.mask)
            parts = ([Ba_g, ga_g, rss_g] if parts is None else
                     [p + q for p, q in zip(parts, (Ba_g, ga_g, rss_g))])
            C.append(C_f[:, :bk.n])
            E.append(E_f[:, :bk.n])
            g_b.append(gb_g[:, :bk.n_own])
        Ba, g_a, rss = psum(parts, mesh, axis)
        return (SchurObsBuckets(Ba, tuple(C), tuple(E), layout),
                pb.whole(g_a, landmark_rows(g_b)), Cost.make(rss, n_res))

    def evaluate(x):
        a, b = pb.split(x)
        rss = sum(bk.kernels[1](a, slab_b(b, bk), bk.obs, bk.cam, bk.mask)
                  for bk in buckets)
        return Cost.make(psum([rss], mesh, axis)[0], n_res)

    def reduce_inputs(H: SchurObsBuckets, Cd, g):
        g_a, g_b = pb.parts(g)
        return (g_a, [_pad_rows(bucket_rows(g_b, bk), bk.pad)
                      for bk in buckets],
                [_pad_rows(E_g, bk.pad) for bk, E_g in zip(buckets, H.E)],
                [_pad_rows(C_g, bk.pad) for bk, C_g in zip(buckets, Cd)])

    def reduce(E_p, Cd_p, g_b):
        S_f = rhs = None
        cinv = []
        for bk, E_g, Cd_g, gb_g in zip(buckets, E_p, Cd_p, g_b):
            S_g, rhs_g, Cinv_g = bk.kernels[2](E_g, Cd_g, bk.cam, gb_g)
            S_f, rhs = ((S_g, rhs_g) if S_f is None else
                        (S_f + S_g, rhs + rhs_g))
            cinv.append(Cinv_g)
        S_f, rhs = psum((S_f, rhs), mesh, axis)
        return S_f, rhs, cinv

    def backsub(E_p, Cinv, g_b, dx_a):
        return landmark_rows([
            bk.kernels[3](E_g, Ci_g, bk.cam, gb_g, dx_a)[:, :bk.n_own]
            for bk, E_g, Ci_g, gb_g in zip(buckets, E_p, Cinv, g_b)])

    def ghg(H: SchurObsBuckets, g):
        v_a, v_b = pb.parts(g)
        t = sum(_ghg_slab(C_g, E_g, bk.cam[:bk.n], v_a, bucket_rows(v_b, bk))
                for bk, C_g, E_g in zip(buckets, H.C, H.E))
        return _ghg_cams(H.Ba, v_a) + psum([t], mesh, axis)[0]

    propose = _propose(
        types.SimpleNamespace(reduce_inputs=reduce_inputs, reduce=reduce,
                              backsub=backsub, band_group=band_g, ghg=ghg),
        pb.em2gl, lambda C, lam: tuple(_damp_flat(c, db, lam) for c in C))
    x, out = _solve(x0, spec, accumulate, evaluate, propose, options)
    H = out.final_hessian
    if H is not None:
        C, E, lays = [], [], []
        for bk, C_g, E_g in zip(buckets, H.C, H.E):
            ci, mk, ids = bk.global_layout
            Cw, Ew = gather_rows([C_g[:, :bk.n_own], E_g[:, :bk.n_own]],
                                 slice(bk.q0, bk.q0 + bk.n_own), bk.n_g,
                                 mesh, axis, dim=-2)
            C.append(Cw)
            E.append(Ew)
            lays.append(ObsLayout(torch.as_tensor(ci, device=dev), mk,
                                  ids=torch.as_tensor(ids, device=dev)))
        out.final_hessian = SchurObsBuckets(H.Ba, tuple(C), tuple(E),
                                            BucketLayout(
            lays, torch.as_tensor(np.argsort(ids_all), device=dev),
            pb.em2gl, pb.gl2em))
    return _batch_of_one(x, out, spec)
