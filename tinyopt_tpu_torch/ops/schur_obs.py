"""Sparse-observation Schur elimination (point-major padded layout),
batched.

Counterpart of ``tinyopt_tpu.ops.schur_obs``.  The dense-grid Schur path
(``ops/schur.py``) stores every (camera, landmark) pair; real visibility
is sparse, each landmark seen by a handful of cameras, so this module
stores exactly the observations, in the point-major padded layout of
production BA solvers (Agarwal et al., "Bundle Adjustment in the Large"):

* ``obs``      — pytree, leaves (B, n_b, K, ...): per-landmark data for up
                 to K observations (padded), one row of B per instance;
* ``cam_idx``  — (n_b, K) ints: which camera made each observation;
* ``mask``     — (n_b, K): 1 for real slots (a padded slot contributes
                 exactly zero residual AND Jacobian).

``cam_idx`` and ``mask`` are one static topology for the whole batch:
every sum over a camera or a camera pair is a fixed-order
:class:`~.sparse_sym.SegmentSum` planned once on the host from them
(never ``index_add_``, whose atomics make a float sum's order vary on the
card).  Memory is O(n_b · K) instead of O(n_a · n_b).

Per-point state is stored flat as in the JAX package: E as
(B, n_b, K·da·db) slot-major, C as (B, n_b, db²).  The per-point passes
(:func:`make_obs_kernels`) run over the point axis padded to a multiple of
``chunk`` points, a slab of whole chunks at a time, a slab as large as
``_SLAB_ELEMS`` elements of its largest transient allow (the JAX package's
chunk loop bounds the TPU's tile-padded transients; here one slab covers
bench_ba_sparse's 50,000 landmarks).  The reduce gives the reduced camera
system S = X + Xᵀ + diag from the strict-lower slot pairs only, plus
E C⁻¹ g_b and C⁻¹ stored for each point — the same sums as the JAX
package's planned and scatter reduces, up to summation order.  The
reduced solve is the dense Cholesky, its mixed-precision refinement, a
block-Jacobi PCG, or, where the cameras are banded (a corridor rig), block
cyclic reduction over groups of cameras (``ops/tridiag.py``).

Heavy-tailed visibility (published BAL problems: a few observations a
landmark, hundreds for the densest) runs K-bucketed: :func:`bucket_obs`
groups the landmarks by observation count into slabs with caps growing
geometrically, and :func:`schur_obs_bucket_system` /
:class:`SchurObsBuckets` run each slab through the same per-point passes
and sum the reduced camera system over them.  The JAX package's window
reduce, its band storage and its landmark sort are layouts of the TPU,
which it runs on the TPU alone; they are not here.

Same loop contract as ``ops/schur.py``: ``accumulate`` returns a
:class:`SchurObsSystem` as the loop's Hessian, ``propose`` eliminates
with multiplicative (1+λ) block damping; GN / LM / DogLeg.  Float32
products are exact only while TF32 is off (torch's default for matmuls;
the JAX package evaluates these contractions as exact elementwise
products for the same reason).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost
from ..diff.auto import flatten_residuals
from ..options import SolverType
from .linalg import inv_cov, pcg_core, refine_psd_solve, solve_psd
from .sparse_sym import SegmentSum, _DenseCov

#: The largest per-slab transient of the point passes, in elements (the
#: reduce's pair blocks, the marginal pass's S⁻¹ block gather).
_SLAB_ELEMS = 1 << 26

#: Reduced camera solves by route, counted by :func:`assemble_reduced`:
#: "dense" (Cholesky, with or without refinement), "pcg", "banded".
SOLVES = {"dense": 0, "pcg": 0, "banded": 0}


def _einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over any leading instance axes."""
    ins, out = spec.split("->")
    return torch.einsum(",".join("..." + s for s in ins.split(","))
                        + "->..." + out, *ops)


def spd_inv_blocks(C: torch.Tensor) -> torch.Tensor:
    """Inverse of every SPD block of ``C`` (..., db, db), NaN where a block
    is not positive definite.

    db ≤ 3: the closed-form adjugate inverse, elementwise arithmetic with
    positive-definiteness decided by Sylvester's leading principal minors,
    so a non-PD block comes out NaN as a failed Cholesky would.  db > 3: a
    Cholesky inverse of the symmetric part (C + Cᵀ)/2, as JAX's
    ``cholesky`` factors it; ``torch.linalg.cholesky`` raises on a non-PD
    block where JAX returns NaN, so ``cholesky_ex`` runs and the blocks
    whose ``info`` is not 0 are set to NaN.  Either way the NaN reaches the
    proposal's ``ok`` and the loop escalates λ."""
    db = C.shape[-1]
    nan = torch.full((), float("nan"), dtype=C.dtype, device=C.device)
    one = torch.ones((), dtype=C.dtype, device=C.device)
    if db == 1:
        a = C[..., 0, 0]
        pd = a > 0
        return torch.where(pd, 1.0 / torch.where(pd, a, one),
                           nan)[..., None, None]
    if db == 2:
        a, b, d = C[..., 0, 0], C[..., 0, 1], C[..., 1, 1]
        det = a * d - b * b
        pd = (a > 0) & (det > 0)
        inv_det = 1.0 / torch.where(pd, det, one)
        Ci = (torch.stack([d, -b, -b, a], dim=-1).reshape(C.shape)
              * inv_det[..., None, None])
        return torch.where(pd[..., None, None], Ci, nan)
    if db == 3:
        a, b, c = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
        d, e, f = C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]
        A = d * f - e * e                   # cofactors (symmetric)
        B = c * e - b * f
        Cc = b * e - c * d
        D = a * f - c * c
        E = b * c - a * e
        F = a * d - b * b
        det = a * A + b * B + c * Cc
        pd = (a > 0) & (F > 0) & (det > 0)  # leading principal minors
        inv_det = 1.0 / torch.where(pd, det, one)
        Ci = (torch.stack([A, B, Cc, B, D, E, Cc, E, F], dim=-1)
              .reshape(C.shape) * inv_det[..., None, None])
        return torch.where(pd[..., None, None], Ci, nan)
    L, info = torch.linalg.cholesky_ex((C + C.mT) / 2)
    eye = torch.eye(db, dtype=C.dtype, device=C.device).expand(C.shape)
    Ci = torch.cholesky_solve(eye, L)
    return torch.where((info == 0)[..., None, None], Ci, nan)


# --------------------------------------------------------------------------
# Static plans: the point slabs and the camera / camera-pair sums
# --------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pairs(K: int):
    """The strict-lower slot pairs (k > l): two (K(K-1)/2,) int arrays."""
    ks = np.asarray([k for k in range(K) for l in range(k)], np.int64)
    ls = np.asarray([l for k in range(K) for l in range(k)], np.int64)
    return ks, ls


def _padded_points(n_b: int, chunk: int) -> int:
    """The point count padded to a multiple of the chunk (JAX's rule)."""
    step = min(chunk, max(n_b, 1))
    return int(-(-n_b // step) * step)


def _pick_chunk(n_bp: int, requested: int) -> int:
    """Largest divisor of n_bp that is <= requested (n_bp is padded to a
    multiple of the requested chunk at build time, so this is exact)."""
    ch = min(requested, n_bp)
    while n_bp % ch:
        ch -= 1
    return ch


def _slabs(n_p: int, CH: int, per_point: int) -> list:
    """[(p0, p1)]: the point axis in slabs of whole chunks, each at most
    ``_SLAB_ELEMS`` elements of a ``per_point``-wide transient (one chunk
    at least)."""
    step = max(1, _SLAB_ELEMS // max(per_point * CH, 1)) * CH
    return [(p, min(p + step, n_p)) for p in range(0, max(n_p, 1), step)]


class _RowSum:
    """A :class:`SegmentSum` over the real rows of a static row list: rows
    ``take`` (None: all) of a (..., R, w) tensor, summed along the row
    axis into (..., n_out, w)."""

    def __init__(self, seg, real, n_out: int, device):
        seg = np.asarray(seg, np.int64).reshape(-1)
        real = np.asarray(real, bool).reshape(-1)
        self.take = None if real.all() else torch.as_tensor(
            np.flatnonzero(real), device=device)
        self.summer = SegmentSum(seg[real], n_out, device)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        if self.take is not None:
            rows = rows.index_select(-2, self.take)
        return self.summer(rows, dim=-2)


class _ReducePlan:
    """The static sums of one padded point-major layout (host-built once):
    the point slabs, and for each slab the camera sum of its real slots
    and the camera-pair sum of its real strict-lower slot pairs into the
    layout's distinct pairs; ``densify`` places the pair sums in the flat
    (n_a², w) camera-pair grid by one gather (absent pairs read a zero)."""

    def __init__(self, cam_np, mask_np, n_a: int, K: int, CH: int,
                 per_point: int, device):
        cam = np.asarray(cam_np, np.int64)
        n_p = cam.shape[0]
        real = (np.ones(cam.shape, bool) if mask_np is None
                else np.asarray(mask_np) != 0)
        ks, ls = _pairs(K)
        pair_id = cam[:, ks] * n_a + cam[:, ls]
        pair_real = real[:, ks] & real[:, ls]
        uids = np.unique(pair_id[pair_real])
        self.n_pair = int(uids.size)
        out_map = np.full(n_a * n_a, self.n_pair, np.int64)
        out_map[uids] = np.arange(self.n_pair)
        self.out_map = torch.as_tensor(out_map, device=device)
        self.slabs = _slabs(n_p, CH, per_point)
        self.slot_sums, self.pair_sums = [], []
        for p0, p1 in self.slabs:
            self.slot_sums.append(_RowSum(cam[p0:p1], real[p0:p1], n_a,
                                          device))
            pid = pair_id[p0:p1]
            self.pair_sums.append(_RowSum(
                np.searchsorted(uids, pid), pair_real[p0:p1], self.n_pair,
                device))

    def densify(self, pair_rows: torch.Tensor) -> torch.Tensor:
        """(..., n_pair, w) pair sums -> the flat (..., n_a², w) grid."""
        zero = pair_rows.new_zeros(pair_rows.shape[:-2]
                                   + (1, pair_rows.shape[-1]))
        return torch.cat([pair_rows, zero], dim=-2).index_select(
            -2, self.out_map)


class ObsLayout:
    """The static topology of a :class:`SchurObsSystem`: ``cam_idx``
    (n_b, K), which slots are real, the element-major <-> global tangent
    maps (None where they coincide, see ``ops/schur.bipartite_perms``),
    and the camera sum of the slots for :meth:`SchurObsSystem.matvec`.
    Pytree context of the system, compared by identity, so a per-instance
    select of the loop touches the blocks only.  As one bucket of a
    :class:`SchurObsBuckets` it also holds ``ids``, the bucket's landmarks
    (a device index tensor; None for the whole landmark axis in order)."""

    def __init__(self, cam_idx, mask=None, em2gl=None, gl2em=None,
                 ids=None):
        self.cam_np = _host(cam_idx).astype(np.int64)
        self.mask_np = (np.ones(self.cam_np.shape, bool) if mask is None
                        else _host(mask) != 0)
        dev = cam_idx.device if isinstance(cam_idx, torch.Tensor) else None
        self.cam_idx = torch.as_tensor(cam_idx, device=dev)
        self.cam = torch.as_tensor(self.cam_np, device=dev)
        self.em2gl, self.gl2em = em2gl, gl2em
        self.ids = ids
        self._slot_sum = None

    def slot_sum(self, n_a: int) -> _RowSum:
        """The camera sum of the (n_b·K) slot rows, built on first use."""
        if self._slot_sum is None:
            self._slot_sum = _RowSum(self.cam_np, self.mask_np, n_a,
                                     self.cam.device)
        return self._slot_sum


@dataclasses.dataclass
class SchurObsSystem:
    """Arrow system in sparse-observation form (the loop's Hessian).

    Per-point blocks are stored FLAT: ``C`` is (..., n_b, db²) row-major,
    ``E`` is (..., n_b, K·da·db) in slot-major (k, a, b) order; the leading
    axes are the instances.  ``layout`` (:class:`ObsLayout`) holds the
    static ``cam_idx`` and tangent maps.  ``matvec``, ``to_dense`` and
    ``inv`` use the loop's global tangent layout."""

    Ba: torch.Tensor     #: (..., n_a, da, da) camera diagonal blocks
    C: torch.Tensor      #: (..., n_b, db*db) landmark diagonal blocks, flat
    E: torch.Tensor      #: (..., n_b, K*da*db) couplings, flat
    layout: ObsLayout

    @property
    def cam_idx(self) -> torch.Tensor:
        return self.layout.cam_idx

    @property
    def em2gl(self):
        return self.layout.em2gl

    @property
    def gl2em(self):
        return self.layout.gl2em

    def _dims(self):
        n_a, da = self.Ba.shape[-3], self.Ba.shape[-1]
        n_b = self.C.shape[-2]
        K = self.layout.cam_np.shape[1]
        db = math.isqrt(self.C.shape[-1])
        return n_a, da, n_b, db, K

    @property
    def dims(self) -> int:
        n_a, da, n_b, db, _ = self._dims()
        return n_a * da + n_b * db

    @property
    def shape(self):
        d = self.dims
        return (d, d)

    @property
    def dtype(self):
        return self.Ba.dtype

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H·v from the sparse blocks (H is never assembled); ``v``
        (..., dims) and the result in the loop's global layout."""
        _, _, n_b, db, _ = self._dims()
        return _arrow_matvec(self.Ba, [(self.E, self.C, self.layout)],
                             None, self.layout, v, n_b, db)

    def to_dense(self) -> torch.Tensor:
        """The full arrow H (..., dims, dims) in the global layout (testing
        and covariance at small n)."""
        d = self.dims
        lead = tuple(self.Ba.shape[:-3])
        eye = torch.eye(d, dtype=self.dtype, device=self.Ba.device)
        cols = eye.expand(lead + (d, d))
        return torch.func.vmap(self.matvec, in_dims=-1, out_dims=-1)(cols)

    def marginals(self, chunk: int = 1024):
        """Per-camera and per-landmark marginal covariance blocks
        (:func:`obs_marginals`) — never densifies H."""
        return obs_marginals(self, chunk)

    def inv(self) -> _DenseCov:
        """Full dense H⁻¹ (``Output.covariance``'s contract — small n
        only: it densifies).  At scale use :meth:`marginals` /
        ``schur_sparse_covariance``."""
        return _DenseCov(inv_cov(self.to_dense()))


pytree.register_pytree_node(
    SchurObsSystem, lambda s: ([s.Ba, s.C, s.E], s.layout),
    lambda v, layout: SchurObsSystem(*v, layout),
    serialized_type_name="tinyopt_tpu_torch.ops.schur_obs.SchurObsSystem")


def _arrow_matvec(Ba, slabs, inv_order, maps, v, n_b: int, db: int):
    """H·v of an arrow system whose landmarks lie in point-major slabs
    ``[(E, C, ObsLayout)]``, their rows concatenated in slab order and put
    back in landmark order by the gather ``inv_order`` (None: one slab in
    order); ``maps`` carries the em2gl / gl2em tangent maps; ``v`` and the
    result (..., dims) in the loop's global layout."""
    n_a, da = Ba.shape[-3], Ba.shape[-1]
    lead = tuple(v.shape[:-1])
    if maps.gl2em is not None:
        v = v[..., maps.gl2em]
    v_a = v[..., :n_a * da].reshape(lead + (n_a, da))
    v_b = v[..., n_a * da:].reshape(lead + (n_b, db))
    o_a = _einsum("iab,ib->ia", Ba, v_a)
    o_b = []
    for E, C, lay in slabs:
        n, K = lay.cam_np.shape
        E4 = E.reshape(E.shape[:-1] + (K, da, db))
        C3 = C.reshape(C.shape[:-1] + (db, db))
        v_g = v_b if lay.ids is None else v_b[..., lay.ids, :]
        Evb = _einsum("jkab,jb->jka", E4, v_g)       # (..., n, K, da)
        o_a = o_a + lay.slot_sum(n_a)(
            Evb.reshape(Evb.shape[:-3] + (n * K, da)))
        va_g = v_a[..., lay.cam, :]                  # (..., n, K, da)
        o_b.append(_einsum("jab,jb->ja", C3, v_g)
                   + _einsum("jkab,jka->jb", E4, va_g))
    o_b = torch.cat(o_b, dim=-2)
    if inv_order is not None:
        o_b = o_b[..., inv_order, :]
    out = torch.cat([o_a.reshape(lead + (-1,)),
                     o_b.reshape(lead + (-1,))], dim=-1)
    return out if maps.em2gl is None else out[..., maps.em2gl]


class BucketLayout:
    """The static topology of a :class:`SchurObsBuckets`: one
    :class:`ObsLayout` a bucket (its ``cam_idx`` (n_g, K_g), real slots and
    landmark ``ids``), the gather ``inv_order`` that puts the buckets'
    concatenated landmark rows back in the original order, and the
    element-major <-> global tangent maps.  Pytree context of the system,
    compared by identity."""

    def __init__(self, buckets, inv_order, em2gl=None, gl2em=None):
        self.buckets = tuple(buckets)
        self.inv_order = inv_order
        self.em2gl, self.gl2em = em2gl, gl2em


@dataclasses.dataclass
class SchurObsBuckets:
    """Arrow system over K-bucketed landmarks (the loop's Hessian).

    Published BAL visibility is heavy-tailed (a few observations a
    landmark on average, hundreds for the densest), so one (n_b, K_max)
    padded slab would hold mostly padding.  The landmarks are grouped into
    buckets by observation count instead, each its own padded slab with
    its own cap K_g.  ``C`` and ``E`` hold one entry a bucket, each in the
    flat layout of :class:`SchurObsSystem` ((..., n_g, db²) and (..., n_g,
    K_g·da·db)); the leading axes are the instances.  ``layout``
    (:class:`BucketLayout`) holds the static per-bucket topology.
    ``matvec`` uses the loop's global tangent layout."""

    Ba: torch.Tensor     #: (..., n_a, da, da) camera diagonal blocks
    C: tuple             #: per bucket (..., n_g, db*db) landmark blocks
    E: tuple             #: per bucket (..., n_g, K_g*da*db) couplings
    layout: BucketLayout

    @property
    def cam_idx(self) -> tuple:
        return tuple(b.cam_idx for b in self.layout.buckets)

    @property
    def em2gl(self):
        return self.layout.em2gl

    @property
    def gl2em(self):
        return self.layout.gl2em

    @property
    def dtype(self):
        return self.Ba.dtype

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H·v from the sparse blocks; ``v`` (..., dims) and the result in
        the loop's global layout."""
        db = math.isqrt(self.C[0].shape[-1])
        n_b = sum(c.shape[-2] for c in self.C)
        return _arrow_matvec(self.Ba, list(zip(self.E, self.C,
                                               self.layout.buckets)),
                             self.layout.inv_order, self.layout, v, n_b, db)


pytree.register_pytree_node(
    SchurObsBuckets, lambda s: ([s.Ba, s.C, s.E], s.layout),
    lambda v, layout: SchurObsBuckets(v[0], tuple(v[1]), tuple(v[2]),
                                      layout),
    serialized_type_name="tinyopt_tpu_torch.ops.schur_obs.SchurObsBuckets")


def _damp_flat(M_flat: torch.Tensor, db: int, lam) -> torch.Tensor:
    """``ops.schur._damp_blocks`` on (..., n, db²) row-major flat blocks,
    λ one a leading index."""
    pos = torch.arange(db, device=M_flat.device) * (db + 1)
    lam = torch.as_tensor(lam, dtype=M_flat.dtype, device=M_flat.device)
    lam = lam.reshape(lam.shape + (1, 1))
    diag = M_flat[..., pos]
    out = M_flat.clone()
    out[..., pos] = diag + torch.where(diag == 0, lam, diag * lam)
    return out


# --------------------------------------------------------------------------
# Linearization and the per-point passes
# --------------------------------------------------------------------------

def obs_linearize(pair_fn: Callable, a, b, obs, cam_idx, mask,
                  spec_a: mf.TangentSpec, spec_b: mf.TangentSpec, dtype):
    """Masked (r, Ja, Jb) per observation slot, for every instance.

    ``a`` / ``b`` are pytrees of elements with leading axes (B, n_a) and
    (B, n_b); ``obs`` leaves (B, n_b, K, ...); ``cam_idx`` / ``mask``
    (n_b, K).  Shapes: r (B, n_b, K, m), Ja (B, n_b, K, m, da), Jb
    (B, n_b, K, m, db).  A masked slot gives exactly zero.

    Each slot's cameras are gathered once; the Jacobian of a slot is one
    reverse-mode ``torch.func.jacrev`` over the joint (da + db) tangent,
    mapped over every slot and instance (the JAX package takes jacfwd;
    torch's forward mode runs a Python decomposition for every operation
    that mixes a constant with a dual tensor, ROADMAP F19)."""
    da, db = spec_a.dims, spec_b.dims
    cam = torch.as_tensor(cam_idx).long()
    n_b, K = cam.shape
    flat = cam.reshape(-1)
    dev = flat.device

    def slots(l):
        """(B, n_b, K, ...) -> (B, n_b·K, ...)."""
        return l.reshape((l.shape[0], n_b * K) + tuple(l.shape[3:]))

    a_g = pytree.tree_map(lambda l: l[:, flat], a)
    b_g = pytree.tree_map(lambda l: slots(l.unsqueeze(2).expand(
        (l.shape[0], n_b, K) + tuple(l.shape[2:]))), b)
    d_g = pytree.tree_map(slots, obs)
    m_g = torch.as_tensor(mask).to(dtype).reshape(-1)

    def slot(a_k, b_j, d_k, m_k):
        def r_aux(tv):
            r = flatten_residuals(pair_fn(
                mf.retract(a_k, tv[:da], spec_a),
                mf.retract(b_j, tv[da:], spec_b), d_k)).to(dtype) * m_k
            return r, r

        z = torch.zeros((da + db,), dtype=dtype, device=dev)
        J, r = torch.func.jacrev(r_aux, has_aux=True)(z)
        return r, J.to(dtype)

    r, J = torch.func.vmap(torch.func.vmap(slot),
                           in_dims=(0, 0, 0, None))(a_g, b_g, d_g, m_g)
    Bn, m = r.shape[0], r.shape[-1]
    r = r.reshape(Bn, n_b, K, m)
    J = J.reshape(Bn, n_b, K, m, da + db)
    return r, J[..., :da], J[..., da:]


def _pair_block_chunk(E_c, Cd_c, g_b_c, ks, ls, eye, dtype):
    """The per-slab elimination algebra of the reduce.

    Returns ``(Cinv_c, blocks_tri (..., CH, P_tri, da, da), blocks_diag
    (..., CH, K, da, da), rhs_rows (..., CH, K, da))``.  Padded points
    carry all-zero Cd blocks whose inverse would be NaN and poison the
    sums: exactly-zero blocks become the identity first (their E rows are
    zero, their contributions exact zeros either way)."""
    zero_blk = torch.all(Cd_c == 0, dim=-1).all(dim=-1)
    Cd_c = torch.where(zero_blk[..., None, None], eye, Cd_c)
    Cinv_c = spd_inv_blocks(Cd_c)
    EC_c = _einsum("jkab,jbc->jkac", E_c, Cinv_c).to(dtype)
    # strict-lower slot pairs only (the mirrors are transposes)
    blocks_tri = _einsum("jpac,jpbc->jpab", EC_c[..., ks, :, :],
                         E_c[..., ls, :, :]).to(dtype)
    # k == l diagonal slot pairs
    blocks_diag = _einsum("jkac,jkbc->jkab", EC_c, E_c).to(dtype)
    rhs_rows = _einsum("jkac,jc->jka", EC_c, g_b_c)
    return Cinv_c, blocks_tri, blocks_diag, rhs_rows


def _reconstruct_S(S_f, S_diag, n_a: int, da: int):
    """S(i,i') = X(i,i') + X(i',i)ᵀ + δ(i,i')·diag, flat (..., n_a², da²);
    the diagonal placed by a product with the identity, no scatter."""
    lead = tuple(S_f.shape[:-2])
    X = S_f.reshape(lead + (n_a, n_a, da, da))
    X = X + X.permute(*range(len(lead)), -3, -4, -1, -2)
    eye = torch.eye(n_a, dtype=S_f.dtype, device=S_f.device)
    X = X + eye[:, :, None, None] * S_diag.reshape(lead + (n_a, 1, da, da))
    return X.reshape(lead + (n_a * n_a, da * da))


def make_reduce_pass(n_a: int, K: int, da: int, db: int, dtype, CH: int,
                     cam_idx_np, mask_np=None, device=None):
    """The reduce of the elimination (pass A), standalone so the
    covariance path can rebuild S without a ``pair_fn``.

    ``cam_idx_np`` / ``mask_np`` are the padded (n_p, K) camera indices
    and mask on the host: the camera and camera-pair sums are planned from
    them once (fixed-order :class:`~.sparse_sym.SegmentSum`\\ s over the
    real slots and the real strict-lower slot pairs).  Returns
    ``reduce_pass(E_p, Cd_p, cam_p, g_b_p) -> (S_f, rhs_acc, Cinv_f)``:
    the reduced-camera-system partial E C⁻¹ Eᵀ reconstructed as the flat
    (..., n_a², da²) grid S = X + Xᵀ + diag from the strict-lower pairs
    (1.78× fewer blocks at K = 8), E C⁻¹ g_b (..., n_a, da), and C⁻¹
    stored for each point (..., n_p, db²).  ``cam_p`` is the device copy
    of ``cam_idx_np`` (the plan already holds it)."""
    plan = _ReducePlan(cam_idx_np, mask_np, n_a, K, CH,
                       (K * (K - 1) // 2 + K) * da * da, device)
    return _reduce_pass(plan, n_a, K, da, db, dtype, device)


def _reduce_pass(plan: _ReducePlan, n_a: int, K: int, da: int, db: int,
                 dtype, device):
    """:func:`make_reduce_pass` on a built plan."""
    ks, ls = _pairs(K)
    P_tri = int(ks.size)
    ks_t = torch.as_tensor(ks, device=device)
    ls_t = torch.as_tensor(ls, device=device)
    eye = torch.eye(db, dtype=dtype, device=device)

    def reduce_pass(E_p, Cd_p, cam_p, g_b_p):
        lead = tuple(E_p.shape[:-2])
        tri = diag = None
        cinv = []
        for s, (p0, p1) in enumerate(plan.slabs):
            n = p1 - p0
            Cinv_c, blocks_tri, blocks_diag, rhs_rows = _pair_block_chunk(
                E_p[..., p0:p1, :].reshape(lead + (n, K, da, db)),
                Cd_p[..., p0:p1, :].reshape(lead + (n, db, db)),
                g_b_p[..., p0:p1, :], ks_t, ls_t, eye, dtype)
            t = plan.pair_sums[s](
                blocks_tri.reshape(lead + (n * P_tri, da * da)))
            dg = plan.slot_sums[s](torch.cat(
                [blocks_diag.reshape(lead + (n * K, da * da)),
                 rhs_rows.reshape(lead + (n * K, da))], dim=-1))
            tri = t if tri is None else tri + t
            diag = dg if diag is None else diag + dg
            cinv.append(Cinv_c.reshape(lead + (n, db * db)))
        S_f = _reconstruct_S(plan.densify(tri), diag[..., :da * da], n_a,
                             da)
        return S_f, diag[..., da * da:], torch.cat(cinv, dim=-2)

    return reduce_pass


def make_obs_kernels(pair_fn: Callable, a_template, spec_a, spec_b, dtype,
                     n_a: int, K: int, CH: int, cam_idx_np, mask_np=None):
    """The per-point passes over a padded point-major slab (a multiple of
    CH points): ``(accumulate_slab, evaluate_slab, reduce_pass,
    backsub_pass)``.

    ``cam_idx_np`` / ``mask_np``: the padded (n_p, K) camera indices and
    mask on the host (every camera sum is planned from them; the JAX
    package's scatter fallback for traced indices has no counterpart).
    Padded points must carry mask 0 / camera 0 / zero obs, which makes
    their every contribution exactly zero.  Camera-side outputs (Ba, g_a,
    rss of ``accumulate_slab``; S_f and rhs_acc of ``reduce_pass``) are sums
    over the slab's points; landmark-side outputs are its own rows."""
    da, db = spec_a.dims, spec_b.dims
    dev = pytree.tree_leaves(a_template)[0].device
    cam_np = np.asarray(cam_idx_np, np.int64)
    real = (np.ones(cam_np.shape, bool) if mask_np is None
            else np.asarray(mask_np) != 0)
    n_p = cam_np.shape[0]
    plan = _ReducePlan(cam_np, real, n_a, K, CH,
                       (K * (K - 1) // 2 + K) * da * da, dev)
    reduce_pass = _reduce_pass(plan, n_a, K, da, db, dtype, dev)
    cam_t = torch.as_tensor(cam_np, device=dev)

    def pair_r(a_i, b_j, d_ij):
        return flatten_residuals(pair_fn(a_i, b_j, d_ij)).to(dtype)

    def rows(tree, p0, p1):
        return pytree.tree_map(lambda l: l[:, p0:p1], tree)

    def accumulate_slab(a, b_p, obs_p, cam_p, mask_p):
        """(Ba, g_a, E_f, C_f, g_b, rss) over the slab."""
        acc, E, C, g_b, rss = None, [], [], [], 0.0
        for s, (p0, p1) in enumerate(plan.slabs):
            r, Ja, Jb = obs_linearize(pair_fn, a, rows(b_p, p0, p1),
                                      rows(obs_p, p0, p1), cam_p[p0:p1],
                                      mask_p[p0:p1], spec_a, spec_b, dtype)
            lead, n = tuple(r.shape[:-3]), p1 - p0
            part = plan.slot_sums[s](torch.cat(
                [_einsum("jkra,jkrb->jkab", Ja, Ja).reshape(
                    lead + (n * K, da * da)),
                 _einsum("jkra,jkr->jka", Ja, r).reshape(
                     lead + (n * K, da))], dim=-1))
            acc = part if acc is None else acc + part
            E.append(_einsum("jkra,jkrb->jkab", Ja, Jb).reshape(
                lead + (n, K * da * db)))
            C.append(_einsum("jkra,jkrb->jab", Jb, Jb).reshape(
                lead + (n, db * db)))
            g_b.append(_einsum("jkrb,jkr->jb", Jb, r))
            rss = rss + torch.sum(r * r, dim=(-3, -2, -1))
        lead = tuple(acc.shape[:-2])
        return (acc[..., :da * da].reshape(lead + (n_a, da, da)),
                acc[..., da * da:], torch.cat(E, dim=-2),
                torch.cat(C, dim=-2), torch.cat(g_b, dim=-2), rss)

    def evaluate_slab(a, b_p, obs_p, cam_p, mask_p):
        """Σ‖r‖² over the slab, per instance."""
        flat = cam_p.long().reshape(-1)
        m_g = mask_p.to(dtype).reshape(-1)

        def slots(l):
            return l.reshape((l.shape[0], n_p * K) + tuple(l.shape[3:]))

        a_g = pytree.tree_map(lambda l: l[:, flat], a)
        b_g = pytree.tree_map(lambda l: slots(l.unsqueeze(2).expand(
            (l.shape[0], n_p, K) + tuple(l.shape[2:]))), b_p)
        r = torch.func.vmap(torch.func.vmap(
            lambda a_k, b_j, d_k, m_k: pair_r(a_k, b_j, d_k) * m_k),
            in_dims=(0, 0, 0, None))(a_g, b_g,
                                     pytree.tree_map(slots, obs_p), m_g)
        return torch.sum(r * r, dim=(-2, -1))

    def backsub_pass(E_p, Cinv_f, cam_p, g_b_p, dx_a):
        """Landmark back-substitution dx_b = C⁻¹(−g_b − Eᵀ dx_a)."""
        lead = tuple(E_p.shape[:-2])
        E4 = E_p.reshape(lead + (n_p, K, da, db))
        dxa_g = dx_a[..., cam_t, :]                  # (..., n_p, K, da)
        t = -g_b_p - _einsum("jkab,jka->jb", E4, dxa_g)
        return _einsum("jbc,jc->jb",
                       Cinv_f.reshape(lead + (n_p, db, db)), t)

    return accumulate_slab, evaluate_slab, reduce_pass, backsub_pass


# --------------------------------------------------------------------------
# The reduced camera solve
# --------------------------------------------------------------------------

def detect_camera_bandwidth(cam_idx_np, mask_np) -> int:
    """Max camera-index span co-observing any landmark (host-side).

    The reduced camera system S couples cameras i, i' only when some
    landmark sees both, so ``bw = max_j (max cam(j) − min cam(j))`` bounds
    S's block bandwidth.  Masked slots are excluded (their camera index is
    a pad 0).  Corridor / rail / sequential-SLAM rigs have bw ≪ n_cams;
    unordered SfM sets typically do not."""
    cam = _host(cam_idx_np).astype(np.int64)
    mk = _host(mask_np) != 0
    big = np.where(mk, cam, np.iinfo(np.int64).max)
    small = np.where(mk, cam, np.iinfo(np.int64).min)
    lo = big.min(axis=1)
    hi = small.max(axis=1)
    span = np.where(mk.any(axis=1), hi - lo, 0)
    return int(span.max()) if span.size else 0


def pick_band_group(bw_cams: int, n_a: int, da: int, max_block: int = 384,
                    min_groups: int = 8) -> int | None:
    """Group size (cameras) for the block-banded reduced solve, or None
    when the structure does not pay: groups of ``g ≥ bw`` cameras make S
    block-TRIDIAGONAL over ⌈n_a/g⌉ groups (any co-observing pair lands in
    the same or an adjacent group), solvable by cyclic reduction in
    O(n_a·(g·da)²) instead of the dense (n_a·da)³/3.  Gated to blocks of at
    most ``max_block`` tangent dims and at least ``min_groups`` groups
    (below that the dense Cholesky is comparable)."""
    g = max(bw_cams, 1)
    if g * da > max_block:
        return None
    if n_a // g < min_groups:
        return None
    return g


def _tridiag_cr_refine(D, B, b2, refine: int, dtype):
    """Cyclic-reduction solve of the (D, B) block-tridiagonal system, with
    ``refine`` rounds of float64-residual iterative refinement through the
    banded matvec; a correction is taken only where it is finite and
    shorter than the one before it (the first: than x), as in
    ``ops/linalg.refine_psd_solve``."""
    from .tridiag import block_tridiag_cr_solve

    Ng = D.shape[-3]
    x = block_tridiag_cr_solve(D, B, b2)
    if refine > 0:
        D64, B64, b64 = D.double(), B.double(), b2.double()
        prev = torch.linalg.vector_norm(x.flatten(-2), dim=-1)
        for _ in range(refine):
            x64 = x.double()
            Sx = _einsum("nab,nb->na", D64, x64)
            if Ng > 1:
                Sx[..., 1:, :] += _einsum("nab,nb->na", B64,
                                          x64[..., :-1, :])
                Sx[..., :-1, :] += _einsum("nba,nb->na", B64,
                                           x64[..., 1:, :])
            corr = block_tridiag_cr_solve(D, B, (b64 - Sx).to(dtype))
            size = torch.linalg.vector_norm(corr.flatten(-2), dim=-1)
            take = torch.isfinite(corr).all(dim=-1).all(dim=-1) & (size < prev)
            x = x + torch.where(take[..., None, None], corr,
                                torch.zeros_like(corr))
            prev = torch.where(take, size, torch.zeros_like(size))
    return x


def banded_reduced_solve(S_blocks, rhs, band_group: int, refine: int = 0):
    """Solve the block-BANDED reduced camera system by block cyclic
    reduction (``ops/tridiag.block_tridiag_cr_solve``) instead of a dense
    Cholesky.

    ``S_blocks`` (..., n_a, n_a, da, da) with bandwidth below
    ``band_group`` camera blocks; cameras group into consecutive
    ``band_group``-sized super-blocks, an exactly block-tridiagonal SPD
    system (identity padding completes the last group).  ``refine`` rounds
    of float64-residual iterative refinement re-solve through the same CR.
    Returns ``(dx (..., n_a·da), ok (...))``."""
    lead = tuple(S_blocks.shape[:-4])
    n_a, da = S_blocks.shape[-3], S_blocks.shape[-1]
    g = band_group
    Ng = -(-n_a // g)
    d_blk = g * da
    n_s = n_a * da
    n_p = Ng * d_blk
    Sd = S_blocks.transpose(-3, -2).reshape(lead + (n_s, n_s))
    if n_p != n_s:
        Sp = Sd.new_zeros(lead + (n_p, n_p))
        Sp[..., :n_s, :n_s] = Sd
        idx = torch.arange(n_s, n_p, device=Sd.device)
        Sp[..., idx, idx] = 1.0           # decoupled identity pad
        rhs = torch.cat([rhs, rhs.new_zeros(lead + (n_p - n_s,))], dim=-1)
    else:
        Sp = Sd
    S4 = Sp.reshape(lead + (Ng, d_blk, Ng, d_blk)).transpose(-3, -2)
    ig = torch.arange(Ng, device=Sd.device)
    D = S4[..., ig, ig, :, :]                        # (..., Ng, d, d)
    Bs = S4[..., ig[1:], ig[:-1], :, :]              # (..., Ng-1, d, d)
    x = _tridiag_cr_refine(D, Bs, rhs.reshape(lead + (Ng, d_blk)), refine,
                           S_blocks.dtype)
    dx = x.reshape(lead + (n_p,))[..., :n_s]
    return dx, torch.isfinite(dx).all(dim=-1)


def assemble_reduced(S_f, rhs_acc, Bd, g_a, use_cholesky: bool = True,
                     refine: int = 0, cg_iters: int = 0, band_group=None):
    """Solve the reduced camera system from the completed reduce.

    ``S = diag(Bd) − S_f``, ``rhs = −g_a + rhs_acc``, for every instance
    (leading axes).  ``refine`` = ``hessian.schur_refine``'s
    mixed-precision rounds (``ops/linalg.refine_psd_solve``, or through
    the CR on the banded route); ``cg_iters`` > 0 =
    ``hessian.schur_cg_iters``: block-Jacobi PCG instead of a
    factorization (an inexact LM step; ``refine`` is ignored there);
    ``band_group`` (and ``cg_iters`` 0): the banded cyclic-reduction
    solve.  Returns ``(dx_a (..., n_a, da), ok (...))``."""
    lead = tuple(g_a.shape[:-2])
    n_a, da = g_a.shape[-2], g_a.shape[-1]
    S_red = S_f.reshape(lead + (n_a, n_a, da, da))
    eye = torch.eye(n_a, dtype=S_f.dtype, device=S_f.device)
    S_blocks = -S_red + eye[:, :, None, None] * Bd.unsqueeze(-3)
    rhs = (-g_a + rhs_acc).reshape(lead + (n_a * da,))
    if band_group is not None and cg_iters == 0:
        SOLVES["banded"] += 1
        dx_a, ok = banded_reduced_solve(S_blocks, rhs, band_group, refine)
        return dx_a.reshape(lead + (n_a, da)), ok
    S = S_blocks.transpose(-3, -2).reshape(lead + (n_a * da, n_a * da))
    if cg_iters > 0:
        SOLVES["pcg"] += 1
        Minv = spd_inv_blocks(torch.diagonal(S_blocks, dim1=-4, dim2=-3)
                              .movedim(-1, -3))

        def prec(v):
            return _einsum("iab,ib->ia", Minv,
                           v.reshape(lead + (n_a, da))).reshape(v.shape)

        dx_a = pcg_core(lambda p: torch.matmul(S, p[..., None])[..., 0],
                        prec, rhs, cg_iters)
        ok = torch.isfinite(dx_a).all(dim=-1)
        return dx_a.reshape(lead + (n_a, da)), ok
    SOLVES["dense"] += 1
    dx_a, ok = solve_psd(S, rhs, use_cholesky=use_cholesky)
    if refine > 0:
        dx_a = refine_psd_solve(S, rhs, dx_a, refine,
                                use_cholesky=use_cholesky)
    return dx_a.reshape(lead + (n_a, da)), ok


# --------------------------------------------------------------------------
# Covariance
# --------------------------------------------------------------------------

def camera_marginals_from_S(S_f, Ba):
    """Per-camera marginal covariance from the completed reduce.

    ``S = diag(Ba) − S_f`` is the UNDAMPED reduced camera system at the
    solution; its inverse is exactly the camera block of H⁻¹
    (marginalizing the landmarks is the Schur complement), so the camera
    marginals are S⁻¹'s diagonal da×da blocks.  Returns
    ``(cov_a (..., n_a, da, da), Sinv (..., n_a·da, n_a·da))``; non-finite
    where S is singular (gauge not fixed), ``ops/linalg.inv_cov``'s
    contract."""
    lead = tuple(Ba.shape[:-3])
    n_a, da = Ba.shape[-3], Ba.shape[-1]
    eye = torch.eye(n_a, dtype=S_f.dtype, device=S_f.device)
    S_blocks = (-S_f.reshape(lead + (n_a, n_a, da, da))
                + eye[:, :, None, None] * Ba.unsqueeze(-3))
    Sinv = inv_cov(S_blocks.transpose(-3, -2).reshape(
        lead + (n_a * da, n_a * da)))
    blocks = Sinv.reshape(lead + (n_a, da, n_a, da)).transpose(-3, -2)
    cov_a = torch.diagonal(blocks, dim1=-4, dim2=-3).movedim(-1, -3)
    return cov_a, Sinv


def make_landmark_marginal_pass(n_a: int, K: int, da: int, db: int, dtype,
                                CH: int):
    """The landmark-marginal pass: ``pass(E_p, Cinv_p, cam_p, Sinv) ->
    cov_b (..., n_p, db, db)``, the diagonal landmark blocks of H⁻¹,

        cov_b(j) = C_j⁻¹ + Σ_{k,l} W_jkᵀ · Sinv[cam_jk, cam_jl] · W_jl,
        W_jk = E_jk C_j⁻¹            (cov_bb = C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹),

    in slabs of whole chunks (the S⁻¹ block gather, K²·da² a point, is the
    largest transient).  Padded points (zero E, identity C⁻¹) come out as
    identity blocks; callers trim them."""
    def marginal_pass(E_p, Cinv_p, cam_p, Sinv):
        lead = tuple(E_p.shape[:-2])
        n_p = E_p.shape[-2]
        cam = cam_p.long()
        Sinv4 = Sinv.reshape(lead + (n_a, da, n_a, da)).transpose(-3, -2)
        out = []
        for p0, p1 in _slabs(n_p, CH, K * K * da * da):
            n = p1 - p0
            E_c = E_p[..., p0:p1, :].reshape(lead + (n, K, da, db))
            Cinv_c = Cinv_p[..., p0:p1, :].reshape(lead + (n, db, db))
            cam_c = cam[p0:p1]
            W = _einsum("jkab,jbc->jkac", E_c, Cinv_c).to(dtype)
            Sb = Sinv4[..., cam_c[:, :, None], cam_c[:, None, :], :, :]
            Mv = _einsum("jklab,jlbd->jkad", Sb, W).to(dtype)
            corr = _einsum("jkab,jkac->jbc", W, Mv).to(dtype)
            out.append(Cinv_c + corr)
        return torch.cat(out, dim=-3)

    return marginal_pass


def _slab_marginals(Ba, slabs, chunk: int, complete=None):
    """The marginals of an arrow system whose landmarks lie in point-major
    slabs ``[(E, C, ObsLayout)]``: the reduced camera system S summed over
    the slabs (and completed by ``complete(S)`` where the slabs are one
    rank's share of the landmarks), ``cov_a`` from its inverse, then each
    slab's landmark blocks (a landmark with no real observation NaN).
    Returns ``(cov_a, [cov_b of each slab])``."""
    n_a, da = Ba.shape[-3], Ba.shape[-1]
    dtype, dev = Ba.dtype, Ba.device
    S_f, stash = None, []
    for E, C, lay in slabs:
        n, K = lay.cam_np.shape
        db = math.isqrt(C.shape[-1])
        n_p = _padded_points(n, chunk)
        pad, CH = n_p - n, _pick_chunk(n_p, chunk)
        cam_np = np.concatenate([lay.cam_np, np.zeros((pad, K), np.int64)])
        mask_np = np.concatenate([lay.mask_np, np.zeros((pad, K), bool)])
        E_p, C_p = _pad_rows(E, pad), _pad_rows(C, pad)
        cam_p = torch.as_tensor(cam_np, device=dev)
        S_g, _, Cinv_p = make_reduce_pass(n_a, K, da, db, dtype, CH, cam_np,
                                          mask_np, dev)(
            E_p, C_p, cam_p, E_p.new_zeros(E_p.shape[:-1] + (db,)))
        S_f = S_g if S_f is None else S_f + S_g
        stash.append((E_p, Cinv_p, cam_p, C, K, CH, db))
    if complete is not None:
        S_f = complete(S_f)
    cov_a, Sinv = camera_marginals_from_S(S_f, Ba)
    rows = []
    for E_p, Cinv_p, cam_p, C, K, CH, db in stash:
        cov = make_landmark_marginal_pass(n_a, K, da, db, dtype, CH)(
            E_p, Cinv_p, cam_p, Sinv)[..., :C.shape[-2], :, :]
        dead = torch.all(C == 0, dim=-1)
        rows.append(torch.where(dead[..., None, None],
                                torch.full_like(cov, float("nan")), cov))
    return cov_a, rows


def obs_marginals(H: SchurObsSystem, chunk: int = 1024):
    """Posterior marginal covariance blocks of a sparse-observation BA
    solution.

    ``H`` must be the UNDAMPED system accumulated at the solution (what
    ``accumulate`` returns / ``Output.final_hessian`` carries).  Returns
    ``(cov_a (..., n_a, da, da), cov_b (..., n_b, db, db))``: per-camera
    and per-landmark marginal covariance blocks of H⁻¹, from one
    (n_a·da)² inverse of the reduced system and the per-point algebra,
    never a (dims)² solve.  A landmark with no real observation is NaN
    (its H row is singular).  Rescaling (reference output.h:80-93) is the
    ``schur_sparse_covariance`` entry's."""
    cov_a, (cov_b,) = _slab_marginals(H.Ba, [(H.E, H.C, H.layout)], chunk)
    return cov_a, cov_b


def obs_marginals_buckets(H: SchurObsBuckets, ids_list, chunk: int = 1024):
    """Posterior marginal covariance blocks of a K-bucketed solution:
    :func:`obs_marginals`' algebra with the reduced camera system summed
    over the buckets.  ``ids_list`` gives each bucket's original landmark
    indices (the ``ids`` of the slabs the system was built from).  Returns
    ``(cov_a (..., n_a, da, da), cov_b (..., n_b, db, db))`` with ``cov_b``
    in the original landmark order; a landmark with no real observation is
    NaN."""
    ids_all = np.concatenate([_host(i).astype(np.int64).reshape(-1)
                              for i in ids_list])
    inv_order = torch.as_tensor(np.argsort(ids_all), device=H.Ba.device)
    cov_a, rows = _slab_marginals(
        H.Ba, list(zip(H.E, H.C, H.layout.buckets)), chunk)
    return cov_a, torch.cat(rows, dim=-3)[..., inv_order, :, :]


# --------------------------------------------------------------------------
# The systems
# --------------------------------------------------------------------------

def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (..., n, w) with ``pad`` zero rows appended."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros(t.shape[:-2] + (pad,) + t.shape[-1:])],
                     dim=-2)


def _point_slab(pair_fn, a0, spec_a, spec_b, dtype, n_a: int, obs, cam_idx,
                mask, chunk: int):
    """One point-major slab of a system, built once: its data with the point
    axis padded to a multiple of ``chunk`` (padded points: mask 0, camera 0,
    zero obs) on the parameters' device, and its per-point passes
    (:func:`make_obs_kernels`, planned from the host indices)."""
    dev = pytree.tree_leaves(a0)[0].device
    cam_np = _host(cam_idx).astype(np.int64)
    real = _host(mask) != 0
    n, K = cam_np.shape
    n_p = _padded_points(n, chunk)
    pad, CH = n_p - n, _pick_chunk(n_p, chunk)
    cam_pad = np.concatenate([cam_np, np.zeros((pad, K), np.int64)])
    real_pad = np.concatenate([real, np.zeros((pad, K), bool)])
    obs_p = pytree.tree_map(lambda l: torch.cat(
        [l, l.new_zeros((l.shape[0], pad) + tuple(l.shape[2:]))], dim=1),
        obs) if pad else obs
    return types.SimpleNamespace(
        n=n, pad=pad, cam_np=cam_np, real=real, obs=obs_p,
        cam=torch.as_tensor(cam_pad, device=dev),
        mask=torch.as_tensor(real_pad, device=dev).to(dtype),
        kernels=make_obs_kernels(pair_fn, a0, spec_a, spec_b, dtype, n_a, K,
                                 CH, cam_pad, real_pad))


def _residual_dims(pair_fn, a_ex, b_ex, obs) -> int:
    """m, the residuals of one observation."""
    d_ex = pytree.tree_map(lambda l: l[0, 0, 0], obs)
    return int(flatten_residuals(pair_fn(a_ex, b_ex, d_ex)).numel())


def _matvec_ghg(H, g) -> torch.Tensor:
    """gᵀHg by the system's arrow matvec."""
    return torch.sum(g * H.matvec(g), dim=-1)


def _propose(stages, em2gl, damp_C):
    """``propose(H, g, lam, opts) -> (dx, ok)``, the damped Schur
    elimination of each solver type, from a system's elimination stages:
    ``stages.reduce_inputs(H, Cd, g)`` → ``stages.reduce`` →
    :func:`assemble_reduced` (at ``stages.band_group`` where
    ``hessian.schur_banded="auto"``) → ``stages.backsub``, and the dogleg's
    gᵀHg from ``stages.ghg(H, g)``; ``damp_C(C, λ)`` damps the landmark
    blocks.  The stages stay on it as
    ``propose.stages``, for timing them one by one."""
    from ..solvers.step import dogleg_core
    from .schur import _damp_blocks

    def eliminate(H, Bd, Cd, g, use_cholesky=True, refine: int = 0,
                  cg_iters: int = 0, band_group=None):
        """(dx, ok) of the damped arrow system [Bd, E; Eᵀ, Cd] dx = −g: the
        reduce, the reduced solve, the back-substitution; g and dx in the
        loop's global layout."""
        g_a, g_b, E_p, Cd_p = stages.reduce_inputs(H, Cd, g)
        S_f, rhs_acc, Cinv = stages.reduce(E_p, Cd_p, g_b)
        dx_a, ok = assemble_reduced(S_f, rhs_acc, Bd, g_a, use_cholesky,
                                    refine, cg_iters, band_group)
        dx_b = stages.backsub(E_p, Cinv, g_b, dx_a)
        dx = torch.cat([dx_a.flatten(-2), dx_b.flatten(-2)], dim=-1)
        ok = ok & torch.isfinite(dx).all(dim=-1)
        if em2gl is not None:
            dx = dx[:, em2gl]
        return dx, ok

    def propose(H, g, lam, opts):
        hs = opts.hessian
        kw = dict(use_cholesky=hs.use_ldlt, refine=hs.schur_refine,
                  cg_iters=hs.schur_cg_iters,
                  band_group=(stages.band_group if hs.schur_banded == "auto"
                              else None))
        if opts.solver_type == SolverType.DOGLEG:
            dx_gn, ok_gn = eliminate(H, H.Ba, H.C, g, **kw)
            return dogleg_core(
                g, lam, dx_gn, ok_gn, stages.ghg(H, g),
                lambda le: eliminate(H, _damp_blocks(H.Ba, le),
                                     damp_C(H.C, le), g, **kw))
        if opts.solver_type == SolverType.LEVENBERG_MARQUARDT:
            return eliminate(H, _damp_blocks(H.Ba, lam), damp_C(H.C, lam), g,
                             **kw)
        return eliminate(H, H.Ba, H.C, g, **kw)

    propose.stages = stages
    return propose


def schur_obs_system(pair_fn: Callable, a0, b0, obs, cam_idx, mask,
                     spec: mf.TangentSpec, chunk: int = 1024):
    """Batched ``(accumulate, evaluate, n_res, propose)`` of a
    sparse-observation BA problem over flat (B, P) parameters, for
    ``optimizers.loop.optimize_from_acc(propose=propose)``.

    ``pair_fn(a_i, b_j, obs_ij) -> (m,)`` is one observation; ``a0`` /
    ``b0`` one instance's families (leading axes n_a, n_b); ``obs`` leaves
    (B, n_b, K, ...); ``cam_idx`` / ``mask`` (n_b, K), one topology for the
    batch; ``spec`` must be ``mf.tangent_spec((a0, b0))``.  The point axis
    is padded to a multiple of ``chunk`` (padded points: mask 0, camera 0,
    exact zero contributions).  ``n_res`` (B,) counts the real slots'
    residuals only, m · count_nonzero(mask).  The banded route
    (``hessian.schur_banded="auto"``) is taken where
    :func:`detect_camera_bandwidth` / :func:`pick_band_group` find a band
    in the host indices.  ``propose.stages`` holds the elimination's
    stages: ``reduce_inputs(H, Cd, g) -> (g_a, g_b, E_p, Cd_p)``,
    ``reduce(E_p, Cd_p, g_b) -> (S_f, rhs, Cinv)``, ``backsub(E_p, Cinv,
    g_b, dx_a) -> dx_b``, ``ghg(H, g)`` and ``band_group``."""
    from .schur import bipartite_perms

    a0, b0 = mf.as_pytree(a0), mf.as_pytree(b0)
    n_a = pytree.tree_leaves(a0)[0].shape[0]
    n_b = pytree.tree_leaves(b0)[0].shape[0]
    a_ex = pytree.tree_map(lambda l: l[0], a0)
    b_ex = pytree.tree_map(lambda l: l[0], b0)
    spec_a, spec_b = mf.tangent_spec(a_ex), mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype
    dev = pytree.tree_leaves(a0)[0].device
    Bn = pytree.tree_leaves(obs)[0].shape[0]
    sl = _point_slab(pair_fn, a0, spec_a, spec_b, dtype, n_a, obs, cam_idx,
                     mask, chunk)
    acc_slab, eval_slab, reduce_pass, backsub_pass = sl.kernels
    m = _residual_dims(pair_fn, a_ex, b_ex, obs)
    n_res = torch.full((Bn,), int(np.count_nonzero(sl.real)) * m,
                       dtype=torch.int32, device=dev)
    # static banded-structure detection (hessian.schur_banded="auto")
    band_g = pick_band_group(detect_camera_bandwidth(sl.cam_np, sl.real),
                             n_a, da)
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db, dev)
    layout = ObsLayout(torch.as_tensor(sl.cam_np, device=dev), sl.real,
                       em2gl, gl2em)

    def split(x):
        return mf.unflatten(x, spec)

    def pad_b(b):
        if not sl.pad:
            return b
        return pytree.tree_map(lambda l: torch.cat(
            [l, l[:, :1].expand((l.shape[0], sl.pad) + tuple(l.shape[2:]))],
            dim=1), b)

    def accumulate(x):
        a, b = split(x)
        Ba, g_a, E_f, C_f, g_b, rss = acc_slab(a, pad_b(b), sl.obs, sl.cam,
                                               sl.mask)
        g = torch.cat([g_a.flatten(-2), g_b[:, :n_b].flatten(-2)], dim=-1)
        if em2gl is not None:
            g = g[:, em2gl]
        H = SchurObsSystem(Ba, C_f[:, :n_b], E_f[:, :n_b], layout)
        return H, g, Cost.make(rss, n_res)

    def evaluate(x):
        a, b = split(x)
        return Cost.make(eval_slab(a, pad_b(b), sl.obs, sl.cam, sl.mask),
                         n_res)

    def reduce_inputs(H: SchurObsSystem, Cd_flat, g):
        """(g_a, g_b, E, Cd) in the element-major, point-padded layout of
        the reduce; g in the loop's global layout."""
        if gl2em is not None:
            g = g[:, gl2em]
        return (g[:, :n_a * da].reshape(-1, n_a, da),
                _pad_rows(g[:, n_a * da:].reshape(-1, n_b, db), sl.pad),
                _pad_rows(H.E, sl.pad), _pad_rows(Cd_flat, sl.pad))

    def reduce(E_p, Cd_p, g_b):
        return reduce_pass(E_p, Cd_p, sl.cam, g_b)

    def backsub(E_p, Cinv_f, g_b, dx_a):
        return backsub_pass(E_p, Cinv_f, sl.cam, g_b, dx_a)[:, :n_b]

    propose = _propose(
        types.SimpleNamespace(reduce_inputs=reduce_inputs, reduce=reduce,
                              backsub=backsub, band_group=band_g,
                              ghg=_matvec_ghg),
        em2gl, lambda C, lam: _damp_flat(C, db, lam))
    return accumulate, evaluate, n_res, propose


def schur_obs_bucket_system(pair_fn: Callable, a0, b0, slabs,
                            spec: mf.TangentSpec, chunk: int = 1024):
    """Batched ``(accumulate, evaluate, n_res, propose)`` of a K-bucketed
    sparse-observation BA problem, the contract of
    :func:`schur_obs_system`.

    ``slabs`` — a list of ``(obs, cam_idx, mask, ids)``, one a bucket: obs
    leaves (B, n_g, K_g, ...), ``cam_idx`` / ``mask`` (n_g, K_g) (one
    topology for the batch), and the static original landmark indices
    ``ids`` (n_g,) of the bucket's rows (:func:`bucket_obs` builds them).
    Every landmark must lie in exactly one bucket.  ``x`` keeps the
    original landmark order: each bucket gathers its landmarks by ``ids``
    and one static gather puts g_b and the back-substituted steps back in
    that order.  Each bucket is its own padded point axis with its own
    per-point passes and sums; the reduced camera system and its rhs are
    summed over the buckets, so a trajectory follows the single-slab
    layout's of the same problem up to summation order.  The banded route
    is taken over the union of the buckets' bandwidths.  The JAX package's
    band-storage reduce (straight into the band of S) needs its TPU window
    plan, and off the TPU it runs none (its ``_window_enabled`` is False
    there), so S is the flat camera-pair grid here as on its CPU."""
    from .schur import bipartite_perms

    a0, b0 = mf.as_pytree(a0), mf.as_pytree(b0)
    n_a = pytree.tree_leaves(a0)[0].shape[0]
    n_b = pytree.tree_leaves(b0)[0].shape[0]
    a_ex = pytree.tree_map(lambda l: l[0], a0)
    b_ex = pytree.tree_map(lambda l: l[0], b0)
    spec_a, spec_b = mf.tangent_spec(a_ex), mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype
    dev = pytree.tree_leaves(a0)[0].device

    ids_np = [_host(s[3]).astype(np.int64).reshape(-1) for s in slabs]
    ids_all = np.concatenate(ids_np)
    if ids_all.size != n_b or np.any(np.sort(ids_all) != np.arange(n_b)):
        raise ValueError(
            "bucket ids must partition the landmark axis: every "
            f"landmark index 0..{n_b - 1} exactly once "
            f"(got {ids_all.size} ids)")
    inv_order = torch.as_tensor(np.argsort(ids_all), device=dev)
    buckets = [_point_slab(pair_fn, a0, spec_a, spec_b, dtype, n_a, obs, ci,
                           mk, chunk) for obs, ci, mk, _ in slabs]
    Bn = pytree.tree_leaves(slabs[0][0])[0].shape[0]
    m = _residual_dims(pair_fn, a_ex, b_ex, slabs[0][0])
    n_res = torch.full((Bn,), sum(int(np.count_nonzero(bk.real))
                                  for bk in buckets) * m,
                       dtype=torch.int32, device=dev)
    # the banded route over the union of the buckets' co-observations
    bw = max((detect_camera_bandwidth(bk.cam_np, bk.real)
              for bk in buckets), default=0)
    band_g = pick_band_group(bw, n_a, da)
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db, dev)
    for bk, ids in zip(buckets, ids_np):
        bk.ids = torch.as_tensor(ids, device=dev)
    layout = BucketLayout(
        [ObsLayout(torch.as_tensor(bk.cam_np, device=dev), bk.real,
                   ids=bk.ids) for bk in buckets], inv_order, em2gl, gl2em)

    def split(x):
        return mf.unflatten(x, spec)

    def slab_b(b, bk):
        """The bucket's landmarks, padded with copies of its first."""
        def leaf(l):
            l = l[:, bk.ids]
            if not bk.pad:
                return l
            return torch.cat([l, l[:, :1].expand(
                (l.shape[0], bk.pad) + tuple(l.shape[2:]))], dim=1)
        return pytree.tree_map(leaf, b)

    def accumulate(x):
        a, b = split(x)
        Ba = g_a = rss = None
        C, E, g_b = [], [], []
        for bk in buckets:
            Ba_g, ga_g, E_f, C_f, gb_g, rss_g = bk.kernels[0](
                a, slab_b(b, bk), bk.obs, bk.cam, bk.mask)
            Ba, g_a, rss = ((Ba_g, ga_g, rss_g) if Ba is None else
                            (Ba + Ba_g, g_a + ga_g, rss + rss_g))
            C.append(C_f[:, :bk.n])
            E.append(E_f[:, :bk.n])
            g_b.append(gb_g[:, :bk.n])
        g_b = torch.cat(g_b, dim=1)[:, inv_order]
        g = torch.cat([g_a.flatten(-2), g_b.flatten(-2)], dim=-1)
        if em2gl is not None:
            g = g[:, em2gl]
        return (SchurObsBuckets(Ba, tuple(C), tuple(E), layout), g,
                Cost.make(rss, n_res))

    def evaluate(x):
        a, b = split(x)
        rss = None
        for bk in buckets:
            r = bk.kernels[1](a, slab_b(b, bk), bk.obs, bk.cam, bk.mask)
            rss = r if rss is None else rss + r
        return Cost.make(rss, n_res)

    def reduce_inputs(H: SchurObsBuckets, Cd, g):
        """(g_a, [g_b], [E], [Cd]): g_a element-major, the rest one entry a
        bucket, point-padded; g in the loop's global layout."""
        if gl2em is not None:
            g = g[:, gl2em]
        g_b = g[:, n_a * da:].reshape(-1, n_b, db)
        return (g[:, :n_a * da].reshape(-1, n_a, da),
                [_pad_rows(g_b[:, bk.ids], bk.pad) for bk in buckets],
                [_pad_rows(E_g, bk.pad) for bk, E_g in zip(buckets, H.E)],
                [_pad_rows(C_g, bk.pad) for bk, C_g in zip(buckets, Cd)])

    def reduce(E_p, Cd_p, g_b):
        """(S_f, rhs_acc) summed over the buckets, and each bucket's C⁻¹."""
        S_f = rhs = None
        cinv = []
        for bk, E_g, Cd_g, gb_g in zip(buckets, E_p, Cd_p, g_b):
            S_g, rhs_g, Cinv_g = bk.kernels[2](E_g, Cd_g, bk.cam, gb_g)
            S_f, rhs = ((S_g, rhs_g) if S_f is None else
                        (S_f + S_g, rhs + rhs_g))
            cinv.append(Cinv_g)
        return S_f, rhs, cinv

    def backsub(E_p, Cinv, g_b, dx_a):
        """dx_b (B, n_b, db) in the original landmark order."""
        rows = [bk.kernels[3](E_g, Ci_g, bk.cam, gb_g, dx_a)[:, :bk.n]
                for bk, E_g, Ci_g, gb_g in zip(buckets, E_p, Cinv, g_b)]
        return torch.cat(rows, dim=1)[:, inv_order]

    propose = _propose(
        types.SimpleNamespace(reduce_inputs=reduce_inputs, reduce=reduce,
                              backsub=backsub, band_group=band_g,
                              ghg=_matvec_ghg),
        em2gl, lambda C, lam: tuple(_damp_flat(c, db, lam) for c in C))
    return accumulate, evaluate, n_res, propose


# --------------------------------------------------------------------------
# Layouts built on the host
# --------------------------------------------------------------------------

def _assign_caps(counts, caps):
    """The smallest sufficient cap of each count from a fixed cap list (a
    count of 0 takes the smallest cap)."""
    counts = np.asarray(counts)
    cap_of = np.full(counts.shape, caps[-1], np.int64)
    for cap in reversed(caps):
        cap_of[counts <= cap] = cap
    cap_of[counts == 0] = caps[0]
    return cap_of, caps


def bucket_caps(counts, growth: float = 2.0, min_bucket: int = 256,
                max_blowup: float = 2.0):
    """Each landmark's K-bucket cap from its observation count (host-side
    numpy): ``(cap_of (n_b,) int64, used caps list)``.

    Caps grow geometrically by ``growth`` from the smallest count to the
    largest.  A bucket of fewer than ``min_bucket`` points merges into the
    next larger cap, each merge paid from a budget of ``(max_blowup − 1) ×
    Σ the unmerged caps`` padded slots (an unbudgeted merge cascades on a
    thin tail with one huge outlier: thousands of tiny classes inheriting
    the outlier's cap); one that would overrun it keeps its own class.  A
    small largest bucket cannot merge upward, so the next class is pulled
    up into it instead (merging down would cut the slots of members whose
    count exceeds the smaller cap)."""
    counts = np.asarray(counts)
    caps = []
    c = max(int(counts.min()), 1)
    kmax = max(int(counts.max()), 1)
    while c < kmax:
        caps.append(c)
        c = max(int(math.ceil(c * growth)), c + 1)
    caps.append(kmax)
    cap_of, _ = _assign_caps(counts, caps)
    used = [c0 for c0 in caps if np.any(cap_of == c0)]
    budget = int((max_blowup - 1.0) * int(cap_of.sum()))
    for i, c0 in enumerate(used[:-1]):
        sel = cap_of == c0
        n_sel = int(sel.sum())
        if 0 < n_sel < min_bucket:
            cost = (used[i + 1] - c0) * n_sel
            if cost <= budget:
                budget -= cost
                cap_of[sel] = used[i + 1]
    used = [c0 for c0 in caps if np.any(cap_of == c0)]
    if len(used) > 1 and (cap_of == used[-1]).sum() < min_bucket:
        n2 = int((cap_of == used[-2]).sum())
        cost = (used[-1] - used[-2]) * n2
        if cost <= budget:
            budget -= cost
            cap_of[cap_of == used[-2]] = used[-1]
            used = used[:-2] + used[-1:]
    return cap_of, used


def bucket_obs(obs, cam_idx, mask, growth: float = 2.0,
               min_bucket: int = 256):
    """Split one problem's padded point-major layout (obs leaves (n_b, K,
    ...), ``cam_idx`` / ``mask`` (n_b, K)) into K-buckets, on the host.

    Landmarks are grouped by observation count (:func:`bucket_caps`).
    Within a bucket they are ordered by their primary camera (the least
    camera of a real slot; the JAX package's order, which keeps its TPU
    chunks camera-local — here it only sets the summation order), each
    row's real slots compacted to the front, its columns cut to the cap and
    its padded slots zeroed (camera 0, mask 0, obs 0).  Returns ``slabs``,
    a list of ``(obs_g, cam_idx_g, mask_g, ids_g)`` for
    :func:`schur_obs_bucket_system`: tensors on the inputs' devices
    (``cam_idx_g`` int32, the rest in their dtypes) and ``ids_g`` the
    bucket's landmark indices (numpy int64).  The padded slots number
    about ``growth``× the observations instead of n_b · K_max."""
    cam_np = _host(cam_idx)
    mask_np = _host(mask)
    real = mask_np.astype(bool)
    cap_of, used = bucket_caps(real.sum(axis=1), growth, min_bucket)
    big = np.where(real, cam_np, np.iinfo(np.int64).max)
    primary = np.where(real.any(1), big.min(axis=1), 0)

    def dev_of(t):
        return t.device if isinstance(t, torch.Tensor) else None

    slabs = []
    for cap in used:
        ids = np.nonzero(cap_of == cap)[0]
        ids = ids[np.argsort(primary[ids], kind="stable")]
        order = np.argsort(~real[ids], axis=1, kind="stable")
        cam_g = np.take_along_axis(cam_np[ids], order, 1)[:, :cap]
        mask_g = np.take_along_axis(mask_np[ids], order, 1)[:, :cap]
        keep = mask_g.astype(bool)
        cam_g = np.where(keep, cam_g, 0).astype(np.int32)

        def leaf(l):
            arr = _host(l)[ids]
            tail = (1,) * (arr.ndim - 2)
            g = np.take_along_axis(arr, order.reshape(order.shape + tail),
                                   1)[:, :cap]
            return torch.as_tensor(
                np.where(keep.reshape(keep.shape + tail), g, 0),
                device=dev_of(l))

        slabs.append((pytree.tree_map(leaf, obs),
                      torch.as_tensor(cam_g, device=dev_of(cam_idx)),
                      torch.as_tensor(mask_g, device=dev_of(mask)), ids))
    return slabs


def grid_to_obs(data, mask, K: int | None = None):
    """Convert a dense (n_a, n_b) observation grid to the point-major
    padded layout: ``(obs, cam_idx, slot_mask)`` on the grid's device,
    obs leaves (n_b, K, ...), cam_idx (n_b, K) int32, slot_mask (n_b, K)
    in the mask's dtype.

    ``K`` defaults to the densest landmark's observation count.  A padded
    slot reads the grid's (0, 0) entry, as the JAX package's does; its
    mask is 0.  Host-side: layouts are built once."""
    mask_t = torch.as_tensor(mask)
    mask_np = _host(mask_t)
    n_a, n_b = mask_np.shape
    counts = (mask_np != 0).sum(axis=0)
    K = int(counts.max()) if K is None else int(K)
    if int(counts.max()) > K:
        raise ValueError(
            f"K={K} < densest landmark's {int(counts.max())} observations")
    cam_idx = np.zeros((n_b, K), np.int32)
    slot = np.zeros((n_b, K), bool)
    sel = np.zeros((n_b, K), np.int64)      # flat (cam, pt) gather index
    for j in range(n_b):
        cams = np.nonzero(mask_np[:, j])[0]
        cam_idx[j, :len(cams)] = cams
        slot[j, :len(cams)] = True
        sel[j, :len(cams)] = cams * n_b + j
    dev = mask_t.device
    sel_t = torch.as_tensor(sel.reshape(-1), device=dev)

    def gather(l):
        l = torch.as_tensor(l)
        rest = tuple(l.shape[2:])
        return l.reshape((n_a * n_b,) + rest)[sel_t].reshape((n_b, K) + rest)

    obs = pytree.tree_map(gather, data)
    return (obs, torch.as_tensor(cam_idx, device=dev),
            torch.as_tensor(slot, device=dev).to(mask_t.dtype))
