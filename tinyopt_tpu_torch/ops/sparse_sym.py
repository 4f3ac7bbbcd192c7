"""General sparse symmetric Hessian with a static coordinate pattern,
batched.

Counterpart of ``tinyopt_tpu.ops.sparse_sym`` (reference: include/tinyopt/
types.h:36-38, solvers/gn.h:63-74 — the general ``SparseMatrix`` factored
by ``SimplicialLDLT``, math.h:266-277): the damped normal equations are
solved by Jacobi-preconditioned CG with ``jax.scipy.sparse.linalg.cg``'s
stopping rule (``ops.linalg.cg_to_tol``).

``vals`` has shape (..., nse), any leading axes being instances; the
pattern (rows, cols, the diagonal mask, the dimension) is ONE static
:class:`Pattern` shared by the whole batch.  It is pytree context, not a
leaf, so a per-instance select (``utils.where_tree``) touches ``vals``
only.  Every sum over the pattern is a :class:`SegmentSum`: a padded
gather and a sum in a fixed order, so a float32 run on the card gives the
same bits every time (``index_add_`` on CUDA sums by atomics, in whatever
order they land).

Matches the reference's semantics: multiplicative diagonal damping
``H(i,i) *= 1 + λ`` (lm.h:107-117) in :meth:`SparseSym.damp`, and the
covariance with a diagonal-shift retry on numerical failure
(math.h:115-137) in :meth:`SparseSym.inv`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .linalg import cg_to_tol, inv_cov


_WIDTH = 16     # the most entries a SegmentSum chunk sums


class SegmentSum:
    """``out[..., k] = Σ_{seg[j] == k} v[..., j]`` for a static ``seg``
    (m,) with values in [0, n_out), without atomics and in a fixed order,
    at a cost of O(m + n_out).

    The entries are sorted by segment once on the host (ascending ``j``
    within one).  While some segment holds more than ``_WIDTH`` entries,
    a level cuts every segment into chunks of at most ``_WIDTH`` and sums
    each chunk (a padded (n_chunks, _WIDTH) gather and a sum along it);
    the chunk sums, in order, are the next level's entries.  The last
    level is one (n_out, K ≤ _WIDTH) table.  Short segments are padded
    with a zero.  A skewed pattern (one parameter shared by every
    residual) thus costs about m gathered entries a level over
    ⌈log₁₆ K_max⌉ levels, not n_out · K_max."""

    def __init__(self, seg, n_out: int, device=None):
        seg = np.asarray(seg, dtype=np.int64).reshape(-1)
        order = np.argsort(seg, kind="stable")
        lab = seg[order]       # segment of each entry of the level's input
        src = order            # where the level reads each entry
        self.tables = []
        while True:
            m = lab.size
            counts = np.bincount(lab, minlength=n_out)
            K = int(counts.max()) if m else 0
            pos = np.arange(m) - np.repeat(np.cumsum(counts) - counts, counts)
            if K <= _WIDTH:
                table = np.full((n_out, max(K, 1)), m, dtype=np.int64)
                table[lab, pos] = src
                self.tables.append(torch.as_tensor(table, device=device))
                return
            n_chunk = -(-counts // _WIDTH)                # per segment
            first = np.cumsum(n_chunk) - n_chunk          # its first chunk
            chunk = first[lab] + pos // _WIDTH
            table = np.full((int(n_chunk.sum()), _WIDTH), m, dtype=np.int64)
            table[chunk, pos % _WIDTH] = src
            self.tables.append(torch.as_tensor(table, device=device))
            lab = np.repeat(np.arange(n_out), n_chunk)
            src = np.arange(lab.size)

    def __call__(self, v: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Sum the entries of ``v`` along ``dim`` (the last axis by
        default; another axis keeps the trailing ones as the entries'
        values, e.g. blocks (..., m, w) summed along ``dim=-2``)."""
        dim = dim % v.dim()
        for table in self.tables:
            zero = v.new_zeros(v.shape[:dim] + (1,) + v.shape[dim + 1:])
            padded = torch.cat([v, zero], dim=dim)
            v = padded.index_select(dim, table.reshape(-1)).unflatten(
                dim, tuple(table.shape)).sum(dim=dim + 1)
        return v


class Pattern:
    """The static coordinate pattern of a batch of :class:`SparseSym`, on
    one device.  Compared by identity (pytree context)."""

    def __init__(self, rows, cols, dim: int, device=None):
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        cols = np.asarray(cols, dtype=np.int64).reshape(-1)
        self.dim = int(dim)
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.rows = torch.as_tensor(rows, device=self.device)
        self.cols = torch.as_tensor(cols, device=self.device)
        self.is_diag = self.rows == self.cols
        diag_pos = np.flatnonzero(rows == cols)
        self.diag_pos = torch.as_tensor(diag_pos, device=self.device)
        self.by_row = SegmentSum(rows, self.dim, self.device)
        self.diag_sum = SegmentSum(rows[diag_pos], self.dim, self.device)
        self._dense_sum = None
        self._rows_np, self._cols_np = rows, cols

    def dense_sum(self) -> SegmentSum:
        """The (dim², K) table of :meth:`SparseSym.to_dense`, built on first
        use."""
        if self._dense_sum is None:
            self._dense_sum = SegmentSum(
                self._rows_np * self.dim + self._cols_np,
                self.dim * self.dim, self.device)
        return self._dense_sum


class _DenseCov:
    """Duck-typed ``.to_dense()`` wrapper returned by :meth:`SparseSym.inv`
    and ``ops.schur.SchurSystem.inv`` (a structured matrix's inverse is
    dense; ``Output.covariance`` calls ``inv().to_dense()``)."""

    def __init__(self, a):
        self._a = a

    def to_dense(self):
        return self._a


@dataclasses.dataclass
class SparseSym:
    """Symmetric sparse matrices in coordinate form, both triangles stored
    (the CG matvec needs no symmetrization pass), one pattern a batch."""

    vals: torch.Tensor   #: (..., nse) values
    pattern: Pattern

    @staticmethod
    def from_pattern(rows, cols, vals, dim: int) -> "SparseSym":
        """A batch on ``vals``' device; ``rows`` / ``cols`` (nse,) host or
        tensor indices."""
        vals = torch.as_tensor(vals)
        as_np = (lambda a: a.detach().cpu().numpy()
                 if isinstance(a, torch.Tensor) else np.asarray(a))
        return SparseSym(vals, Pattern(as_np(rows), as_np(cols), dim,
                                       vals.device))

    @property
    def rows(self):
        return self.pattern.rows

    @property
    def cols(self):
        return self.pattern.cols

    @property
    def is_diag(self):
        """Value-dtype mask, 1 where row == col."""
        return self.pattern.is_diag.to(self.vals.dtype)

    @property
    def dim(self) -> int:
        return self.pattern.dim

    @property
    def shape(self):
        return (self.dim, self.dim)

    @property
    def dtype(self):
        return self.vals.dtype

    def to_dense(self) -> torch.Tensor:
        """(..., dim, dim); duplicate coordinates add."""
        d = self.dim
        return self.pattern.dense_sum()(self.vals).reshape(
            self.vals.shape[:-1] + (d, d))

    def diagonal(self) -> torch.Tensor:
        return self.pattern.diag_sum(self.vals[..., self.pattern.diag_pos])

    def damp(self, lam) -> "SparseSym":
        """Multiplicative diagonal damping ``H(i,i) *= 1 + λ`` (reference
        lm.h:107-117), λ one a leading index, with the absolute-λ fallback
        for exactly-zero diagonal entries so λ-escalation drives the
        system solvable (as ``ops.linalg.damp_diagonal``)."""
        lam = torch.as_tensor(lam, dtype=self.vals.dtype,
                              device=self.vals.device)[..., None]
        isd = self.is_diag
        zero_diag = isd * (self.vals == 0).to(self.vals.dtype)
        return SparseSym(self.vals * (1.0 + isd * lam) + zero_diag * lam,
                         self.pattern)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.pattern.by_row(self.vals * v[..., self.pattern.cols])

    def solve(self, b: torch.Tensor, *, cg_iters: int = 0,
              cg_tol: float = 0.0):
        """Solve ``H dx = b`` by Jacobi-preconditioned CG, ``cg_iters``
        iterations at most (0: ``dim``), each instance stopping on its own
        (``cg_to_tol``).  Returns ``(dx, ok)`` like ``solve_psd``: ``ok``
        is False where the iterate went non-finite (an indefinite or
        singular system), which routes the loop to λ escalation like the
        reference's failed LDLT (gn.h:150-171)."""
        diag = self.diagonal()
        safe = torch.where(diag > 0, diag, torch.ones_like(diag))
        dx = cg_to_tol(self.matvec, b, maxiter=cg_iters or self.dim,
                       tol=cg_tol, precond=lambda v: v / safe)
        return dx, torch.all(torch.isfinite(dx), dim=-1)

    def inv(self) -> _DenseCov:
        """Covariance = H⁻¹ (dense), with the reference's diagonal-shift
        retry where the first solve of an instance came back non-finite
        (math.h:115-137); the retry runs only when some instance needs
        it."""
        A = self.to_dense()
        cov = inv_cov(A)
        retry = ~torch.all(torch.isfinite(cov), dim=-1).all(dim=-1)
        if bool(retry.any()):
            eye = torch.eye(self.dim, dtype=A.dtype, device=A.device)
            shift = 4.0 * torch.finfo(A.dtype).eps * (
                1.0 + torch.amax(torch.abs(torch.diagonal(
                    A, dim1=-2, dim2=-1)), dim=-1))
            cov2 = inv_cov(A + shift[..., None, None] * eye)
            cov = torch.where(retry[..., None, None], cov2, cov)
        return _DenseCov(cov)


pytree.register_pytree_node(
    SparseSym, lambda s: ([s.vals], s.pattern),
    lambda v, pattern: SparseSym(v[0], pattern),
    serialized_type_name="tinyopt_tpu_torch.ops.sparse_sym.SparseSym")
