"""Block-diagonal Hessian representation, batched.

Counterpart of ``tinyopt_tpu.ops.block`` (reference: include/tinyopt/
solvers/gn.h:63-74, math.h:266-277 — the general ``SparseMatrix`` path)
for the sparsity that NLLS normal equations actually have: independent
parameter blocks.  ``blocks`` has shape (..., nb, bs, bs): any leading
axes are instances (the loop's (B, nb, bs, bs); none after ``optimize``
squeezes a batch of one), and every reduction runs over the block axes of
one instance only.  A batched Cholesky over all blocks of all instances
is the solve.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from .linalg import damp_diagonal, solve_psd


@dataclasses.dataclass
class BlockDiag:
    """Block-diagonal matrix: ``nb`` dense ``bs × bs`` blocks an instance."""

    blocks: torch.Tensor  #: (..., nb, bs, bs)

    @property
    def nb(self) -> int:
        return self.blocks.shape[-3]

    @property
    def bs(self) -> int:
        return self.blocks.shape[-1]

    @property
    def dim(self) -> int:
        return self.nb * self.bs

    @property
    def shape(self):
        return (self.dim, self.dim)

    def _lead(self):
        return tuple(self.blocks.shape[:-3])

    def to_dense(self) -> torch.Tensor:
        """(..., n, n), zero off the blocks."""
        nb, bs = self.nb, self.bs
        dense = self.blocks.new_zeros(self._lead() + (nb, bs, nb, bs))
        idx = torch.arange(nb, device=self.blocks.device)
        # the two index tensors move their axis to the front
        dense[..., idx, :, idx, :] = self.blocks.movedim(-3, 0)
        return dense.reshape(self._lead() + (self.dim, self.dim))

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.blocks, dim1=-2, dim2=-1).reshape(
            self._lead() + (self.dim,))

    def damp(self, lam) -> "BlockDiag":
        """Multiplicative damping ``H(i,i) *= 1 + λ`` of every block, λ one
        a leading index (``ops.linalg.damp_diagonal``)."""
        lam = torch.as_tensor(lam, dtype=self.blocks.dtype,
                              device=self.blocks.device)
        return BlockDiag(damp_diagonal(self.blocks, lam[..., None]))

    def solve(self, b: torch.Tensor, use_cholesky: bool = True):
        """Solve ``H dx = b`` (b (..., n)); returns ``(dx, ok)`` like
        ``solve_psd``, ``ok`` the AND over one instance's blocks."""
        bb = b.reshape(self._lead() + (self.nb, self.bs))
        dx, ok = solve_psd(self.blocks, bb, use_cholesky=use_cholesky)
        return dx.reshape(b.shape), torch.all(ok, dim=-1)

    def inv(self) -> "BlockDiag":
        """Blockwise inverse — the sparse covariance (math.h:115-137);
        non-finite where a block is singular, as ``jnp.linalg.inv``."""
        return BlockDiag(torch.linalg.inv_ex(self.blocks)[0])

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        vv = v.reshape(self._lead() + (self.nb, self.bs))
        return torch.einsum("...nij,...nj->...ni", self.blocks,
                            vv).reshape(v.shape)


pytree.register_pytree_node(
    BlockDiag, lambda s: ([s.blocks], None), lambda v, _: BlockDiag(*v),
    serialized_type_name="tinyopt_tpu_torch.ops.block.BlockDiag")
