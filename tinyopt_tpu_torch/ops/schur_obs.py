"""Batched inverse of the landmark blocks of a bipartite system.

Counterpart of ``tinyopt_tpu.ops.schur_obs.spd_inv_blocks`` only.  The
rest of that module, the sparse-observation (point-major) Schur system
behind ``schur_sparse_optimize`` with its windowed reduce, band storage,
sort and buckets, is a later item of the port (ROADMAP Queue 1, item 16)
and is not here yet.
"""

from __future__ import annotations

import torch


def spd_inv_blocks(C: torch.Tensor) -> torch.Tensor:
    """Inverse of every SPD block of ``C`` (..., db, db), NaN where a block
    is not positive definite.

    db ≤ 3: the closed-form adjugate inverse, elementwise arithmetic with
    positive-definiteness decided by Sylvester's leading principal minors,
    so a non-PD block comes out NaN as a failed Cholesky would.  db > 3: a
    Cholesky inverse; ``torch.linalg.cholesky`` raises on a non-PD block
    where JAX returns NaN, so ``cholesky_ex`` runs and the blocks whose
    ``info`` is not 0 are set to NaN.  Either way the NaN reaches the
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
    L, info = torch.linalg.cholesky_ex(C)
    eye = torch.eye(db, dtype=C.dtype, device=C.device).expand(C.shape)
    Ci = torch.cholesky_solve(eye, L)
    return torch.where((info == 0)[..., None, None], Ci, nan)
