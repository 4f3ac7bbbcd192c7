"""Block-tridiagonal Cholesky + Woodbury low-rank correction, batched.

Counterpart of ``tinyopt_tpu.ops.tridiag``: the direct solver for
CHAIN-structured normal equations — the pose-graph / odometry backbone of
SLAM.  N parameter blocks of d dims, consecutive blocks coupled by
measurements (a block-tridiagonal T with diagonal blocks ``D`` and
sub-diagonal blocks ``B``, ``T[i+1, i] = B[i]``), plus a handful of
loop-closure measurements that couple distant blocks (a rank-m update
U·Uᵀ with m = Σ loop residual dims ≪ N·d).

Every function takes leading instance axes: ``D`` (..., N, d, d), ``B``
(..., N−1, d, d), ``U`` (..., N, d, m), ``b`` (..., N, d) or
(..., N, d, k); ``ok`` is a per-instance boolean tensor (...).  Nothing
here synchronizes with the host, so a solve on the card queues its
launches and returns.

* **The scan** of the JAX package (its sequential factor and the two
  triangular sweeps) is a Python loop over the N blocks of batched
  (d × d) operations: about four launches a block and a sweep.  k
  right-hand sides ride through the sweeps as one (d, k) product a block,
  which is how the Woodbury correction gets T⁻¹U for all m columns in the
  same two sweeps that solve T⁻¹g.
* **Cyclic reduction** (:func:`block_tridiag_cr_solve`) eliminates all odd
  blocks at once and recurses on the even half: ⌈log₂N⌉ levels of batched
  operations instead of N steps, about twice the arithmetic.  It is the
  chain solver's method on the card, where the scan is bound by its
  launches.
* **Failures.** ``torch.linalg.cholesky`` raises on a block that is not
  positive definite where JAX returns NaN; ``cholesky_ex`` runs instead and
  the blocks whose ``info`` is not 0 are set to NaN on and below their
  diagonal, as JAX leaves a failed block, the same for the Woodbury
  capacitance W.  The NaN reaches ``ok`` and the loop's λ
  escalation, as in the JAX package (``ops/schur_obs.spd_inv_blocks``).

Float32 on the card needs TF32 off (torch's default for matmuls): the
chain's O(N²) conditioning turns truncated products into a diverging
solve, which is why the JAX package pins every contraction here to
``Precision.HIGHEST``.

Not ported: the JAX package's opt-in sweep-inverse level math of the
cyclic reduction (``TINYOPT_CR_SWEEP_INV``), measured to cost half a digit
a solve; :func:`spd_inv_gj` itself is here, and no path calls it.
"""

from __future__ import annotations

import torch


def _nan_like(A: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=A.dtype, device=A.device)


def _chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of every block of ``A`` (..., d, d), of its
    symmetric part (A + Aᵀ)/2 as JAX's ``cholesky`` factors it; a block
    that is not positive definite comes out NaN on and below its diagonal
    and 0 above it, as JAX's ``cholesky`` gives it.

    The blocks that cyclic reduction and the scan build (D − B D⁻¹ Bᵀ) are
    symmetric only up to rounding; on the lower triangle alone the float32
    banded reduced solve of bundle adjustment near convergence drifted
    far from the float64 one, and its refinement rounds diverged
    (``tests/torch_ba_sparse_f32_study.py --probe``)."""
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    d = A.shape[-1]
    lower = torch.ones((d, d), dtype=torch.bool, device=A.device).tril()
    return torch.where((info != 0)[..., None, None] & lower, _nan_like(A),
                       L)


def _tri(L: torch.Tensor, b: torch.Tensor, upper: bool = False):
    """``L⁻¹ b`` for lower-triangular ``L`` (``Lᵀ`` given as ``L.mT`` with
    ``upper=True``): one batched triangular solve."""
    return torch.linalg.solve_triangular(L, b, upper=upper)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ b`` by two triangular solves (``jax.scipy.linalg.
    cho_solve``; batched ``cholesky_solve`` on CUDA may loop over the batch
    for several right-hand sides)."""
    return _tri(L.mT, _tri(L, b), upper=True)


def _all_finite(t: torch.Tensor, n_tail: int) -> torch.Tensor:
    """Per-instance finiteness over the last ``n_tail`` axes."""
    return torch.all(torch.isfinite(t).flatten(-n_tail), dim=-1)


def block_tridiag_factor(D: torch.Tensor, B: torch.Tensor):
    """Block Cholesky ``H₀ = L Lᵀ`` of the symmetric block-tridiagonal
    matrix with diagonal blocks ``D`` (..., N, d, d) and sub-diagonal
    blocks ``B`` (..., N−1, d, d).

    Returns ``(L, M, ok)``: ``L`` (..., N, d, d) lower-triangular diagonal
    factor blocks, ``M`` (..., N−1, d, d) sub-diagonal factor blocks, and
    ``ok`` (...), False where some pivot block was not positive definite
    (that instance's factor then holds NaNs)."""
    N, d = D.shape[-3], D.shape[-1]
    Ls = [_chol(D[..., 0, :, :])]
    Ms = []
    for i in range(1, N):
        # M_i L_prevᵀ = B_{i-1}  ⇒  L_prev M_iᵀ = B_{i-1}ᵀ
        M_i = _tri(Ls[-1], B[..., i - 1, :, :].mT).mT
        Ls.append(_chol(D[..., i, :, :] - M_i @ M_i.mT))
        Ms.append(M_i)
    L = torch.stack(Ls, dim=-3)
    M = (torch.stack(Ms, dim=-3) if Ms
         else D.new_zeros(D.shape[:-3] + (0, d, d)))
    return L, M, _all_finite(L, 3)


def block_tridiag_solve(L: torch.Tensor, M: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Solve ``H₀ x = b`` from the factor ``(L, M)``.

    ``b`` is (..., N, d) or (..., N, d, k): k right-hand sides are solved
    together, one (d, k) product a block and a sweep."""
    squeeze = b.dim() == L.dim() - 1
    if squeeze:
        b = b[..., None]
    N = L.shape[-3]
    # forward: L y = b
    ys = [_tri(L[..., 0, :, :], b[..., 0, :, :])]
    for i in range(1, N):
        ys.append(_tri(L[..., i, :, :],
                       b[..., i, :, :] - M[..., i - 1, :, :] @ ys[-1]))
    # backward: Lᵀ x = y
    xs = [_tri(L[..., N - 1, :, :].mT, ys[N - 1], upper=True)]
    for i in range(N - 2, -1, -1):
        xs.append(_tri(L[..., i, :, :].mT,
                       ys[i] - M[..., i, :, :].mT @ xs[-1], upper=True))
    x = torch.stack(xs[::-1], dim=-3)
    return x[..., 0] if squeeze else x


def _selected_inverse(L: torch.Tensor, M: torch.Tensor):
    """``(Σ_ii, A)`` of the Takahashi recursion, with ``A_i = M_i L_i⁻¹``.

    The independent work of every step runs for all i at once (L_i⁻¹, A_i
    and L_i⁻ᵀL_i⁻¹: three batched launches); the reverse loop keeps only
    Σ_ii = L_i⁻ᵀL_i⁻¹ + (A_iᵀ Σ_{i+1}) A_i, two launches a block — the
    arithmetic of the JAX package's scan step."""
    N, d = L.shape[-3], L.shape[-1]
    eye = torch.eye(d, dtype=L.dtype, device=L.device)
    Linv = _tri(L, eye.expand(L.shape))
    P = Linv.mT @ Linv
    A = M @ Linv[..., :-1, :, :]
    lead = L.shape[:-3]
    nb = lead.numel()
    Pf = P.reshape((nb, N, d, d))
    Af = A.reshape((nb, N - 1, d, d))
    sig = [Pf[:, N - 1]]
    for i in range(N - 2, -1, -1):
        sig.append(torch.baddbmm(Pf[:, i], Af[:, i].mT @ sig[-1], Af[:, i]))
    Sig = torch.stack(sig[::-1], dim=1).reshape(lead + (N, d, d))
    return Sig, A


def block_tridiag_selected_inverse(L: torch.Tensor,
                                   M: torch.Tensor) -> torch.Tensor:
    """Diagonal blocks of ``(L Lᵀ)⁻¹`` from the block-bidiagonal factor —
    the Takahashi selected-inverse recursion.

    With ``A_i = M_i L_i⁻¹``: Σ_NN = L_N⁻ᵀL_N⁻¹ and Σ_ii = L_i⁻ᵀL_i⁻¹ +
    A_iᵀ Σ_{i+1,i+1} A_i, a reverse loop of (d, d) products, O(N·d³), so
    the marginals of an N-pose graph cost about one more factorization
    instead of the O(N²·d²) dense inverse.  Returns Σ_ii (..., N, d, d)."""
    return _selected_inverse(L, M)[0]


def block_tridiag_selected_inverse_sub(L: torch.Tensor, M: torch.Tensor):
    """Diagonal AND sub-diagonal blocks of ``(L Lᵀ)⁻¹`` — the extended
    Takahashi recursion: Σ_{i+1,i} = −Σ_{i+1,i+1} A_i, one batched product
    after the reverse loop.  Returns ``(Σ_ii (..., N, d, d), Σ_{i+1,i}
    (..., N−1, d, d))``, the entries a banded system's marginals need."""
    Sig, A = _selected_inverse(L, M)
    return Sig, -(Sig[..., 1:, :, :] @ A)


def tridiag_woodbury_marginals(D: torch.Tensor, B: torch.Tensor,
                               U: torch.Tensor):
    """Per-block marginal covariance of ``H = T + U Uᵀ``: the diagonal
    (d, d) blocks of H⁻¹.

    Takahashi's selected inverse of T and the Woodbury rank-m downdate
    restricted to the diagonal blocks:

        H⁻¹ = T⁻¹ − Z W⁻¹ Zᵀ,  Z = T⁻¹U,  W = I_m + Uᵀ Z
        marg_i = Σ_ii − Z_i W⁻¹ Z_iᵀ

    Returns ``(marg (..., N, d, d), ok (...))``; O(N·(d³ + d²·m) + m³),
    never dense in N·d."""
    N, d, m = U.shape[-3:]
    L, M, ok = block_tridiag_factor(D, B)
    Sig = block_tridiag_selected_inverse(L, M)
    if m == 0:
        return Sig, ok & _all_finite(Sig, 3)
    Z = block_tridiag_solve(L, M, U)                     # (..., N, d, m)
    lead = U.shape[:-3]
    W = (torch.eye(m, dtype=U.dtype, device=U.device)
         + torch.einsum("...ndm,...ndp->...mp", U, Z))
    Lw = _chol(W)
    # W⁻¹ Z_iᵀ for every i: the N·d columns as one (m, N·d) right-hand side
    Zt = Z.movedim(-1, -3).reshape(lead + (m, N * d))
    WinvZt = _cho_solve(Lw, Zt).reshape(lead + (m, N, d)).movedim(-3, -2)
    Sig = Sig - Z @ WinvZt
    return Sig, ok & _all_finite(Lw, 2) & _all_finite(Sig, 3)


def spd_inv_gj(A: torch.Tensor, unroll_max: int = 48) -> torch.Tensor:
    """Explicit inverse of every SPD block of ``A`` (..., d, d) by
    Gauss-Jordan elimination without pivoting on ``(A | I)``.

    Pivoting-free Gauss-Jordan has the leading-minor pivots of a Cholesky
    factorization, so a block is declared not positive definite exactly
    when Cholesky would fail: some pivot ≤ 0 (or NaN); those blocks come
    out NaN.  For d ≤ ``unroll_max`` the d steps slice by Python ints;
    above it, by index tensors (the JAX package's unrolled and
    ``fori_loop`` forms).  No path of the port calls it: the cyclic
    reduction's levels use Cholesky, which the JAX package measured to be
    half a digit more accurate a solve."""
    d = A.shape[-1]
    M = torch.cat([A, torch.eye(d, dtype=A.dtype, device=A.device)
                   .expand(A.shape)], dim=-1)
    minpiv = torch.full(A.shape[:-2], float("inf"), dtype=A.dtype,
                        device=A.device)
    rows = torch.arange(d, device=A.device)
    if d <= unroll_max:
        for j in range(d):
            piv = M[..., j, j]
            minpiv = torch.minimum(minpiv, piv)
            row = M[..., j, :] / piv[..., None]
            M = M - M[..., :, j:j + 1] * row[..., None, :]
            M = torch.where((rows == j)[:, None], row[..., None, :], M)
    else:
        for j in range(d):
            jt = torch.tensor([j], device=A.device)
            piv = M.index_select(-2, jt).index_select(-1, jt)[..., 0, 0]
            minpiv = torch.minimum(minpiv, piv)
            row = M.index_select(-2, jt) / piv[..., None, None]
            col = M.index_select(-1, jt)
            M = (M - col * row).index_copy(-2, jt, row)
    inv = M[..., :, d:]
    return torch.where((minpiv > 0)[..., None, None], inv, _nan_like(A))


#: Solves of :func:`tridiag_woodbury_solve` by method since the last reset
#: (the chain solver's choice is read from here, e.g. that the card took
#: "cr"); a caller sets the counts to 0 and reads them after a run.
SOLVES = {"scan": 0, "cr": 0}


def block_tridiag_cr_solve(D: torch.Tensor, B: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system by block CYCLIC REDUCTION —
    the log-depth alternative to the sequential scan.

    Each level eliminates all ODD blocks at once (a batched (d × d)
    Cholesky and a handful of batched products over N/2 blocks) and
    recurses on the even half: ⌈log₂N⌉ levels instead of N sequential
    steps.  For SPD systems it is the Cholesky of a nested-dissection
    reordering, numerically stable.  ``b`` is (..., N, d) or
    (..., N, d, k).  Blocks that are not positive definite surface as NaNs
    in the result (the caller checks finiteness)."""
    squeeze = b.dim() == D.dim() - 1
    if squeeze:
        b = b[..., None]
    x = _cr_solve(D, B, b)
    return x[..., 0] if squeeze else x


def _blk(t: torch.Tensor, sl) -> torch.Tensor:
    """Blocks ``sl`` of the block axis (-3) of ``t``."""
    return t[..., sl, :, :]


def _cr_solve(D, B, b):
    N, d = D.shape[-3], D.shape[-1]
    if N == 1:
        return _cho_solve(_chol(D[..., 0, :, :]), b[..., 0, :, :])[..., None,
                                                                    :, :]
    if N == 2:
        # base case (an even pad would recurse 2 → 3 → 2 forever):
        # Schur-eliminate block 1 into block 0
        B0 = B[..., 0, :, :]
        L1 = _chol(D[..., 1, :, :])
        Y = _cho_solve(L1, B0)                    # D₁⁻¹ B₀
        yb = _cho_solve(L1, b[..., 1, :, :])
        L0 = _chol(D[..., 0, :, :] - B0.mT @ Y)
        x0 = _cho_solve(L0, b[..., 0, :, :] - B0.mT @ yb)
        x1 = yb - Y @ x0
        return torch.stack([x0, x1], dim=-3)
    n0 = N
    if N % 2 == 0:
        # decoupled identity pad → odd size, so every odd block has both
        # even neighbours (trimmed off the returned solution)
        lead = D.shape[:-3]
        eye = torch.eye(d, dtype=D.dtype, device=D.device)
        D = torch.cat([D, eye.expand(lead + (1, d, d))], dim=-3)
        B = torch.cat([B, B.new_zeros(lead + (1, d, d))], dim=-3)
        b = torch.cat([b, b.new_zeros(b.shape[:-3] + (1,) + b.shape[-2:])],
                      dim=-3)
        N += 1
    Do, bo = _blk(D, slice(1, None, 2)), _blk(b, slice(1, None, 2))
    Bl = _blk(B, slice(0, None, 2))            # B[2k]   = H[2k+1, 2k]
    Br = _blk(B, slice(1, None, 2))            # B[2k+1] = H[2k+2, 2k+1]
    Lo = _chol(Do)
    Yl = _cho_solve(Lo, Bl)                    # D⁻¹ Bl
    Zr = _cho_solve(Lo, Br.mT)                 # D⁻¹ Brᵀ
    Yb = _cho_solve(Lo, bo)                    # D⁻¹ b_odd
    De = _blk(D, slice(0, None, 2)).clone()
    be = _blk(b, slice(0, None, 2)).clone()
    De[..., 1:, :, :] -= Br @ Zr
    De[..., :-1, :, :] -= Bl.mT @ Yl
    be[..., 1:, :, :] -= Br @ Yb
    be[..., :-1, :, :] -= Bl.mT @ Yb
    Be = -(Br @ Yl)
    x_even = _cr_solve(De, Be, be)
    x_odd = (Yb - Yl @ _blk(x_even, slice(None, -1))
             - Zr @ _blk(x_even, slice(1, None)))
    x = x_even.new_empty(x_even.shape[:-3] + (N,) + x_even.shape[-2:])
    x[..., 0::2, :, :] = x_even
    x[..., 1::2, :, :] = x_odd
    return _blk(x, slice(None, n0))


def tridiag_woodbury_solve(D: torch.Tensor, B: torch.Tensor,
                           U: torch.Tensor, b: torch.Tensor,
                           method: str = "scan"):
    """Solve ``(T + U Uᵀ) x = b`` with T block-tridiagonal ``(D, B)`` and
    ``U`` (..., N, d, m) a tall low-rank factor (loop closures).

    Woodbury: x = z_b − Z_U (I_m + Uᵀ Z_U)⁻¹ Uᵀ z_b with ``[z_b, Z_U] =
    T⁻¹ [b, U]`` — ONE tridiagonal solve with 1 + m right-hand sides, then
    an (m, m) dense Cholesky.  Returns ``(x (..., N, d), ok (...))``.
    ``method``: "scan" (the sequential factor and sweeps — the least
    arithmetic, right for the CPU) or "cr" (cyclic reduction — right for
    the card, where the scan is bound by its launches).  Each call adds
    one to ``SOLVES[method]``."""
    if method not in SOLVES:
        raise ValueError(f"method must be scan|cr, got {method!r}")
    SOLVES[method] += 1
    m = U.shape[-1]
    rhs = torch.cat([b[..., None], U], dim=-1)           # (..., N, d, 1+m)
    if method == "cr":
        Z = block_tridiag_cr_solve(D, B, rhs)
        ok = _all_finite(Z, 3)
    else:
        L, M, ok = block_tridiag_factor(D, B)
        Z = block_tridiag_solve(L, M, rhs)
    z_b, Z_U = Z[..., 0], Z[..., 1:]
    if m == 0:
        return z_b, ok & _all_finite(z_b, 2)
    W = (torch.eye(m, dtype=U.dtype, device=U.device)
         + torch.einsum("...ndm,...ndp->...mp", U, Z_U))
    Lw = _chol(W)
    c = _cho_solve(Lw, torch.einsum("...ndm,...nd->...m", U, z_b)[..., None])
    x = z_b - (Z_U @ c[..., None, :, :])[..., 0]
    return x, ok & _all_finite(Lw, 2) & _all_finite(x, 2)
