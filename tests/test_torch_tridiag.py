"""The block-tridiagonal solves of tinyopt_tpu_torch — ``ops/tridiag.py``
(the sequential factor and sweeps, the selected inverse, cyclic reduction,
the Woodbury solve and marginals, ``spd_inv_gj``) — against the JAX
package's ``ops/tridiag.py`` on the same inputs made with numpy, in
float64, at 1e-10 (tests/test_chain.py's cases, widened to N ∈ {1, 2, 3,
8, 37} and d ∈ {1, 3, 6}); the non-positive-definite cases give ``ok``
False and NaN exactly where JAX does; a leading batch of 3 instances
equals the JAX call on each instance alone."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyopt_tpu.ops import tridiag as _jtri

from tinyopt_tpu_torch.ops import tridiag as ttri

torch.set_num_threads(1)

TOL = 1e-10

# the JAX functions compiled whole: eager, every primitive of the cyclic
# reduction and the scans compiles on its own, several times slower
jtri = types.SimpleNamespace(**{
    name: jax.jit(getattr(_jtri, name), static_argnames=static)
    for name, static in [
        ("block_tridiag_factor", ()), ("block_tridiag_solve", ()),
        ("block_tridiag_selected_inverse_sub", ()),
        ("block_tridiag_cr_solve", ()),
        ("tridiag_woodbury_solve", ("method",)),
        ("tridiag_woodbury_marginals", ()),
        ("spd_inv_gj", ("unroll_max",))]})


def _system(seed, N, d, lead=(), pd_shift=3.0):
    rng = np.random.default_rng(seed)
    D = rng.normal(size=lead + (N, d, d))
    D = D @ np.swapaxes(D, -1, -2) + pd_shift * np.eye(d)
    B = 0.3 * rng.normal(size=lead + (max(N - 1, 0), d, d))
    return D, B, rng


def _dense(D, B):
    N, d = D.shape[0], D.shape[-1]
    H = np.zeros((N * d, N * d))
    for i in range(N):
        H[i * d:(i + 1) * d, i * d:(i + 1) * d] = D[i]
    for i in range(N - 1):
        H[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = B[i]
        H[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = B[i].T
    return H


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [1, 3, 6])
@pytest.mark.parametrize("N", [1, 2, 3, 8, 37])
def test_factor_solve_selected_inverse(N, d):
    D, B, rng = _system(N * 10 + d, N, d)
    bk = rng.normal(size=(N, d, 4))
    L, M, ok = jtri.block_tridiag_factor(*_j(D, B))
    Lt, Mt, okt = ttri.block_tridiag_factor(*_t(D, B))
    assert bool(ok) and bool(okt) and okt.shape == ()
    _close(Lt, L)
    _close(Mt, M)
    x = jtri.block_tridiag_solve(L, M, *_j(bk))
    xt = ttri.block_tridiag_solve(Lt, Mt, *_t(bk))
    _close(xt, x)
    # one right-hand side: the same column-by-column arithmetic
    _close(ttri.block_tridiag_solve(Lt, Mt, *_t(bk[..., 0])), x[..., 0])
    np.testing.assert_allclose(
        xt.numpy().reshape(N * d, 4),
        np.linalg.solve(_dense(D, B), bk.reshape(N * d, 4)),
        rtol=TOL, atol=TOL)
    sig, sub = jtri.block_tridiag_selected_inverse_sub(L, M)
    sig_t, sub_t = ttri.block_tridiag_selected_inverse_sub(Lt, Mt)
    assert tuple(sub_t.shape) == (N - 1, d, d)
    _close(sig_t, sig)
    _close(sub_t, sub)
    _close(ttri.block_tridiag_selected_inverse(Lt, Mt), sig)


@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 8, 16, 33])
def test_cyclic_reduction(N):
    """Both base cases (N = 1, 2) and the identity pad of an even N."""
    d = 4
    D, B, rng = _system(100 + N, N, d)
    b = rng.normal(size=(N, d, 3))
    x = ttri.block_tridiag_cr_solve(*_t(D, B, b))
    assert tuple(x.shape) == (N, d, 3)
    _close(x, jtri.block_tridiag_cr_solve(*_j(D, B, b)))
    _close(ttri.block_tridiag_cr_solve(*_t(D, B, b[..., 0])),
           jtri.block_tridiag_cr_solve(*_j(D, B, b[..., 0])))


@pytest.mark.parametrize("method", ["scan", "cr"])
def test_asymmetric_blocks_factor_their_symmetric_part(method):
    """Diagonal blocks whose upper triangle differs from the lower one (as
    rounding leaves D − B D⁻¹ Bᵀ): each block Cholesky factors the
    symmetric part (A + Aᵀ)/2, as JAX's ``cholesky`` does, not the lower
    triangle alone."""
    N, d = 9, 4
    D, B, rng = _system(7, N, d)
    D = D + np.triu(0.05 * rng.normal(size=(N, d, d)), 1)
    b = rng.normal(size=(N, d, 2))
    if method == "cr":
        _close(ttri.block_tridiag_cr_solve(*_t(D, B, b)),
               jtri.block_tridiag_cr_solve(*_j(D, B, b)))
    else:
        L, M, _ = jtri.block_tridiag_factor(*_j(D, B))
        Lt, Mt, _ = ttri.block_tridiag_factor(*_t(D, B))
        _close(Lt, L)
        _close(ttri.block_tridiag_solve(Lt, Mt, *_t(b)),
               jtri.block_tridiag_solve(L, M, *_j(b)))


@pytest.mark.parametrize("m", [0, 7])
@pytest.mark.parametrize("method", ["scan", "cr"])
def test_woodbury_solve(method, m):
    N, d = 12, 3
    D, B, rng = _system(200 + m, N, d)
    U = 0.5 * rng.normal(size=(N, d, m))
    b = rng.normal(size=(N, d))
    x, ok = jtri.tridiag_woodbury_solve(*_j(D, B, U, b), method=method)
    before = dict(ttri.SOLVES)
    xt, okt = ttri.tridiag_woodbury_solve(*_t(D, B, U, b), method=method)
    assert ttri.SOLVES[method] == before[method] + 1
    assert bool(ok) and bool(okt)
    _close(xt, x)
    Uf = U.reshape(N * d, m)
    np.testing.assert_allclose(
        xt.numpy().reshape(-1),
        np.linalg.solve(_dense(D, B) + Uf @ Uf.T, b.reshape(-1)),
        rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        ttri.tridiag_woodbury_solve(*_t(D, B, U, b), method="auto")


@pytest.mark.parametrize("m", [0, 7])
def test_woodbury_marginals(m):
    N, d = 10, 6
    D, B, rng = _system(300 + m, N, d)
    U = 0.5 * rng.normal(size=(N, d, m))
    marg, ok = jtri.tridiag_woodbury_marginals(*_j(D, B, U))
    marg_t, ok_t = ttri.tridiag_woodbury_marginals(*_t(D, B, U))
    assert bool(ok) and bool(ok_t)
    _close(marg_t, marg)
    Uf = U.reshape(N * d, m)
    dense = np.linalg.inv(_dense(D, B) + Uf @ Uf.T)
    for i in (0, N // 2, N - 1):
        np.testing.assert_allclose(
            marg_t[i].numpy(), dense[i * d:(i + 1) * d, i * d:(i + 1) * d],
            rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [1, 3, 6, 42, 60])
def test_spd_inv_gj(d):
    """d ≤ 48 takes the unrolled form, d = 60 the looped one."""
    rng = np.random.default_rng(d)
    A = rng.normal(size=(5, d, d))
    A = A @ A.transpose(0, 2, 1) + d * np.eye(d)
    inv = ttri.spd_inv_gj(*_t(A))
    _close(inv, jtri.spd_inv_gj(*_j(A)))
    np.testing.assert_allclose(inv.numpy() @ A,
                               np.broadcast_to(np.eye(d), A.shape),
                               atol=1e-8)


@pytest.mark.parametrize("unroll_max", [48, 0])
def test_spd_inv_gj_not_pd(unroll_max):
    bad = np.stack([-np.eye(4),                          # negative
                    np.eye(4) - 2.0 * np.ones((4, 4)),   # indefinite
                    np.eye(4)])                          # fine
    out = ttri.spd_inv_gj(*_t(bad), unroll_max=unroll_max)
    _close(out, jtri.spd_inv_gj(*_j(bad), unroll_max=unroll_max))
    assert torch.isnan(out[:2]).all()


def test_not_positive_definite():
    """A negative pivot block: ``ok`` False and NaN exactly where JAX has
    them, for the factor, both Woodbury methods and the marginals."""
    N, d, m = 9, 3, 4
    D, B, rng = _system(400, N, d)
    D[4] = -np.eye(d)
    U = 0.5 * rng.normal(size=(N, d, m))
    b = rng.normal(size=(N, d))
    L, M, ok = jtri.block_tridiag_factor(*_j(D, B))
    Lt, Mt, okt = ttri.block_tridiag_factor(*_t(D, B))
    assert not bool(ok) and not bool(okt)
    _close(Lt, L)
    _close(Mt, M)
    for method in ("scan", "cr"):
        x, ok = jtri.tridiag_woodbury_solve(*_j(D, B, U, b), method=method)
        xt, okt = ttri.tridiag_woodbury_solve(*_t(D, B, U, b), method=method)
        assert not bool(ok) and not bool(okt)
        _close(xt, x)
    _close(ttri.block_tridiag_cr_solve(*_t(D, B, b)),
           jtri.block_tridiag_cr_solve(*_j(D, B, b)))
    marg, ok = jtri.tridiag_woodbury_marginals(*_j(D, B, U))
    marg_t, okt = ttri.tridiag_woodbury_marginals(*_t(D, B, U))
    assert not bool(ok) and not bool(okt)
    _close(marg_t, marg)


def test_batch_of_three():
    """A leading batch of 3 instances, the middle one not positive
    definite: every function equals the JAX call on each instance, and
    ``ok`` is per instance."""
    N, d, m = 7, 3, 5
    D, B, rng = _system(500, N, d, lead=(3,))
    D[1, 2] = -np.eye(d)
    U = 0.5 * rng.normal(size=(3, N, d, m))
    b = rng.normal(size=(3, N, d))
    Lt, Mt, okt = ttri.block_tridiag_factor(*_t(D, B))
    sig_t, sub_t = ttri.block_tridiag_selected_inverse_sub(Lt, Mt)
    xs_t = ttri.block_tridiag_solve(Lt, Mt, *_t(b))
    cr_t = ttri.block_tridiag_cr_solve(*_t(D, B, b))
    wb = {k: ttri.tridiag_woodbury_solve(*_t(D, B, U, b), method=k)
          for k in ("scan", "cr")}
    marg_t, okm_t = ttri.tridiag_woodbury_marginals(*_t(D, B, U))
    assert okt.tolist() == [True, False, True]
    assert okm_t.tolist() == [True, False, True]
    for k in ("scan", "cr"):
        assert wb[k][1].tolist() == [True, False, True]
    for i in range(3):
        L, M, ok = jtri.block_tridiag_factor(*_j(D[i], B[i]))
        assert bool(ok) == bool(okt[i])
        _close(Lt[i], L)
        _close(Mt[i], M)
        sig, sub = jtri.block_tridiag_selected_inverse_sub(L, M)
        _close(sig_t[i], sig)
        _close(sub_t[i], sub)
        _close(xs_t[i], jtri.block_tridiag_solve(L, M, *_j(b[i])))
        _close(cr_t[i], jtri.block_tridiag_cr_solve(*_j(D[i], B[i], b[i])))
        for k in ("scan", "cr"):
            x, ok = jtri.tridiag_woodbury_solve(*_j(D[i], B[i], U[i], b[i]),
                                                method=k)
            assert bool(ok) == bool(wb[k][1][i])
            _close(wb[k][0][i], x)
        marg, ok = jtri.tridiag_woodbury_marginals(*_j(D[i], B[i], U[i]))
        _close(marg_t[i], marg)
