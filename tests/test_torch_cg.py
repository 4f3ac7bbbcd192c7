"""K1 and its plain twin: tinyopt_tpu_torch.ops.linalg / ops.cuda_cg against
tinyopt_tpu.ops.linalg and the body of the Pallas CG kernel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyopt_tpu.ops import linalg as jlin
from tinyopt_tpu.ops import pallas_cg
from tinyopt_tpu.ops.pallas_cg import make_cg_solver, pcg_on_values

from tinyopt_tpu_torch.ops import cuda_cg
from tinyopt_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)

# f64: the two packages sum the matvec and the dot products in another
# order, so agreement is to rounding; f32 likewise at single precision.
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _spd(rng, B, d, dtype):
    A = rng.normal(size=(B, 2 * d, d)) / np.sqrt(2 * d)
    H = np.einsum("bki,bkj->bij", A, A) + 1e-3 * np.eye(d)
    b = rng.normal(size=(B, d))
    return H.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("iters", [3, 12])
def test_solve_psd_cg_matches_reference(dtype, iters, monkeypatch):
    H, b = _spd(np.random.default_rng(iters), 13, 9, dtype)
    ref = np.asarray(jlin.solve_psd_cg(jnp.asarray(H), jnp.asarray(b), iters))
    body = np.asarray(pcg_on_values(jnp.asarray(H), jnp.asarray(b), iters))
    vm = np.asarray(jax.vmap(make_cg_solver(iters))(jnp.asarray(H),
                                                    jnp.asarray(b)))
    # the Pallas kernel itself (batch padded to its 256-instance tile), in
    # interpret mode on the CPU
    monkeypatch.setattr(pallas_cg.pl, "pallas_call", functools.partial(
        pallas_cg.pl.pallas_call, interpret=True))
    kern = np.asarray(pallas_cg.batched_cg_tpu(jnp.asarray(H), jnp.asarray(b),
                                               iters))
    got = tlin.solve_psd_cg(torch.from_numpy(H), torch.from_numpy(b),
                            iters).numpy()
    for r in (ref, body, vm, kern):
        np.testing.assert_allclose(got, r, rtol=TOL[dtype], atol=TOL[dtype])


def test_pcg_core_matrix_free_matches_reference():
    rng = np.random.default_rng(5)
    H, b = _spd(rng, 6, 7, np.float64)
    dinv = 1.0 / np.einsum("bii->bi", H)
    ref = jlin.pcg_core(lambda p: jnp.einsum("bij,bj->bi", jnp.asarray(H), p),
                        jnp.asarray(dinv), jnp.asarray(b), 7)
    Ht = torch.from_numpy(H)
    got = tlin.pcg_core(lambda p: torch.einsum("bij,bj->bi", Ht, p),
                        torch.from_numpy(dinv), torch.from_numpy(b), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_alpha_freeze_on_zero_curvature():
    """pᵀHp ≤ tiny freezes the iterate (α = 0): H = 0 leaves x at 0; a
    zero row/column with a zero right-hand side never moves its
    coordinate."""
    rng = np.random.default_rng(1)
    H, b = _spd(rng, 4, 5, np.float64)
    H[0] = 0.0
    H[1, -1, :] = 0.0
    H[1, :, -1] = 0.0
    b[1, -1] = 0.0
    ref = np.asarray(jlin.solve_psd_cg(jnp.asarray(H), jnp.asarray(b), 6))
    got = cuda_cg.cg_solve(torch.from_numpy(H), torch.from_numpy(b),
                           6).numpy()
    assert np.all(got[0] == 0.0) and np.all(ref[0] == 0.0)
    assert got[1, -1] == 0.0 and ref[1, -1] == 0.0
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_damp_and_cholesky_solve_match_reference():
    rng = np.random.default_rng(2)
    H, b = _spd(rng, 5, 6, np.float64)
    H[2] = -H[2]                                 # not PSD: must fail
    lam = rng.uniform(1e-4, 1.0, (5,))
    Hd_ref = jax.vmap(jlin.damp_diagonal)(jnp.asarray(H), jnp.asarray(lam))
    Hd = tlin.damp_diagonal(torch.from_numpy(H), torch.from_numpy(lam))
    np.testing.assert_array_equal(Hd.numpy(), np.asarray(Hd_ref))
    dx_r, ok_r = jlin.solve_psd(Hd_ref, jnp.asarray(b))
    dx, ok = tlin.solve_psd(Hd, torch.from_numpy(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert not bool(ok[2])
    np.testing.assert_allclose(dx.numpy()[ok.numpy()],
                               np.asarray(dx_r)[np.asarray(ok_r)],
                               rtol=1e-10, atol=1e-12)


def test_cg_solve_on_cpu_takes_the_twin():
    H, b = _spd(np.random.default_rng(3), 8, 4, np.float32)
    before = cuda_cg.cg_solve.launches
    x = cuda_cg.cg_solve(torch.from_numpy(H), torch.from_numpy(b), 4)
    assert cuda_cg.cg_solve.launches == before
    np.testing.assert_array_equal(
        x.numpy(), tlin.solve_psd_cg(torch.from_numpy(H), torch.from_numpy(b),
                                     4).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_kernel_matches_twin_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    H, b = _spd(np.random.default_rng(4), 1000, 50, np.float64)
    Hc = torch.from_numpy(H).to("cuda", dtype)
    bc = torch.from_numpy(b).to("cuda", dtype)
    before = cuda_cg.cg_solve.launches
    xk = cuda_cg.cg_solve(Hc, bc, 12)
    assert cuda_cg.cg_solve.launches == before + 1
    xt = tlin.solve_psd_cg(Hc, bc, 12)
    # max error relative to max|x| (chip_smoke.py phase 3): the kernel and
    # cuBLAS sum in another order
    tol = 1e-5 if dtype == torch.float32 else 1e-11
    err = (xk - xt).abs().max().item()
    assert err <= tol * max(1.0, xt.abs().max().item()), err
