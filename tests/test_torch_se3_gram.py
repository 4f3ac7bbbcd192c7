"""The algebra K2's SE3 kernel rests on: for r_k = R p_k + t − q̂_k, JᵀJ of
δ ↦ r(T ⊞ δ) at δ = 0 depends on the points alone,

    H = [[K·I, −[c]×], [[c]×, tr(M)·I − M]],  c = Σ p_k,  M = Σ p_k p_kᵀ,

when RᵀR = I (csrc/solver_se3.cuh builds it once an instance).
``ops/cuda_solver.se3_gram_plain`` is held in float64 to the JᵀJ of the
port's ``torch.func`` Jacobian and of the JAX package's ``jax.jacfwd``,
both through the SE3 retraction; and, for a stored quaternion a few ulps
off unit norm, the size of the RᵀR term the closed form leaves out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyopt_tpu.diff.auto import residual_jacobian as j_residual_jacobian
from tinyopt_tpu.manifolds import SE3 as JSE3
from tinyopt_tpu.models.se3_refinement import SE3RefinementData as JData
from tinyopt_tpu.models.se3_refinement import se3_residual as j_se3_residual

from tinyopt_tpu_torch.diff.auto import residual_jacobian
from tinyopt_tpu_torch.interop import (se3_from_numpy,
                                       se3_refinement_data_from_numpy)
from tinyopt_tpu_torch.models.se3_refinement import se3_residual
from tinyopt_tpu_torch.ops.cuda_solver import se3_gram_plain

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12


def _instance(K, seed):
    """One pose and K points and targets from a numpy seed: the JAX pose
    and data, and the same values on the port."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.5, 0.5, size=6)
    points = rng.uniform(-1.0, 1.0, size=(K, 3))
    targets = points + rng.normal(scale=0.1, size=(K, 3))
    jT = JSE3.exp(jnp.asarray(w))
    tT = se3_from_numpy(np.asarray(jT.rotation.wxyz),
                        np.asarray(jT.translation), device="cpu", dtype=F64)
    tdata = se3_refinement_data_from_numpy(points, targets, device="cpu",
                                           dtype=F64)
    return (jT, JData(jnp.asarray(points), jnp.asarray(targets))), (tT, tdata)


def _port_gram(tT, tdata):
    _, J = residual_jacobian(lambda T: se3_residual(T, tdata), tT)
    return J.T @ J


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("K", [1, 3, 16, 24])
def test_closed_form_gram_matches_jacobians(K):
    """H from the points alone equals JᵀJ through the retraction, the
    port's torch.func Jacobian and the JAX package's jacfwd, to 1e-12
    relative in float64."""
    (jT, jdata), (tT, tdata) = _instance(K, 100 + K)
    H = se3_gram_plain(tdata.points)
    assert H.shape == (6, 6) and H.dtype == F64
    torch.testing.assert_close(H, H.T, rtol=0, atol=0)
    assert _rel(H, _port_gram(tT, tdata)) < RTOL
    _, Jj = j_residual_jacobian(lambda T: j_se3_residual(T, jdata), jT)
    Jj = np.asarray(Jj)
    assert Jj.shape == (3 * K, 6)
    assert _rel(H, Jj.T @ Jj) < RTOL
    # the quaternion form at a unit quaternion is the same matrix
    q = tT.rotation.wxyz
    assert _rel(se3_gram_plain(tdata.points, q), H) < RTOL
    # diag(H), which the kernel reads off its ten numbers: K, K, K, then
    # M's pair sums
    M = tdata.points.T @ tdata.points
    want = torch.stack([torch.tensor(float(K), dtype=F64)] * 3
                       + [M[1, 1] + M[2, 2], M[0, 0] + M[2, 2],
                          M[0, 0] + M[1, 1]])
    torch.testing.assert_close(torch.diagonal(H), want, rtol=1e-15,
                               atol=0)


def test_closed_form_gram_batched():
    """The plain function is batch-native: (B, K, 3) points give (B, 6, 6),
    each the one-instance matrix."""
    pts = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (4, 16, 3)))
    H = se3_gram_plain(pts)
    assert H.shape == (4, 6, 6)
    for b in range(4):
        torch.testing.assert_close(H[b], se3_gram_plain(pts[b]), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("ulps", [4, 64])
def test_gram_off_unit_quaternion(ulps):
    """A stored quaternion a few ulps off unit norm (SO3.apply does not
    normalize; each retraction moves the norm by rounding): JᵀJ through
    the retraction then carries RᵀR ≠ I.  The quaternion form holds it to
    1e-12; the closed form the kernel builds parts from it by the RᵀR
    term, about 2·| |q|² − 1 | relative — the size the choice of a
    once-an-instance H rests on (PERF.md)."""
    K = 16
    _, (tT, tdata) = _instance(K, 7)
    scale = 1.0 + ulps * np.finfo(np.float64).eps
    q = tT.rotation.wxyz * scale
    tq = se3_from_numpy(q.numpy(), tT.translation.numpy(), device="cpu",
                        dtype=F64)
    JtJ = _port_gram(tq, tdata)
    assert _rel(se3_gram_plain(tdata.points, q), JtJ) < RTOL
    drift = abs(float(torch.sum(q * q)) - 1.0)
    gap = _rel(se3_gram_plain(tdata.points), JtJ)
    # the RᵀR term: 1-2 x the norm drift (2.4e-15 at 4 ulps, 4.0e-14 at
    # 64)
    assert 0.5 * drift < gap < 8 * drift + 1e-15
    print(f"|q|^2 - 1 = {drift:.3e}: closed form vs J'J {gap:.3e} relative")
