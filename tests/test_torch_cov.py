"""Covariance recovery of tinyopt_tpu_torch against the JAX package
(tests/test_cov.py; reference tests/cov.cpp:20-170): ``Output.covariance``
on the automatic-differentiation and manual-accumulation paths, every
whitening, the overdetermined rescale, ``max_std_dev``, and
``covariance_at`` — one instance and batched.  float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.losses import mahalanobis as jmaha
from tinyopt_tpu.ops.linalg import max_std_dev as j_max_std_dev
from tinyopt_tpu.parallel import batched_optimize as j_batched_optimize

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import prior_problem_from_numpy
from tinyopt_tpu_torch.losses import mahalanobis as tmaha
from tinyopt_tpu_torch.models.problems import prior_residual
from tinyopt_tpu_torch.ops.linalg import max_std_dev

torch.set_num_threads(1)

Y = np.array([1.0, -2.0, 0.5])
STDEVS = np.array([0.5, 1.5, 2.0])
COV = np.array([[2.0, 0.3, 0.1],
                [0.3, 1.5, 0.2],
                [0.1, 0.2, 1.0]])
L_INFO = np.linalg.cholesky(np.linalg.inv(COV))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float64))


def _j_acc(x):
    r = (x - _j(Y)) / _j(STDEVS)
    J = jnp.diag(1.0 / _j(STDEVS))
    return (jnp.vdot(r, r), 3), J.T @ r, J.T @ J


def _t_acc(x):
    r = (x - _t(Y)) / _t(STDEVS)
    J = torch.diag(1.0 / _t(STDEVS))
    return (torch.sum(r * r), 3), J.T @ r, J.T @ J


def _j_maha_acc(x):
    r, J = jmaha.maha_whitened_with_jac(x - _j(Y), _j(COV))
    return (jnp.vdot(r, r), 3), J.T @ r, J.T @ J


def _t_maha_acc(x):
    r, J = tmaha.maha_whitened_with_jac(x - _t(Y), _t(COV))
    return (torch.sum(r * r), 3), J.T @ r, J.T @ J


CASES = {
    # name: (jax fn, torch fn, mode, expected covariance)
    "stdev_ad": (lambda x: (x - _j(Y)) / _j(STDEVS),
                 lambda x: (x - _t(Y)) / _t(STDEVS), "auto",
                 np.diag(STDEVS ** 2)),
    "stdev_acc": (_j_acc, _t_acc, "acc", np.diag(STDEVS ** 2)),
    "full_cov_ad": (lambda x: jmaha.maha_whitened(x - _j(Y), _j(COV)),
                    lambda x: tmaha.maha_whitened(x - _t(Y), _t(COV)),
                    "auto", COV),
    "full_cov_acc": (_j_maha_acc, _t_maha_acc, "acc", COV),
    "info_u_ad": (lambda x: jmaha.maha_whitened_info_u(x - _j(Y),
                                                       _j(L_INFO.T)),
                  lambda x: tmaha.maha_whitened_info_u(x - _t(Y),
                                                       _t(L_INFO.T)),
                  "auto", COV),
}


@pytest.mark.parametrize("case", list(CASES))
def test_covariance_matches_reference(case):
    """The posterior of a whitened Gaussian prior is its covariance, in
    every formulation, as the JAX package's."""
    jf, tf, mode, expected = CASES[case]
    _, outr = jto.optimize(jnp.zeros(3), jf, mode=mode)
    x, out = to.optimize(torch.zeros(3, dtype=torch.float64), tf, mode=mode)
    assert bool(out.converged()) and out.final_hessian is not None
    C = out.covariance()
    np.testing.assert_allclose(C.numpy(), np.asarray(outr.covariance()),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(C.numpy(), expected, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), Y, atol=1e-6)
    assert out.Covariance(rescaled=True).shape == (3, 3)


def test_overdetermined_rescale():
    """n = 6 residuals > d = 3: ×cost²/(n − 3) (output.h:80-93); the
    plain posterior of two stacked priors is Σ/2."""
    Y2 = Y + np.array([0.2, -0.1, 0.3])

    def jf(x):
        return jnp.concatenate([(x - _j(Y)) / _j(STDEVS),
                                (x - _j(Y2)) / _j(STDEVS)])

    def tf(x):
        return torch.cat([(x - _t(Y)) / _t(STDEVS),
                          (x - _t(Y2)) / _t(STDEVS)])

    _, outr = jto.optimize(jnp.zeros(3), jf)
    _, out = to.optimize(torch.zeros(3, dtype=torch.float64), tf)
    C, Cr = out.covariance(), out.covariance(rescaled=True)
    c, n = float(out.final_cost.cost), int(out.final_cost.num_residuals)
    assert n == 6 and c > 0
    np.testing.assert_allclose(Cr.numpy(), C.numpy() * (c * c / (n - 3)),
                               rtol=1e-12)
    np.testing.assert_allclose(Cr.numpy(),
                               np.asarray(outr.covariance(rescaled=True)),
                               rtol=1e-9)
    np.testing.assert_allclose(np.sqrt(np.diag(C.numpy())),
                               STDEVS / np.sqrt(2.0), atol=1e-7)


def test_determined_system_rescale_is_noop():
    _, out = to.optimize(torch.zeros(3, dtype=torch.float64),
                         lambda x: (x - _t(Y)) / _t(STDEVS))
    assert torch.equal(out.covariance(), out.covariance(rescaled=True))


def test_max_std_dev_matches_reference():
    _, out = to.optimize(torch.zeros(3, dtype=torch.float64),
                         lambda x: (x - _t(Y)) / _t(STDEVS))
    _, outr = jto.optimize(jnp.zeros(3), lambda x: (x - _j(Y)) / _j(STDEVS))
    assert float(max_std_dev(out.final_hessian)) == pytest.approx(
        float(j_max_std_dev(outr.final_hessian)), rel=1e-12)
    assert float(max_std_dev(out.final_hessian)) == pytest.approx(
        STDEVS.max(), rel=1e-6)


def test_no_saved_hessian_and_block_hessian():
    o = to.Options(hessian=to.HessianOptions(save_last=False))
    _, out = to.optimize(torch.zeros(3, dtype=torch.float64),
                         lambda x: (x - _t(Y)) / _t(STDEVS), o)
    assert out.covariance() is None
    # a BlockDiag H: its covariance is blockwise, densified as the JAX
    # package's (output.py:83-96); the rescale takes d = n
    # (two instances of one 3 × 3 block)
    out.final_hessian = to.BlockDiag(
        _t(np.diag(1.0 / STDEVS ** 2)).expand(2, 1, 3, 3))
    out.final_cost.num_residuals = torch.tensor(9, dtype=torch.int32)
    jH = jto.BlockDiag(jnp.asarray(np.diag(1.0 / STDEVS ** 2))[None])
    jout = jto.Output(final_cost=jto.Cost.make(out.final_cost.cost, 9),
                      final_rerr_dec=0.0, stop_reason=0, num_iters=0,
                      num_failures=0, num_consec_failures=0,
                      duration_ms=0.0, final_grad=None, final_hessian=jH,
                      errs=None, deltas2=None, successes=None, num_hist=0)
    for rescaled in (False, True):
        C = out.covariance(rescaled=rescaled)
        assert C.shape == (2, 3, 3)
        np.testing.assert_allclose(
            C[1].numpy(), np.asarray(jout.covariance(rescaled=rescaled)),
            rtol=1e-12)


def test_covariance_at_matches_saved_hessian_covariance():
    y = np.array([0.3, -0.7, 1.1])
    s = np.array([2.0, 1.0, 0.5])
    tf = lambda x: (x - _t(y)) * _t(s)                       # noqa: E731
    jf = lambda x: (x - _j(y)) * _j(s)                       # noqa: E731
    x, out = to.optimize(torch.zeros(3, dtype=torch.float64), tf)
    post = to.covariance_at(tf, x)
    np.testing.assert_allclose(post.numpy(), out.covariance().numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(
        post.numpy(), np.asarray(jto.covariance_at(jf, _j(x.numpy()))),
        rtol=1e-12)
    # rescaled, overdetermined by repeats
    tf2 = lambda x: torch.cat([tf(x), tf(x) * 0.5 + 0.01])   # noqa: E731
    jf2 = lambda x: jnp.concatenate([jf(x), jf(x) * 0.5 + 0.01])  # noqa
    x2, out2 = to.optimize(torch.zeros(3, dtype=torch.float64), tf2)
    np.testing.assert_allclose(
        to.covariance_at(tf2, x2, rescaled=True).numpy(),
        out2.covariance(rescaled=True).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        to.covariance_at(tf2, x2, rescaled=True).numpy(),
        np.asarray(jto.covariance_at(jf2, _j(x2.numpy()), rescaled=True)),
        rtol=1e-10)


def test_batched_covariance_matches_vmap():
    """Batched: ``Output.covariance`` of a batch (B, d, d) and
    ``covariance_at(..., data_batch=)`` against the JAX package's vmap of
    ``covariance_at``; a whitened prior's covariance is diag(σ²)."""
    from tinyopt_tpu.models.problems import make_prior_batch as j_make
    data, x0 = j_make(6, 4, jnp.float64, seed=2)
    xr, _ = j_batched_optimize(x0, jto.models.problems.prior_residual,
                               jto.Options(hessian=jto.HessianOptions(
                                   save_last=False)), data_batch=data)
    covr = jax.vmap(lambda xi, yi, si: jto.covariance_at(
        lambda xv: (xv - yi) * si, xi))(xr, data.y, data.inv_std)
    td = prior_problem_from_numpy(np.asarray(data.y),
                                  np.asarray(data.inv_std), device="cpu",
                                  dtype=torch.float64)
    tx0 = torch.from_numpy(np.asarray(x0))
    x, out = to.batched_optimize(tx0, prior_residual, to.Options(),
                                 data_batch=td)
    C = out.covariance()
    post = to.covariance_at(prior_residual, x, data_batch=td)
    assert C.shape == post.shape == (6, 4, 4)
    np.testing.assert_allclose(post.numpy(), np.asarray(covr), rtol=1e-9,
                               atol=1e-14)
    np.testing.assert_allclose(C.numpy(), np.asarray(covr), rtol=1e-9,
                               atol=1e-14)
    expected = torch.diag_embed(1.0 / td.inv_std ** 2)
    np.testing.assert_allclose(post.numpy(), expected.numpy(), rtol=1e-9,
                               atol=1e-14)
    # rescaled: d residuals, d dims, so the factor is 1
    assert torch.equal(out.covariance(rescaled=True), C)


def test_covariance_at_first_order_rejected():
    with pytest.raises(ValueError, match="first-order"):
        jto.covariance_at(lambda x: x, jnp.zeros(2),
                          jto.Options(solver_type=jto.GradientDescent))
    with pytest.raises(ValueError, match="first-order"):
        to.covariance_at(lambda x: x, torch.zeros(2, dtype=torch.float64),
                         to.Options(solver_type=to.GradientDescent))


@pytest.mark.cuda
def test_covariance_on_gpu():
    """Output.covariance and covariance_at on the card equal the CPU's to
    rounding (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tinyopt_tpu_torch.models.problems import make_prior_batch
    data, x0 = make_prior_batch(256, 6, torch.float64, seed=5,
                                device="cpu")
    cpu = to.batched_optimize(x0, prior_residual, to.Options(),
                              data_batch=data)
    gd = type(data)(*(a.cuda() for a in data))
    gpu = to.batched_optimize(x0.cuda(), prior_residual, to.Options(),
                              data_batch=gd)
    torch.testing.assert_close(gpu[1].covariance().cpu(),
                               cpu[1].covariance(), rtol=1e-10, atol=1e-14)
    torch.testing.assert_close(
        to.covariance_at(prior_residual, gpu[0], data_batch=gd).cpu(),
        to.covariance_at(prior_residual, cpu[0], data_batch=data),
        rtol=1e-10, atol=1e-14)
