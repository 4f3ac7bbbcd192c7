"""Implicit differentiation of solves (tinyopt_tpu_torch.implicit)
against the JAX package (tests/test_implicit.py): the analytic linear
case, a weighted fit against central finite differences and the JAX
gradient, batched solves, ``torch.autograd.gradcheck`` in float64, the
rank-deficient fallback, manifold parameters rejected, and the bilevel
robust-threshold gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.losses import robust_norms as jrn

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.losses import robust_norms as trn

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), requires_grad=grad)


def test_linear_least_squares_analytic():
    """x*(θ) = θ for r = x − θ: d(Σx*²)/dθ = 2θ."""
    solve = to.implicit_solver(lambda x, th: x - th,
                               x_example=torch.zeros(3, dtype=torch.float64))
    theta = _t([1.0, -2.0, 0.5], grad=True)
    torch.sum(solve(theta, torch.zeros(3, dtype=torch.float64)) ** 2
              ).backward()
    np.testing.assert_allclose(theta.grad.numpy(), 2.0 * theta.detach(),
                               atol=1e-6)


def _weighted_fit():
    rng = np.random.default_rng(0)
    A, b = rng.normal(size=(12, 3)), rng.normal(size=12)
    target, logw0 = rng.normal(size=3), rng.normal(size=12) * 0.3
    return A, b, target, logw0


def test_weighted_fit_matches_finite_differences_and_reference():
    A, b, target, logw0 = _weighted_fit()
    tA, tb, tt = _t(A), _t(b), _t(target)
    solve = to.implicit_solver(lambda x, lw: torch.exp(lw) * (tA @ x - tb),
                               x_example=torch.zeros(3, dtype=torch.float64))

    def outer(lw):
        return torch.sum((solve(lw, torch.zeros(3, dtype=torch.float64))
                          - tt) ** 2)

    lw = _t(logw0, grad=True)
    outer(lw).backward()
    g = lw.grad.numpy()
    eps = 1e-5
    g_num = np.array([
        (float(outer(_t(logw0 + eps * e))) - float(outer(_t(logw0 - eps * e))))
        / (2 * eps) for e in np.eye(12)])
    np.testing.assert_allclose(g, g_num, rtol=1e-5, atol=1e-7)
    jA, jb, jt = jnp.asarray(A), jnp.asarray(b), jnp.asarray(target)
    jsolve = jto.implicit_solver(lambda x, w: jnp.exp(w) * (jA @ x - jb),
                                 x_example=jnp.zeros(3))
    g_ref = jax.grad(lambda w: jnp.sum((jsolve(w, jnp.zeros(3)) - jt) ** 2))(
        jnp.asarray(logw0))
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-8, atol=1e-12)


def test_gradcheck_float64():
    A, b, _, logw0 = _weighted_fit()
    tA, tb = _t(A[:6]), _t(b[:6])
    solve = to.implicit_solver(lambda x, lw: torch.exp(lw) * (tA @ x - tb),
                               x_example=torch.zeros(3, dtype=torch.float64))
    assert torch.autograd.gradcheck(
        lambda lw: solve(lw, torch.zeros(3, dtype=torch.float64)),
        (_t(logw0[:6], grad=True),), eps=1e-6, atol=1e-6)


def test_batched_matches_vmap():
    """batched=True: θ and x0 with a leading instance axis, one solve for
    the batch, the JAX package's vmapped solve and gradient."""
    thetas = np.array([[2.0], [3.0], [4.0]])
    solve = to.implicit_solver(lambda x, th: x * x - th,
                               x_example=torch.ones(1, dtype=torch.float64),
                               batched=True)
    th = _t(thetas, grad=True)
    x = solve(th, torch.ones(3, 1, dtype=torch.float64))
    np.testing.assert_allclose(x.detach().numpy()[:, 0], np.sqrt([2, 3, 4]),
                               atol=1e-6)
    x.sum().backward()
    jsolve = jto.implicit_solver(lambda x, th: x * x - th,
                                 x_example=jnp.ones(1))
    g_ref = jax.grad(lambda t: jnp.sum(jax.vmap(
        lambda ti: jsolve(ti, jnp.ones(1)))(t)))(jnp.asarray(thetas))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(g_ref), rtol=1e-8)
    np.testing.assert_allclose(th.grad.numpy()[:, 0],
                               0.5 / np.sqrt([2, 3, 4]), rtol=1e-6)


def test_batch_solver_built_once_per_theta_layout(monkeypatch):
    """The forward builds its batched solver at the first call with a
    given θ structure, leaf shape and type, and reuses it after; a θ of
    another shape gets its own, with its own residual count."""
    import tinyopt_tpu_torch.implicit as timp
    builds = []
    real = timp.build_batch_solver

    def counting(*args, **kwargs):
        builds.append(args[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(timp, "build_batch_solver", counting)
    solve = to.implicit_solver(lambda x, th: x - th[:1] - th[1:].sum(),
                               x_example=torch.zeros(1, dtype=torch.float64),
                               batched=True)
    x0 = torch.zeros(2, 1, dtype=torch.float64)
    for scale in (1.0, 2.0, 3.0):
        th = _t([[scale, 0.5], [-scale, 0.25]], grad=True)
        x = solve(th, x0)
        x.sum().backward()
        np.testing.assert_allclose(x.detach().numpy()[:, 0],
                                   [scale + 0.5, 0.25 - scale], atol=1e-8)
        np.testing.assert_allclose(th.grad.numpy(), np.ones((2, 2)))
    assert len(builds) == 1
    solve(_t([[1.0, 2.0, 3.0]]), x0[:1])
    assert len(builds) == 2 and builds[-1].shape == (3,)


def test_x0_gets_zero_gradient_and_rank_deficient_fallback():
    """x0 receives zeros; a gauge-free problem (r depends on x₀ + x₁ only)
    has a singular JᵀJ and takes the minimum-norm λ, as the JAX
    function's lstsq."""
    def tf(x, th):
        return (x[0] + x[1] - th).reshape(1)

    solve = to.implicit_solver(tf, x_example=torch.zeros(2,
                                                         dtype=torch.float64))
    th = _t([1.5], grad=True)
    x0 = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    x = solve(th, x0)
    x.sum().backward()
    assert torch.equal(x0.grad, torch.zeros(2, dtype=torch.float64))
    jsolve = jto.implicit_solver(lambda x, t: (x[0] + x[1] - t).reshape(1),
                                 x_example=jnp.zeros(2))
    g_ref = jax.grad(lambda t: jnp.sum(jsolve(t, jnp.zeros(2))))(
        jnp.asarray([1.5]))
    assert np.all(np.isfinite(th.grad.numpy()))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-8)


def test_manifold_params_rejected():
    from tinyopt_tpu_torch.manifolds import SO3
    with pytest.raises(NotImplementedError):
        to.implicit_solver(lambda x, th: x.log(),
                           x_example=SO3.identity(torch.float64))


def test_bilevel_robust_threshold_matches_reference():
    """The gradient of an outer loss in a Cauchy threshold through the
    robust inner fit (the bilevel use case), as the JAX package's."""
    rng = np.random.default_rng(2)
    clean = rng.normal(size=8)
    obs = clean.copy()
    obs[0] += 25.0
    tobs, jobs = _t(obs), jnp.asarray(obs)

    def tres(x, log_th2):
        r = tobs - x[0]
        return torch.func.vmap(lambda ri: trn.robust_whiten(
            ri[None], trn.cauchy, torch.exp(log_th2[0]))[0])(r)

    def jres(x, log_th2):
        r = jobs - x[0]
        return jax.vmap(lambda ri: jrn.robust_whiten(
            ri[None], jrn.cauchy, jnp.exp(log_th2[0]))[0])(r)

    opts = jto.Options(max_iters=30)
    from tinyopt_tpu_torch.interop import options_from_reference
    solve = to.implicit_solver(tres, options_from_reference(opts),
                               x_example=torch.zeros(1, dtype=torch.float64))
    lt = _t([3.0], grad=True)
    ((solve(lt, torch.zeros(1, dtype=torch.float64))[0]
      - float(np.mean(clean))) ** 2).backward()
    jsolve = jto.implicit_solver(jres, options=opts, x_example=jnp.zeros(1))
    g_ref = jax.grad(lambda t: (jsolve(t, jnp.zeros(1))[0]
                                - jnp.mean(jnp.asarray(clean))) ** 2)(
                                    jnp.asarray([3.0]))
    assert np.isfinite(lt.grad.numpy()[0]) and abs(lt.grad.numpy()[0]) > 0
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_ref), rtol=1e-6)


@pytest.mark.cuda
def test_implicit_on_gpu():
    """A batch of weighted fits through "cg" (K1 in the forward solve) on
    the card: the gradient equals the CPU's to 1e-8 (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    from tinyopt_tpu_torch.ops import cuda_cg
    g = torch.Generator().manual_seed(0)
    A = torch.randn(64, 12, 3, generator=g, dtype=torch.float64)
    b = torch.randn(64, 12, generator=g, dtype=torch.float64)
    lw0 = 0.3 * torch.randn(64, 12, generator=g, dtype=torch.float64)
    opts = to.Options(hessian=to.HessianOptions(solver="cg"))

    def grad(device):
        solve = to.implicit_solver(
            lambda x, th: torch.exp(th[2]) * (th[0] @ x - th[1]), opts,
            x_example=torch.zeros(3, dtype=torch.float64, device=device),
            batched=True)
        lw = lw0.to(device).requires_grad_(True)
        x = solve((A.to(device), b.to(device), lw),
                  torch.zeros(64, 3, dtype=torch.float64, device=device))
        torch.sum(x ** 2).backward()
        return lw.grad.cpu()

    cuda_cg.cg_solve.launches = 0
    g_gpu = grad("cuda")
    assert cuda_cg.cg_solve.launches > 0
    torch.testing.assert_close(g_gpu, grad("cpu"), rtol=1e-8, atol=1e-12)
