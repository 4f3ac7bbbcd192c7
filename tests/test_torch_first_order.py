"""The first-order solvers of tinyopt_tpu_torch (GD fixed and
Barzilai–Borwein, SGD-momentum and Nesterov, Adam, AdamW, L-BFGS) against
the JAX package: batched against ``vmap(build_solver)`` on the quadratic,
Rosenbrock, the perceptron and the 1-16-1 tanh MLP of
``examples/nn_training.py``, in cost and residual mode, plus the checks of
``tests/test_first_order.py``.  float64, ``tests/test_fused.py:51``'s
tolerances (rtol 1e-5, iterations within 1) and equal stop reasons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.manifolds import SO3 as JSO3
from tinyopt_tpu.models import nn as jnn
from tinyopt_tpu.models.problems import rosenbrock_residuals as j_rosen_res

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import options_from_reference, so3_from_numpy
from tinyopt_tpu_torch.models import nn as tnn
from tinyopt_tpu_torch.models.problems import \
    rosenbrock_residuals as t_rosen_res

torch.set_num_threads(1)


def j_quad(x):
    return jnp.sum((x - 1.0) ** 2)


def t_quad(x):
    return torch.sum((x - 1.0) ** 2)


def j_rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def t_rosen(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _perceptron():
    rng = np.random.default_rng(1)
    W = rng.uniform(-1, 1, (2, 3))
    b = rng.uniform(-0.5, 0.5, 2)
    x = rng.uniform(-1, 1, (16, 3))
    y = 1.0 / (1.0 + np.exp(-(x @ W.T + b)))
    jd = jnn.PerceptronData(jnp.asarray(x), jnp.asarray(y))
    td = tnn.PerceptronData(torch.from_numpy(x), torch.from_numpy(y))
    return ((lambda p: jnn.mse_cost(p, jd)), (lambda p: tnn.mse_cost(p, td)))


HIDDEN = 16
_MLP_X = np.linspace(-2, 2, 16)
_MLP_Y = np.sin(2.0 * _MLP_X) + 0.05 * np.random.default_rng(1).normal(
    size=16)


def j_mlp(p):
    x = jnp.asarray(_MLP_X)
    h = jnp.tanh(p["w1"] @ x[None, :] + p["b1"][:, None])
    return jnp.mean(((p["w2"] @ h + p["b2"][:, None])[0]
                     - jnp.asarray(_MLP_Y)) ** 2)


def t_mlp(p):
    x = torch.from_numpy(_MLP_X)
    h = torch.tanh(p["w1"] @ x[None, :] + p["b1"][:, None])
    return torch.mean(((p["w2"] @ h + p["b2"][:, None])[0]
                       - torch.from_numpy(_MLP_Y)) ** 2)


def _starts(problem, B, seed):
    """(one instance's example, the batch of starts) as numpy pytrees;
    dict keys in sorted order (the JAX package's flattening order)."""
    rng = np.random.default_rng(seed)
    if problem == "quadratic":
        return rng.uniform(-3, 3, (B, 3))
    if problem == "rosenbrock":
        return np.array([-1.2, 1.0]) + 0.1 * rng.normal(size=(B, 2))
    if problem == "perceptron":
        return {"W": 0.5 * rng.normal(size=(B, 2, 3)),
                "b": 0.1 * rng.normal(size=(B, 2))}
    s = lambda *sh: rng.normal(0, 0.5, (B,) + sh)     # noqa: E731
    return {"b1": s(HIDDEN), "b2": s(1), "w1": s(HIDDEN, 1),
            "w2": s(1, HIDDEN)}


def _fns(problem):
    if problem == "perceptron":
        return _perceptron()
    return {"quadratic": (j_quad, t_quad), "rosenbrock": (j_rosen, t_rosen),
            "mlp": (j_mlp, t_mlp)}[problem]


SOLVERS = {
    "gd": dict(solver_type=jto.GradientDescent, gd=jto.GDOptions(lr=2e-3)),
    "gd_bb": dict(solver_type=jto.GradientDescent,
                  gd=jto.GDOptions(lr=1e-3, adaptive="bb")),
    "sgd": dict(solver_type=jto.SGD,
                sgd=jto.SGDOptions(lr=2e-3, momentum=0.9)),
    "nesterov": dict(solver_type=jto.SGD,
                     sgd=jto.SGDOptions(lr=2e-3, momentum=0.9,
                                        nesterov=True)),
    "adam": dict(solver_type=jto.Adam, adam=jto.AdamOptions(lr=0.05)),
    "adamw": dict(solver_type=jto.AdamW,
                  adam=jto.AdamOptions(lr=0.05, weight_decay=1e-2)),
    "lbfgs": dict(solver_type=jto.LBFGS, lbfgs=jto.LBFGSOptions(memory=4)),
}


def assert_fo_parity(ref, got, rtol=1e-5, atol=1e-8, iter_slack=1):
    (xr, outr), (xg, outg) = ref, got
    jl, tl = jax.tree_util.tree_leaves(xr), [
        v for _, v in sorted(xg.items())] if isinstance(xg, dict) else [xg]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(outg.stop_reason.numpy(),
                                  np.asarray(outr.stop_reason))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= iter_slack


def _to_torch(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(x[k]) for k in sorted(x)}
    return torch.from_numpy(x)


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock", "perceptron",
                                     "mlp"])
def test_batched_first_order_matches_vmap(problem, solver):
    """Each instance of a batch solve against ``vmap(build_solver)``:
    per-instance state (momentum, moments, BB rate, the L-BFGS ring
    buffer and its heads) gated per instance on rebuilds."""
    jf, tf = _fns(problem)
    starts = _starts(problem, 4, seed=7)
    opts = jto.Options(max_iters=40, max_consec_failures=10, min_error=0.0,
                       **SOLVERS[solver])
    x_ex = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), starts)
    solve = jax.jit(jax.vmap(jto.build_solver(jf, opts, "cost", x_ex)))
    ref = solve(jax.tree_util.tree_map(jnp.asarray, starts))
    tx = _to_torch(starts)
    got = to.batched_optimize(tx, tf, options_from_reference(opts),
                              mode="cost")
    assert_fo_parity(ref, got)
    np.testing.assert_array_equal(got[1].num_hist.numpy(),
                                  np.asarray(ref[1].num_hist))
    np.testing.assert_array_equal(got[1].successes.numpy(),
                                  np.asarray(ref[1].successes))
    np.testing.assert_allclose(got[1].final_grad.numpy(),
                               np.asarray(ref[1].final_grad), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("solver", ["gd_bb", "adam", "lbfgs"])
def test_residual_mode_matches_reference(solver):
    """A residual vector in residual mode is minimized as ‖r‖² through the
    scalar-cost system (optimize.py:121-127 of the JAX package)."""
    opts = jto.Options(max_iters=60, max_consec_failures=10,
                       **SOLVERS[solver])
    x0 = np.array([-1.2, 1.0])
    ref = jto.optimize(jnp.asarray(x0), j_rosen_res, opts, mode="residuals")
    got = to.optimize(torch.from_numpy(x0), t_rosen_res,
                      options_from_reference(opts), mode="residuals")
    assert_fo_parity(ref, got)
    # L-BFGS on Rosenbrock carries rounding along its trajectory (1.1e-6
    # relative after 60 iterations): the suite's rtol 1e-5
    np.testing.assert_allclose(got[1].errs_list, ref[1].errs_list,
                               rtol=1e-5, atol=1e-12)


def test_vector_residual_rejected():
    """First-order solvers demand a scalar cost (optimize.h:59-72)."""
    with pytest.raises(ValueError, match="scalar"):
        jto.sgd.optimize(jnp.ones(3), lambda x: x - 1.0)
    with pytest.raises(ValueError, match="scalar"):
        to.sgd.optimize(torch.ones(3, dtype=torch.float64),
                        lambda x: x - 1.0)
    with pytest.raises(ValueError, match="ambiguous"):
        to.gd.optimize(torch.ones(1, dtype=torch.float64),
                       lambda x: x * x)


def test_unknown_adaptive_rejected():
    with pytest.raises(ValueError, match="adaptive"):
        to.gd.optimize(torch.ones(2, dtype=torch.float64), t_quad,
                       to.Options(gd=to.GDOptions(adaptive="wolfe")))


def test_adamw_rejects_manifold_decay():
    with pytest.raises(ValueError, match="Euclidean"):
        jto.adamw.optimize(JSO3.identity(jnp.float64),
                           lambda R: jnp.sum(R.log() ** 2))
    from tinyopt_tpu_torch.manifolds import SO3
    with pytest.raises(ValueError, match="Euclidean"):
        to.adamw.optimize(SO3.identity(torch.float64),
                          lambda R: torch.sum(R.log() ** 2))


@pytest.mark.parametrize("solver", ["adam", "lbfgs", "gd_bb"])
def test_manifold_parameters_match_reference(solver):
    """Adam, L-BFGS and BB on an SO3 parameter: their state lives on the
    tangent space (L-BFGS and BB take s = x ⊟ x_prev by the manifold's
    local map)."""
    w = np.array([0.3, -0.1, 0.2])
    jt = JSO3.exp(jnp.asarray(w))
    from tinyopt_tpu_torch.manifolds import SO3
    tt = SO3.exp(torch.from_numpy(w))
    # L-BFGS at lr 0.5: its first step at lr 1 (r = g) lands on the
    # mirror point of equal cost, a tie that rounding decides
    opts = jto.Options(max_iters=60, max_consec_failures=10,
                       **{**SOLVERS[solver], "adam": jto.AdamOptions(lr=0.02),
                          "lbfgs": jto.LBFGSOptions(memory=4, lr=0.5)})
    xr, outr = jto.optimize(JSO3.identity(jnp.float64),
                            lambda R: jnp.sum((jt.inverse() @ R).log() ** 2),
                            opts)
    xg, outg = to.optimize(SO3.identity(torch.float64),
                           lambda R: torch.sum((tt.inverse() @ R).log() ** 2),
                           options_from_reference(opts))
    np.testing.assert_allclose(xg.wxyz.numpy(), np.asarray(xr.wxyz),
                               rtol=1e-5, atol=1e-8)
    assert abs(int(outg.num_iters) - int(outr.num_iters)) <= 1
    assert int(outg.stop_reason) == int(outr.stop_reason)


def test_backoff_without_failure_budget():
    """max_consec_failures=0 and a huge Adam rate: rejections backtrack
    lr, lr/2, … through the λ schedule's bad factor, never applied to x,
    so the best cost stays monotone — step for step as the JAX loop."""
    opts = jto.Options(solver_type=jto.Adam, max_iters=50,
                       max_consec_failures=0, adam=jto.AdamOptions(lr=2.5))
    x0 = np.array([3.0, -2.0])
    ref = jto.optimize(jnp.asarray(x0), j_quad, opts)
    got = to.optimize(torch.from_numpy(x0), t_quad,
                      options_from_reference(opts))
    assert_fo_parity(ref, got)
    assert int(got[1].num_failures) == int(ref[1].num_failures) > 0
    assert got[1].successes_list == ref[1].successes_list
    errs = np.asarray(got[1].errs_list)
    assert float(got[1].final_cost.cost) <= errs.min() + 1e-12


@pytest.mark.parametrize("solver", ["lbfgs", "gd_bb"])
def test_warm_start_matches_reference(solver):
    """warm_start=(g0,) skips the first build; the have_prev guard keeps
    the zeros init out of the L-BFGS pairs and the BB rate."""
    x0 = np.array([3.0, -2.0])
    g0 = np.asarray(jax.grad(j_quad)(jnp.asarray(x0)))
    opts = jto.Options(**SOLVERS[solver])
    warm = jto.build_solver(j_quad, opts, "cost", jnp.asarray(x0),
                            warm_start=(jnp.asarray(g0),))
    ref = warm(jnp.asarray(x0))
    got = to.build_solver(t_quad, options_from_reference(opts), "cost",
                          torch.from_numpy(x0),
                          warm_start=(torch.from_numpy(g0),))(
                              torch.from_numpy(x0))
    assert_fo_parity(ref, got)
    np.testing.assert_allclose(got[1].errs_list, ref[1].errs_list,
                               rtol=1e-9, atol=1e-15)
    assert bool(got[1].converged())


def test_lm_warm_start_matches_reference():
    """warm_start=(g0, H0) for LM: the first iteration evaluates only and
    proposes from the seeded system (optimizer.h:46-55)."""
    x0 = np.array([-1.2, 1.0])
    J = np.asarray(jax.jacfwd(j_rosen_res)(jnp.asarray(x0)))
    r = np.asarray(j_rosen_res(jnp.asarray(x0)))
    g0, H0 = J.T @ r, J.T @ J
    opts = jto.Options(max_iters=30)
    ref = jto.build_solver(j_rosen_res, opts, "residuals", jnp.asarray(x0),
                           warm_start=(jnp.asarray(g0), jnp.asarray(H0)))(
                               jnp.asarray(x0))
    got = to.build_solver(t_rosen_res, options_from_reference(opts),
                          "residuals", torch.from_numpy(x0),
                          warm_start=(torch.from_numpy(g0),
                                      torch.from_numpy(H0)))(
                              torch.from_numpy(x0))
    assert_fo_parity(ref, got)
    np.testing.assert_allclose(got[1].errs_list, ref[1].errs_list,
                               rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("ns", ["sgd", "adam", "lbfgs"])
def test_nan_routing(ns):
    _, out = getattr(to, ns).optimize(
        torch.tensor([1.0], dtype=torch.float64),
        lambda x: torch.sum(x) * float("nan"))
    assert int(out.stop_reason) == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)


def test_returned_x_carries_final_cost():
    """The returned x is the point whose cost is final_cost (the gated
    final apply: no unevaluated trailing L-BFGS proposal)."""
    x, out = to.lbfgs.optimize(torch.tensor([3.0, -2.0],
                                            dtype=torch.float64), t_quad)
    assert bool(out.converged())
    np.testing.assert_allclose(float(t_quad(x)), float(out.final_cost.cost),
                               atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_first_order_on_gpu(solver):
    """Every first-order type on the card against the CPU, float64, a
    batch of quadratics (no kernel of the TPU's on this path; the card's
    sums run in another order, so to rtol 1e-9).  The quadratic's
    curvatures are unequal: on Σ(x − 1)² an L-BFGS first step at lr 1
    lands on the mirror point of equal cost, a tie that rounding decides
    (3 against 6 iterations on one of 64 curves, an H100 run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    starts = _starts("quadratic", 64, seed=3)
    opts = options_from_reference(jto.Options(
        max_iters=40, max_consec_failures=10, **SOLVERS[solver]))

    def cost(x):
        c = torch.tensor([1.3, 0.7, 2.1], dtype=x.dtype, device=x.device)
        return torch.sum(c * (x - 1.0) ** 2)

    tx = torch.from_numpy(starts)
    cpu = to.batched_optimize(tx, cost, opts, mode="cost")
    gpu = to.batched_optimize(tx.cuda(), cost, opts, mode="cost")
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-9, atol=1e-12)
    assert torch.equal(gpu[1].stop_reason.cpu(), cpu[1].stop_reason)
    assert torch.equal(gpu[1].num_iters.cpu(), cpu[1].num_iters)
