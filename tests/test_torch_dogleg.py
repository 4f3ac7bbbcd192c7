"""DogLeg in tinyopt_tpu_torch against the JAX package: the batched step
(``solvers/step.dogleg_core`` / ``propose_step``) against ``_dogleg_step``
per instance, the hard suite through ``dogleg.optimize``, and batched
DogLeg solves through ``batched_optimize``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.models import problems as jp
from tinyopt_tpu.models.problems import PriorProblem as JPrior
from tinyopt_tpu.parallel.batched import batched_solver as j_batched_solver
from tinyopt_tpu.solvers.step import _dogleg_step as j_dogleg_step

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       prior_problem_from_numpy)
from tinyopt_tpu_torch.models import problems as tp
from tinyopt_tpu_torch.solvers.step import propose_step

torch.set_num_threads(1)

LAMS = (1e-6, 2.0, 8.0, 64.0, 1e4, 1e6)
HARD = jto.Options(max_iters=500, max_consec_failures=0)


def _step_instances(seed=0):
    """(H, g) per instance: tests/test_dogleg.py's SPD 2×2, rank-1 H and
    zero g, then random SPD 7×7."""
    spd = np.array([[4.0, 1.0], [1.0, 3.0]])
    small = [(spd, np.array([1.0, -2.0])),
             (np.full((2, 2), 1e4), np.array([-2.5e-4, -2.5e-4])),
             (spd, np.zeros(2))]
    rng = np.random.default_rng(seed)
    large = []
    for _ in range(2):
        A = rng.normal(size=(7, 7))
        large.append((A @ A.T + 0.1 * np.eye(7), rng.normal(size=7)))
    return small, large


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_dogleg_step_matches_reference(solver):
    """Every λ, every instance, in one batch per width: the Gauss-Newton
    point, the dogleg blend, the clipped gradient, the Levenberg fallback
    of the rank-1 H and the zero step of a zero gradient."""
    jo = jto.Options(solver_type=jto.DogLeg,
                     hessian=jto.HessianOptions(solver=solver))
    step = jax.jit(lambda H, g, lam: j_dogleg_step(H, g, lam, jo))
    for group in _step_instances():
        Hs = np.stack([H for H, _ in group for _ in LAMS])
        gs = np.stack([g for _, g in group for _ in LAMS])
        lams = np.array([lam for _ in group for lam in LAMS])
        dx, ok = propose_step(torch.from_numpy(Hs), torch.from_numpy(gs),
                              torch.from_numpy(lams),
                              options_from_reference(jo))
        for i in range(len(lams)):
            dxr, okr = step(jnp.asarray(Hs[i]), jnp.asarray(gs[i]),
                            jnp.asarray(lams[i]))
            assert bool(ok[i]) == bool(okr)
            np.testing.assert_allclose(dx[i].numpy(), np.asarray(dxr),
                                       rtol=1e-9, atol=1e-15,
                                       err_msg=f"instance {i}, λ {lams[i]}")
        zero_g = torch.all(torch.from_numpy(gs) == 0, dim=-1)
        assert bool(torch.all(dx[zero_g] == 0)) and bool(torch.all(ok))


@pytest.mark.parametrize("name,x0", [
    ("wood", [-3.0, -1.0, -3.0, -1.0]),
    ("freudenstein_roth", [0.5, -2.0]),
    ("freudenstein_roth", [6.0, 3.5]),
    ("rosenbrock", [-1.2, 1.0]),
    ("beale", [1.0, 1.0]),
    ("himmelblau", [2.0, 1.5]),
], ids=["wood", "freudenstein_roth_hard", "freudenstein_roth_good",
        "rosenbrock", "beale", "himmelblau"])
def test_hard_suite_matches_reference(name, x0):
    """tests/test_dogleg.py's hard suite, float64, through
    ``dogleg.optimize`` of both packages."""
    fn = name + "_residuals"
    xr, outr = jto.dogleg.optimize(jnp.asarray(x0), getattr(jp, fn), HARD)
    x, out = to.dogleg.optimize(torch.tensor(x0, dtype=torch.float64),
                                getattr(tp, fn), options_from_reference(HARD))
    assert int(out.stop_reason) == int(outr.stop_reason)
    assert bool(out.converged())
    assert abs(int(out.num_iters) - int(outr.num_iters)) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(float(out.final_cost.cost),
                               float(outr.final_cost.cost), rtol=1e-5,
                               atol=1e-15)


def test_jennrich_sampson_singular_endgame_matches_reference():
    """tests/test_dogleg.py's Jennrich-Sampson singular endgame: the GN
    sanity gate and the Levenberg fallback through rejection cycles.  The
    two packages follow one trajectory to rounding for the first 25
    iterations (22 rejections); then, at H exactly singular, a cost equal
    to the best one to the last bit decides accept or reject, and XLA's
    and torch's exp differ by an ulp there, so the runs part: both must
    converge, the port near the symmetric minimum."""
    xr, outr = jto.dogleg.optimize(jnp.asarray([0.3, 0.4]),
                                   jp.jennrich_sampson_residuals, HARD)
    x, out = to.dogleg.optimize(torch.tensor([0.3, 0.4], dtype=torch.float64),
                                tp.jennrich_sampson_residuals,
                                options_from_reference(HARD))
    assert bool(out.converged()) and bool(outr.converged())
    n = 25
    np.testing.assert_array_equal(out.successes[:n].numpy(),
                                  np.asarray(outr.successes[:n]))
    assert int((~out.successes[:n]).sum()) == 22
    np.testing.assert_allclose(out.errs[:n].numpy(), np.asarray(outr.errs[:n]),
                               rtol=1e-9)
    np.testing.assert_allclose(out.deltas2[:n].numpy(),
                               np.asarray(outr.deltas2[:n]), rtol=1e-9)
    assert float(out.final_cost.cost) < 125.0
    assert abs(float(x[0]) - float(x[1])) < 0.02


def test_batched_himmelblau_matches_vmap_of_reference():
    """tests/test_dogleg.py:226-235: four starts, four minima."""
    starts = np.array([[3.0, 2.0], [-2.8, 3.1], [-3.7, -3.2], [3.5, -1.8]])
    opts = jto.Options(solver_type=jto.DogLeg, max_iters=100)
    solve = jto.build_solver(jp.himmelblau_residuals, opts, "residuals",
                             jnp.asarray(starts[0]))
    xr, outr = jax.jit(jax.vmap(solve))(jnp.asarray(starts))
    x, out = to.batched_optimize(torch.from_numpy(starts),
                                 tp.himmelblau_residuals,
                                 options_from_reference(opts))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(out.stop_reason.numpy(),
                                  np.asarray(outr.stop_reason))
    np.testing.assert_array_equal(out.num_iters.numpy(),
                                  np.asarray(outr.num_iters))
    r = torch.func.vmap(tp.himmelblau_residuals)(x)
    assert float(r.abs().max()) < 1e-5


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_batched_dogleg_prior_matches_reference(solver, dtype):
    """The batch-native loop with DogLeg (λ = inverse trust radius, the
    fixed shrink on rejection) against the vmapped JAX loop, per instance:
    x, stop reason, iterations, failures, λ and the history."""
    rng = np.random.default_rng(5)
    B, d = 12, 6
    y = rng.uniform(-1, 1, (B, d)).astype(dtype)
    inv = (1.0 / rng.uniform(0.1, 1.1, (B, d))).astype(dtype)
    x0 = (3.0 * rng.uniform(-1, 1, (B, d))).astype(dtype)
    hk = (dict(solver="cholesky") if solver == "cholesky" else
          dict(solver="cg", save_last=False, carry_system=False, cg_iters=8))
    opts = jto.Options(solver_type=jto.DogLeg, max_iters=10, min_error=0.0,
                       min_rerr_dec=1e-12, min_step_norm2=1e-16,
                       hessian=jto.HessianOptions(**hk))
    jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
    ref = jax.jit(j_batched_solver(
        jp.prior_residual, opts, "residuals", jnp.asarray(x0[0]),
        jax.tree_util.tree_map(lambda a: a[0], jd)))(jnp.asarray(x0), jd)
    x, out = to.batched_optimize(
        torch.from_numpy(x0), tp.prior_residual, options_from_reference(opts),
        data_batch=prior_problem_from_numpy(y, inv, device="cpu",
                                            dtype=torch.from_numpy(y).dtype))
    xr, outr = ref
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), **tol)
    np.testing.assert_array_equal(out.stop_reason.numpy(),
                                  np.asarray(outr.stop_reason))
    np.testing.assert_array_equal(out.num_iters.numpy(),
                                  np.asarray(outr.num_iters))
    np.testing.assert_array_equal(out.num_failures.numpy(),
                                  np.asarray(outr.num_failures))
    np.testing.assert_allclose(out.final_lambda.numpy(),
                               np.asarray(outr.final_lambda), rtol=1e-6)
    np.testing.assert_array_equal(out.successes.numpy(),
                                  np.asarray(outr.successes))
    np.testing.assert_allclose(out.errs.numpy(), np.asarray(outr.errs), **tol)


def test_method_namespaces():
    """``tinyopt_tpu._methods``'s eight namespaces, the first-order ones
    held to the JAX package's solves."""
    for name in ("lm", "gn", "gd", "sgd", "adam", "adamw", "lbfgs",
                 "dogleg"):
        assert getattr(to, name).solver_type.name \
            == getattr(jto, name).solver_type.name
        assert getattr(to, name).Options().solver_type \
            == getattr(to, name).solver_type
    assert to.nlls is to.lm and to.unconstrained is to.gd
    x, out = to.dogleg.optimize(torch.tensor(1.0, dtype=torch.float64),
                                tp.sqrt2_residual)
    assert bool(out.converged()) and abs(float(x) - 2 ** 0.5) < 1e-6
    # the first-order namespaces solve as the JAX package's do (a 0-d
    # residual is a scalar cost for them: minimize x² − 2)
    for name in ("gd", "sgd", "adam", "adamw", "lbfgs"):
        xr, outr = getattr(jto, name).optimize(jnp.asarray(1.0),
                                               jp.sqrt2_residual)
        x, out = getattr(to, name).optimize(
            torch.tensor(1.0, dtype=torch.float64), tp.sqrt2_residual)
        np.testing.assert_allclose(float(x), float(xr), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
        assert int(out.num_iters) == int(outr.num_iters), name
        assert int(out.stop_reason) == int(outr.stop_reason), name
    # an unknown mode raises the JAX package's ValueError, as does a
    # scalar cost for the dogleg (tinyopt_tpu/optimize.py:147-152)
    for mode in ("cost_grad", "cost"):
        with pytest.raises(ValueError):
            to.dogleg.optimize(torch.tensor([1.0]),
                               lambda x: torch.sum(x ** 2), mode=mode)
