"""The whole ported slice end to end: ``batched_optimize`` of
tinyopt_tpu_torch against ``tinyopt_tpu.parallel.batched_optimize`` on the
bench problem (50-dim Gaussian prior, bench.py options) and on
Jennrich-Sampson, per instance, through solver="fused" and solver="cg"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.models.problems import PriorProblem as JPrior
from tinyopt_tpu.models.problems import \
    jennrich_sampson_residuals as j_jennrich
from tinyopt_tpu.models.problems import prior_residual as j_prior
from tinyopt_tpu.parallel.batched import batched_optimize as j_batched

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       prior_problem_from_numpy)
from tinyopt_tpu_torch.models.problems import (jennrich_sampson_residuals,
                                               prior_residual)

torch.set_num_threads(1)


def bench_options(solver, solver_type=jto.LevenbergMarquardt, **kw):
    """bench.py:61-68."""
    kw = {**dict(max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
                 min_step_norm2=1e-16, max_consec_failures=3), **kw}
    return jto.Options(
        solver_type=solver_type, save_history=False,
        hessian=jto.HessianOptions(save_last=False, solver=solver,
                                   cg_iters=8, carry_system=False,
                                   fused_block=512), **kw)


def assert_parity(ref, got, rtol=1e-5, atol=1e-6, iter_slack=1,
                  fail_slack=0):
    """Per instance: x, cost, success/convergence class, stop reason (or,
    with slack, iteration and failure counts)."""
    (xr, outr), (xg, outg) = ref, got
    np.testing.assert_allclose(xg.numpy(), np.asarray(xr), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= iter_slack
    assert np.max(np.abs(outg.num_failures.numpy()
                         - np.asarray(outr.num_failures))) <= fail_slack
    if iter_slack <= 1:
        np.testing.assert_array_equal(outg.stop_reason.numpy(),
                                      np.asarray(outr.stop_reason))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("solver", ["fused", "cg"])
@pytest.mark.parametrize("solver_type", [jto.LevenbergMarquardt,
                                         jto.GaussNewton], ids=["lm", "gn"])
def test_prior50_slice_matches_reference(solver_type, solver, dtype):
    rng = np.random.default_rng(50)
    B, d = 24, 50
    y = rng.uniform(-1, 1, (B, d)).astype(dtype)
    inv = (1.0 / rng.uniform(0.1, 1.1, (B, d))).astype(dtype)
    x0 = rng.uniform(-1, 1, (B, d)).astype(dtype)
    opts = bench_options(solver, solver_type)
    ref = j_batched(jnp.asarray(x0), j_prior, opts,
                    data_batch=JPrior(jnp.asarray(y), jnp.asarray(inv)))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    got = to.batched_optimize(torch.from_numpy(x0), prior_residual,
                              options_from_reference(opts),
                              data_batch=prior_problem_from_numpy(
                                  y, inv, device="cpu", dtype=tdt))
    assert got[0].shape == (B, d) and torch.all(torch.isfinite(got[0]))
    assert_parity(ref, got)
    assert bool(torch.all(got[1].converged()))
    np.testing.assert_allclose(got[0].numpy(), y, atol=1e-5)


@pytest.mark.parametrize("solver", ["fused", "cg"])
def test_jennrich_sampson_slice_matches_reference(solver):
    x0 = np.random.default_rng(9).uniform(0.1, 0.45, (16, 2))
    opts = bench_options(solver, max_iters=20, max_consec_failures=5)
    ref = j_batched(jnp.asarray(x0), j_jennrich, opts)
    got = to.batched_optimize(torch.from_numpy(x0),
                              jennrich_sampson_residuals,
                              options_from_reference(opts))
    # ill-conditioned: tests/test_fused.py:118-126 tolerances
    assert_parity(ref, got, rtol=2e-3, atol=1e-3, iter_slack=2,
                  fail_slack=2)
    assert int(got[1].num_failures.sum()) > 0
