"""The batch-native optimizer loop of tinyopt_tpu_torch against the JAX
package's loop (vmap of the jitted while-loop), instance by instance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.models.problems import PriorProblem as JPrior
from tinyopt_tpu.models.problems import \
    jennrich_sampson_residuals as j_jennrich
from tinyopt_tpu.models.problems import prior_residual as j_prior
from tinyopt_tpu.models.problems import sqrt2_residual as j_sqrt2
from tinyopt_tpu.parallel.batched import batched_solver as j_batched_solver

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       prior_problem_from_numpy)
from tinyopt_tpu_torch.models.problems import (jennrich_sampson_residuals,
                                               prior_residual, sqrt2_residual)

torch.set_num_threads(1)

TDT = {np.float32: torch.float32, np.float64: torch.float64}


def assert_parity(ref, got, rtol=1e-5, atol=1e-6, iter_slack=1,
                  fail_slack=0, grad_rtol=1e-4):
    """tests/test_fused.py:51 ``_assert_parity``: JAX result vs port."""
    (xr, outr), (xg, outg) = ref, got
    np.testing.assert_allclose(xg.numpy(), np.asarray(xr), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= iter_slack
    assert np.max(np.abs(outg.num_failures.numpy()
                         - np.asarray(outr.num_failures))) <= fail_slack
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(outg.final_grad.numpy(),
                               np.asarray(outr.final_grad), rtol=grad_rtol,
                               atol=1e-5)


def _prior_inputs(B, d, dtype, seed):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1, 1, (B, d)).astype(dtype)
    inv = (1.0 / rng.uniform(0.1, 1.1, (B, d))).astype(dtype)
    x0 = rng.uniform(-1, 1, (B, d)).astype(dtype)
    return y, inv, x0


def _run_prior(opts, B=12, d=6, dtype=np.float64, seed=0):
    y, inv, x0 = _prior_inputs(B, d, dtype, seed)
    jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
    solve = jax.jit(j_batched_solver(
        j_prior, opts, "residuals", jnp.asarray(x0[0]),
        jax.tree_util.tree_map(lambda a: a[0], jd)))
    ref = solve(jnp.asarray(x0), jd)
    got = to.batched_optimize(torch.from_numpy(x0), prior_residual,
                              options_from_reference(opts),
                              data_batch=prior_problem_from_numpy(
                                  y, inv, device="cpu", dtype=TDT[dtype]))
    return ref, got


def test_sqrt2_converges_in_five_lm_iterations():
    xr, outr = jto.optimize(jnp.asarray(1.0, jnp.float32),
                            lambda x: x * x - 2.0)
    x, out = to.optimize(torch.tensor(1.0), lambda x: x * x - 2)
    assert int(out.num_iters) == int(outr.num_iters) == 5
    assert int(out.stop_reason) == int(outr.stop_reason) \
        == int(to.StopReason.MIN_ERROR)
    assert x.shape == () and abs(float(x) - 2 ** 0.5) < 1e-6
    # float32: near the root x*x - 2 resolves to ~1e-7, so the last costs
    # (~1e-11 and below) agree only to that absolute level
    np.testing.assert_allclose(out.errs_list, outr.errs_list, rtol=1e-5,
                               atol=1e-9)
    assert out.successes_list == outr.successes_list
    assert "minimum error" in out.stop_reason_description()


def test_rejected_step_recovers_by_lambda_escalation():
    opts = jto.Options(max_consec_failures=0)
    xr, outr = jto.optimize(jnp.asarray(0.5), j_sqrt2, opts)
    x, out = to.optimize(torch.tensor(0.5, dtype=torch.float64),
                         sqrt2_residual, options_from_reference(opts))
    assert int(out.stop_reason) == int(outr.stop_reason)
    assert bool(out.converged())
    assert int(out.num_iters) == int(outr.num_iters)
    assert int(out.num_failures) == int(outr.num_failures)
    np.testing.assert_allclose(float(x), float(xr), rtol=1e-12)
    np.testing.assert_allclose(out.errs_list, outr.errs_list, rtol=1e-9,
                               atol=1e-15)
    assert out.successes_list == outr.successes_list


def test_nan_residuals_route_to_system_has_nan_or_inf():
    def bad(x):
        return x * torch.tensor(float("nan"), dtype=x.dtype)
    x, out = to.optimize(torch.tensor([1.0, 2.0]), bad)
    xr, outr = jto.optimize(jnp.asarray([1.0, 2.0]),
                            lambda x: x * jnp.nan)
    assert int(out.stop_reason) == int(outr.stop_reason) \
        == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
    assert not bool(out.succeeded())


def test_dict_parameters_match_reference():
    def res_t(p):
        return torch.cat([p["a"] * p["a"] - 2.0, 3.0 * (p["b"] - p["a"][:1])])

    def res_j(p):
        return jnp.concatenate([p["a"] * p["a"] - 2.0,
                                3.0 * (p["b"] - p["a"][:1])])

    x0 = {"a": np.array([1.0, 3.0]), "b": np.array([0.5])}
    xr, outr = jto.optimize({k: jnp.asarray(v) for k, v in x0.items()}, res_j)
    x, out = to.optimize({k: torch.from_numpy(v) for k, v in x0.items()},
                         res_t)
    for k in x0:
        np.testing.assert_allclose(x[k].numpy(), np.asarray(xr[k]),
                                   rtol=1e-10)
    assert int(out.num_iters) == int(outr.num_iters)
    assert int(out.stop_reason) == int(outr.stop_reason)


def test_residual_jacobian_matches_reference():
    from tinyopt_tpu.diff.auto import residual_jacobian as j_residual_jacobian

    from tinyopt_tpu_torch.diff.auto import residual_jacobian

    x = np.array([0.3, 0.2])
    rr, Jr = j_residual_jacobian(j_jennrich, jnp.asarray(x))
    r, J = residual_jacobian(jennrich_sampson_residuals, torch.from_numpy(x))
    assert J.shape == (10, 2)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=1e-12)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jr), rtol=1e-12)


def _opts(solver_type, solver, **kw):
    if solver == "cholesky":
        hk = dict(solver="cholesky")                # carry_system=True
    else:
        hk = dict(solver=solver, save_last=False, carry_system=False,
                  cg_iters=kw.pop("cg_iters", 8))
    kw.setdefault("max_iters", 10)
    kw.setdefault("min_error", 0.0)
    kw.setdefault("min_rerr_dec", 1e-12)
    kw.setdefault("min_step_norm2", 1e-16)
    kw.setdefault("max_consec_failures", 3)
    return jto.Options(solver_type=solver_type,
                       hessian=jto.HessianOptions(**hk), **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["cholesky", "cg"])
@pytest.mark.parametrize("solver_type", [jto.LevenbergMarquardt,
                                         jto.GaussNewton],
                         ids=["lm", "gn"])
def test_batched_prior_matches_reference(solver_type, solver, dtype):
    opts = _opts(solver_type, solver)
    ref, got = _run_prior(opts, dtype=dtype, seed=3)
    assert_parity(ref, got)
    # history and λ, instance by instance
    outr, outg = ref[1], got[1]
    np.testing.assert_array_equal(outg.num_hist.numpy(),
                                  np.asarray(outr.num_hist))
    np.testing.assert_array_equal(outg.successes.numpy(),
                                  np.asarray(outr.successes))
    np.testing.assert_allclose(outg.errs.numpy(), np.asarray(outr.errs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outg.final_lambda.numpy(),
                               np.asarray(outr.final_lambda), rtol=1e-6)
    if solver == "cholesky":
        np.testing.assert_allclose(outg.final_hessian.numpy(),
                                   np.asarray(outr.final_hessian),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", [
    dict(check_final_cost=True),
    dict(grad_clipping=0.5, use_step_quality_approx=True),
    dict(max_total_failures=2, max_consec_failures=0,
         lm=jto.LMOptions(damping_init=10.0, good_factor=0.5)),
    dict(cost=jto.CostScalingOptions(downscale_by_2=True, normalize=True),
         min_error=1e-3),
], ids=["check_final_cost", "clip_quality", "budgets", "cost_scaling"])
def test_loop_option_branches_match_reference(variant):
    opts = _opts(jto.LevenbergMarquardt, "cholesky", **variant)
    ref, got = _run_prior(opts, B=10, d=5, seed=11)
    assert_parity(ref, got)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    np.testing.assert_array_equal(got[1].num_hist.numpy(),
                                  np.asarray(ref[1].num_hist))


@pytest.mark.parametrize("solver,dtype", [("cg", np.float64),
                                          ("cg", np.float32),
                                          ("cholesky", np.float64)])
def test_batched_jennrich_sampson_matches_reference(solver, dtype):
    """Rejections, rollback and λ escalation; with "cholesky" (carry_system
    =True) also the evaluate-only iterations after a rejection."""
    x0 = np.random.default_rng(0).uniform(0.1, 0.45, (16, 2)).astype(dtype)
    opts = _opts(jto.LevenbergMarquardt, solver, max_iters=20,
                 max_consec_failures=5).replace(save_history=False)
    solve = jax.jit(j_batched_solver(j_jennrich, opts, "residuals",
                                     jnp.asarray(x0[0])))
    ref = solve(jnp.asarray(x0))
    got = to.batched_optimize(torch.from_numpy(x0),
                              jennrich_sampson_residuals,
                              options_from_reference(opts))
    # ill-conditioned: tests/test_fused.py:118-126 tolerances
    assert_parity(ref, got, rtol=2e-3, atol=1e-3, iter_slack=2,
                  fail_slack=2, grad_rtol=2e-2)
    assert int(got[1].num_failures.sum()) > 0


def _probe_jax_callbacks(capsys):
    """Run the JAX loop's one-time host-callback probe (it prints a line
    of its own) and drop what it printed."""
    from tinyopt_tpu.optimizers.loop import _callbacks_supported
    assert _callbacks_supported()
    jax.effects_barrier()
    capsys.readouterr()


@pytest.mark.parametrize("kw", [
    dict(solver_type=jto.GradientDescent),
    dict(log=jto.LogOptions(enable=True)),
    dict(stop_callback=lambda e, d, g: e < 1e-3),
    dict(max_duration_ms=1e-9),
], ids=["gd", "log", "callback", "timeout"])
def test_unported_options_raise(kw, capsys):
    """Options the loop once refused now give the JAX package's result on
    sqrt2: GD in cost mode, the log lines (the same text), a stop
    callback (USER_STOPPED at the same iteration) and a budget far below
    one iteration (TIMED_OUT after the first, at its best point)."""
    opts = jto.Options(**kw)
    _probe_jax_callbacks(capsys)
    xr, outr = jto.optimize(jnp.asarray(1.0), j_sqrt2, opts)
    jax.effects_barrier()
    ref_text = capsys.readouterr().out
    x, out = to.optimize(torch.tensor(1.0, dtype=torch.float64),
                         sqrt2_residual, options_from_reference(opts))
    assert capsys.readouterr().out == ref_text
    np.testing.assert_allclose(float(x), float(xr), rtol=1e-12)
    assert int(out.stop_reason) == int(outr.stop_reason)
    assert int(out.num_iters) == int(outr.num_iters)
    np.testing.assert_allclose(out.errs_list, outr.errs_list, rtol=1e-9,
                               atol=1e-15)
    if "log" in kw:
        assert ref_text.count("\n") == int(outr.num_iters) == 5
    if "stop_callback" in kw:
        assert int(out.stop_reason) == int(to.StopReason.USER_STOPPED)
    if "max_duration_ms" in kw:
        assert int(out.stop_reason) == int(to.StopReason.TIMED_OUT)
        assert int(out.num_iters) == 1 and float(x) == 1.0


_ZERO = dict(min_error=0, min_rerr_dec=0, min_step_norm2=0, min_grad_norm2=0)
_SPEC = {
    # name: (x0, torch residual, jax residual, options)
    "min_error": (1.0, sqrt2_residual, j_sqrt2, dict(min_error=1e-6)),
    "max_iters": (100.0, sqrt2_residual, j_sqrt2, dict(max_iters=2, **_ZERO)),
    "min_delta_norm": (1.0, sqrt2_residual, j_sqrt2,
                       dict(_ZERO, min_step_norm2=1e-8)),
    "min_grad_norm": (1.0, sqrt2_residual, j_sqrt2,
                      dict(_ZERO, min_grad_norm2=1e-8)),
    "nan": (1.0, lambda x: torch.full((2,), float("nan"),
                                      dtype=x.dtype) * x,
            lambda x: jnp.full((2,), jnp.nan) * x, {}),
    "inf_cost": (1.0, lambda x: torch.tensor(float("inf"),
                                             dtype=x.dtype) * x,
                 lambda x: jnp.asarray(jnp.inf) * x, {}),
    "empty_x": (np.zeros((0,)), lambda x: x, lambda x: x, {}),
    "empty_residuals": (1.0, lambda x: torch.zeros((0,), dtype=x.dtype),
                        lambda x: jnp.zeros((0,)), {}),
    "check_final_cost": (1.0, sqrt2_residual, j_sqrt2,
                         dict(max_iters=6, check_final_cost=True, **_ZERO)),
    "overdetermined": (np.zeros((1,)),
                       lambda x: torch.stack([x[0] - 1.0, x[0] - 1.2,
                                              x[0] - 0.8]),
                       lambda x: jnp.array([x[0] - 1.0, x[0] - 1.2,
                                            x[0] - 0.8]), {}),
}


@pytest.mark.parametrize("case", list(_SPEC))
def test_behavioral_spec_matches_reference(case):
    """tests/test_basic.py's residual-mode scenarios, through both
    packages in float64: the same stop reason, iterations, x, cost,
    history and saved (un-damped) Hessian."""
    x0, fn_t, fn_j, kw = _SPEC[case]
    xr, outr = jto.optimize(jnp.asarray(x0, jnp.float64), fn_j,
                            jto.Options(**kw))
    x, out = to.optimize(torch.as_tensor(x0, dtype=torch.float64), fn_t,
                         options_from_reference(jto.Options(**kw)))
    assert int(out.stop_reason) == int(outr.stop_reason)
    assert int(out.num_iters) == int(outr.num_iters)
    assert int(out.num_failures) == int(outr.num_failures)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-12)
    # the two packages round the first steps differently by an ulp, and
    # near the root the cost (≈ e²) magnifies that relatively: compare
    # costs to float64 rounding at the scale of the first cost (1.0)
    np.testing.assert_allclose(float(out.final_cost.cost),
                               float(outr.final_cost.cost), rtol=1e-9,
                               atol=1e-15)
    np.testing.assert_allclose(out.errs_list, outr.errs_list, rtol=1e-9,
                               atol=1e-15)
    assert out.successes_list == outr.successes_list
    if outr.final_hessian is not None and out.final_hessian is not None:
        np.testing.assert_allclose(out.final_hessian.numpy(),
                                   np.asarray(outr.final_hessian),
                                   rtol=1e-12)


def test_batch_of_one_and_start_sweep_match_single_solves():
    """tests/test_basic.py TestVmapConsistency: a batch lane follows the
    single solve's trajectory, and a dense sweep of starts converges."""
    opts = to.Options(max_consec_failures=0)
    s = torch.tensor(0.5342465753424658, dtype=torch.float64)
    x1, o1 = to.optimize(s, sqrt2_residual, opts)
    xs, os_ = to.batched_optimize(s[None], sqrt2_residual, opts)
    assert float(xs[0]) == float(x1)
    assert int(os_.num_iters[0]) == int(o1.num_iters)
    assert int(os_.stop_reason[0]) == int(o1.stop_reason)
    starts = torch.linspace(0.5, 4.0, 256, dtype=torch.float64)
    xs, outs = to.batched_optimize(starts, sqrt2_residual, opts)
    assert bool(torch.all(outs.converged()))
    assert float(torch.max(torch.abs(xs - 2 ** 0.5))) < 1e-5


def _jax_lines(capsys, run):
    _probe_jax_callbacks(capsys)
    res = run()
    jax.effects_barrier()
    return res, capsys.readouterr().out.splitlines()


_LOG_VARIANTS = {
    "x_dx": dict(print_x=True, print_dx=True),
    "inliers_sigma": dict(print_inliers=True, print_max_stdev=True, e="E"),
    "emoji": dict(print_emoji=True),
    "tau": dict(print_t=True),
    "jacobian": dict(print_J_jet=True),
}


@pytest.mark.parametrize("variant", list(_LOG_VARIANTS))
def test_log_options_match_reference(variant, capsys):
    """One instance: the port prints the JAX package's lines, character
    for character (τ, a host clock, is compared by its presence)."""
    import re
    y = np.array([0.3, -0.7, 1.1])
    s = np.array([2.0, 1.0, 0.5])
    opts = jto.Options(log=jto.LogOptions(enable=True,
                                          **_LOG_VARIANTS[variant]))
    (xr, outr), ref = _jax_lines(capsys, lambda: jto.optimize(
        jnp.asarray([1.0, 2.0, 3.0]),
        lambda x: jnp.sin(x - jnp.asarray(y)) * jnp.asarray(s), opts))
    x, out = to.optimize(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64),
                         lambda x: torch.sin(x - torch.from_numpy(y))
                         * torch.from_numpy(s), options_from_reference(opts))
    got = capsys.readouterr().out.splitlines()
    assert int(out.num_iters) == int(outr.num_iters)
    if variant == "tau":
        tau = re.compile(r" τ:[0-9.]+$")
        assert all(tau.search(l) for l in got + ref)
        got = [tau.sub("", l) for l in got]
        ref = [tau.sub("", l) for l in ref]
    if variant in ("x_dx", "jacobian"):
        # printed arrays: a zero's sign (XLA's -0. where torch gives 0.)
        # shifts numpy's alignment; compare the text without spaces and
        # the numbers as numbers (-0.0 == 0.0)
        num = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")

        def fields(lines):
            return [(num.sub("#", l).replace(" ", ""),
                     [float(v) for v in num.findall(l)]) for l in lines]
        got, ref = fields(got), fields(ref)
    assert got == ref
    if variant != "jacobian":
        assert len(got) == int(out.num_iters)


def test_log_lines_batched_match_vmap(capsys):
    """A batch of 3: the port prints, each iteration, one line per ACTIVE
    instance in instance order; the JAX loop under vmap prints one for
    every instance, stopped ones included (their frozen state evaluated
    again).  Removing those, the texts are equal."""
    y, inv, x0 = _prior_inputs(3, 2, np.float64, 5)
    x0[1] = y[1]                                   # stops at once
    opts = _opts(jto.LevenbergMarquardt, "cholesky", max_iters=8,
                 min_rerr_dec=0.0, min_error=1e-20,
                 log=jto.LogOptions(enable=True))
    jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
    solve = jax.jit(j_batched_solver(
        j_prior, opts, "residuals", jnp.asarray(x0[0]),
        jax.tree_util.tree_map(lambda a: a[0], jd)))
    (xr, outr), ref = _jax_lines(capsys, lambda: solve(jnp.asarray(x0), jd))
    got_x, got_out = to.batched_optimize(
        torch.from_numpy(x0), prior_residual, options_from_reference(opts),
        data_batch=prior_problem_from_numpy(y, inv, device="cpu",
                                            dtype=torch.float64))
    got = capsys.readouterr().out.splitlines()
    iters = np.asarray(outr.num_iters)
    assert len(set(iters.tolist())) > 1
    active = [line for i, line in enumerate(ref)
              if i // 3 < iters[i % 3]]
    assert got == active
    assert len(got) == int(got_out.num_iters.sum())


def test_print_failure_matches_reference(capsys):
    """A residual that turns NaN after the first accepted step: one
    FAILURE line, the JAX package's, then SYSTEM_HAS_NAN_OR_INF."""
    opts = jto.Options(log=jto.LogOptions(print_failure=True))
    (xr, outr), ref = _jax_lines(capsys, lambda: jto.optimize(
        jnp.asarray(1.0), lambda x: jnp.where(x > 1.2, jnp.nan, x * x - 2.0),
        opts))
    x, out = to.optimize(
        torch.tensor(1.0, dtype=torch.float64),
        lambda x: torch.where(x > 1.2, torch.full_like(x, float("nan")),
                              x * x - 2.0), options_from_reference(opts))
    got = capsys.readouterr().out.splitlines()
    assert got == ref and len(got) == 1 and got[0].startswith("FAILURE #1")
    assert int(out.stop_reason) == int(outr.stop_reason) \
        == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
    assert float(x) == float(xr)


@pytest.mark.parametrize("which", ["stop_callback", "stop_callback2"])
def test_stop_callbacks_match_reference(which):
    """A per-instance callback, vmapped over the batch with torch.func as
    the JAX loop's is under vmap: USER_STOPPED at the same iteration, per
    instance."""
    if which == "stop_callback":
        cb = lambda e, d, g: e < 1e-2                     # noqa: E731
    else:
        cb = lambda e, dx, g: (g * g).sum() < 1e-1        # noqa: E731
    opts = _opts(jto.LevenbergMarquardt, "cholesky", max_iters=20,
                 min_rerr_dec=0.0, **{which: cb})
    ref, got = _run_prior(opts, B=6, d=4, seed=9)
    assert_parity(ref, got)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    assert bool((got[1].stop_reason
                 == int(to.StopReason.USER_STOPPED)).all())


@pytest.mark.cuda
def test_log_lines_on_gpu(capsys):
    """The log and failure lines of a batch on the card: the CPU's count
    and text (float64, "cg" through K1; the third instance's data NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    y, inv, x0 = _prior_inputs(3, 4, np.float64, 21)
    y[2, 0] = np.nan
    opts = to.Options(max_iters=8, hessian=to.HessianOptions(solver="cg"),
                      log=to.LogOptions(enable=True, print_failure=True))

    def run(device):
        to.batched_optimize(torch.from_numpy(x0).to(device), prior_residual,
                            opts, data_batch=prior_problem_from_numpy(
                                y, inv, device=device, dtype=torch.float64))
        return capsys.readouterr().out.splitlines()

    capsys.readouterr()
    gpu, cpu = run("cuda"), run("cpu")
    assert len(gpu) == len(cpu) > 3
    assert sum(l.startswith("FAILURE") for l in gpu) == 1
    assert [l.split(" ")[0] for l in gpu] == [l.split(" ")[0] for l in cpu]
