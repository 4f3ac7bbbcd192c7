"""The fused whole-solve path of tinyopt_tpu_torch (K2's plain twin, the
coloring detector and the envelope) against the JAX package's fused Pallas
kernel, run in interpret mode as tests/test_fused.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu import manifold as jmf
from tinyopt_tpu.models.problems import PriorProblem as JPrior
from tinyopt_tpu.models.problems import \
    jennrich_sampson_residuals as j_jennrich
from tinyopt_tpu.models.problems import prior_residual as j_prior
from tinyopt_tpu.ops.coloring import detect_diag_coloring as j_detect
from tinyopt_tpu.ops.pallas_solver import fused_batched_solver as j_fused
from tinyopt_tpu.parallel.batched import batched_solver as j_batched_solver

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       prior_problem_from_numpy)
from tinyopt_tpu_torch.models.problems import (PriorProblem,
                                               jennrich_sampson_residuals,
                                               prior_residual)
from tinyopt_tpu_torch.ops import cuda_solver
from tinyopt_tpu_torch.ops.coloring import detect_diag_coloring
from tinyopt_tpu_torch.output import map_output
from tinyopt_tpu_torch.ops.cuda_solver import (fused_batched_solver,
                                               fused_supported)

torch.set_num_threads(1)

TDT = {np.float32: torch.float32, np.float64: torch.float64}


def _opts(**kw):
    """tests/test_fused.py ``_opts`` with the fused solver."""
    hk = dict(save_last=False, solver="fused", cg_iters=8,
              carry_system=False)
    hk.update(kw.pop("hessian", {}))
    kw.setdefault("max_iters", 10)
    kw.setdefault("min_error", 0.0)
    kw.setdefault("min_rerr_dec", 1e-12)
    kw.setdefault("min_step_norm2", 1e-16)
    kw.setdefault("max_consec_failures", 3)
    kw.setdefault("save_history", False)
    return jto.Options(hessian=jto.HessianOptions(**hk), **kw)


def assert_parity(ref, got, rtol=1e-5, atol=1e-6, iter_slack=1,
                  fail_slack=0, grad_rtol=1e-4):
    """tests/test_fused.py:51 ``_assert_parity``: JAX kernel vs K2 twin."""
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


def _prior(B, d, dtype, seed):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1, 1, (B, d)).astype(dtype)
    inv = (1.0 / rng.uniform(0.1, 1.1, (B, d))).astype(dtype)
    x0 = rng.uniform(-1, 1, (B, d)).astype(dtype)
    return y, inv, x0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["prior_lm", "prior_gn", "prior_lm_off"])
def test_twin_matches_pallas_kernel_prior(case, dtype):
    """tests/test_fused.py:76-87 (and per-dim sweeps + in-kernel PCG with
    coloring off)."""
    B, d, seed = (32, 7, 3) if case != "prior_gn" else (16, 5, 5)
    kw = {}
    if case == "prior_gn":
        kw["solver_type"] = jto.GaussNewton
    if case == "prior_lm_off":
        kw["hessian"] = dict(diag_coloring="off")
    opts = _opts(**kw)
    y, inv, x0 = _prior(B, d, dtype, seed)
    jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
    jf = j_fused(j_prior, opts, jnp.asarray(x0[0]),
                 jax.tree_util.tree_map(lambda a: a[0], jd), interpret=True)
    ref = jf(jnp.asarray(x0), jd)
    td = prior_problem_from_numpy(y, inv, device="cpu", dtype=TDT[dtype])
    tx = torch.from_numpy(x0)
    topts = options_from_reference(opts)
    assert fused_supported(topts, "residuals", tx[0],
                           residual_fn=prior_residual,
                           data_example=PriorProblem(td.y[0], td.inv_std[0]))
    got = fused_batched_solver(prior_residual, topts, tx[0],
                               PriorProblem(td.y[0], td.inv_std[0]))(tx, td)
    assert_parity(ref, got)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    np.testing.assert_allclose(got[1].final_lambda.numpy(),
                               np.asarray(ref[1].final_lambda), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_twin_matches_pallas_kernel_jennrich_sampson(dtype):
    """tests/test_fused.py:111-124: rejections, rollback, probe re-steps
    and compounded λ escalation."""
    x0 = np.random.default_rng(0).uniform(0.1, 0.45, (24, 2)).astype(dtype)
    opts = _opts(max_iters=20, max_consec_failures=5)
    ref = j_fused(j_jennrich, opts, jnp.asarray(x0[0]), None,
                  interpret=True)(jnp.asarray(x0))
    got = to.batched_optimize(torch.from_numpy(x0),
                              jennrich_sampson_residuals,
                              options_from_reference(opts))
    # ill-conditioned: the wider tolerances of tests/test_fused.py:118-126
    assert_parity(ref, got, rtol=2e-3, atol=1e-3, iter_slack=2,
                  fail_slack=2, grad_rtol=2e-2)
    assert int(np.sum(np.asarray(ref[1].num_failures))) > 0
    assert int(got[1].num_failures.sum()) > 0


def assert_history(ref, got, rtol=1e-5, atol=1e-6):
    """The history rows of the JAX kernel and of K2's twin: num_hist and
    successes equal, errs and deltas2 to the tolerance, every slot past
    num_hist 0 / False in the twin."""
    outr, outg = ref[1], got[1]
    np.testing.assert_array_equal(outg.num_hist.numpy(),
                                  np.asarray(outr.num_hist))
    np.testing.assert_array_equal(outg.successes.numpy(),
                                  np.asarray(outr.successes))
    np.testing.assert_allclose(outg.errs.numpy(), np.asarray(outr.errs),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(outg.deltas2.numpy(), np.asarray(outr.deltas2),
                               rtol=rtol, atol=atol)
    past = torch.arange(outg.errs.shape[1])[None, :] >= outg.num_hist[:, None]
    assert bool(torch.all(outg.errs[past] == 0))
    assert bool(torch.all(outg.deltas2[past] == 0))
    assert not bool(torch.any(outg.successes[past]))


def _banded_t(x, y):
    return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


def _banded_j(x, y):
    return jnp.concatenate([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


@pytest.mark.parametrize("case,dtype", [
    (c, t) for c in ("prior", "banded_off", "jennrich_sampson",
                     "prior_off_history") for t in (np.float32, np.float64)
    # banded in float32 ends at cost 0 to rounding, where the stop among
    # MIN_DELTA_NORM and MAX_CONSEC_NO_DECR is rounding noise
    if (c, t) != ("banded_off", np.float32)])
def test_twin_matches_pallas_kernel_dogleg(case, dtype):
    """tests/test_fused.py:127-165: the dogleg in the kernel on the prior
    (closed-form GN and regularized steps), the banded problem with
    coloring off (PCG for every solve and the curvature matvec), and
    Jennrich-Sampson near its singular minimum (the κ-cap and both
    Levenberg fallbacks); and the dogleg with history, coloring off."""
    kw = dict(solver_type=jto.DogLeg)
    tol = dict(rtol=1e-5, atol=1e-6)
    if case in ("prior", "prior_off_history"):
        y, inv, x0 = _prior(16, 7, dtype, 3)
        if case == "prior_off_history":
            kw.update(save_history=True, hessian=dict(diag_coloring="off"))
        jfn, tfn = j_prior, prior_residual
        jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
        td = prior_problem_from_numpy(y, inv, device="cpu", dtype=TDT[dtype])
        jd_ex = jax.tree_util.tree_map(lambda a: a[0], jd)
        td_ex = PriorProblem(td.y[0], td.inv_std[0])
    elif case == "banded_off":
        kw["hessian"] = dict(diag_coloring="off")
        y = np.random.default_rng(0).normal(size=(12, 6)).astype(dtype)
        x0 = np.zeros((12, 6), dtype)
        jfn, tfn, jd, td = _banded_j, _banded_t, jnp.asarray(y), \
            torch.from_numpy(y)
        jd_ex, td_ex = jd[0], td[0]
        tol = dict(rtol=1e-4, atol=1e-5)
    else:
        kw["max_iters"] = 30
        x0 = (np.array([[0.3, 0.4]]) + 0.01 * np.random.default_rng(2)
              .normal(size=(8, 2))).astype(dtype)
        jfn, tfn, jd, td, jd_ex, td_ex = (j_jennrich,
                                          jennrich_sampson_residuals,
                                          None, None, None, None)
    opts = _opts(**kw)
    jf = j_fused(jfn, opts, jnp.asarray(x0[0]), jd_ex, interpret=True)
    ref = jf(jnp.asarray(x0)) if jd is None else jf(jnp.asarray(x0), jd)
    topts = options_from_reference(opts)
    tx = torch.from_numpy(x0)
    assert fused_supported(topts, "residuals", tx[0], residual_fn=tfn,
                           data_example=td_ex)
    solve = fused_batched_solver(tfn, topts, tx[0], td_ex)
    got = solve(tx) if td is None else solve(tx, td)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    if case == "jennrich_sampson":
        # tests/test_fused.py:153-165: equal stops and iterations, cost
        # to 1e-3 (H is singular)
        np.testing.assert_array_equal(got[1].num_iters.numpy(),
                                      np.asarray(ref[1].num_iters))
        np.testing.assert_allclose(got[1].final_cost.cost.numpy(),
                                   np.asarray(ref[1].final_cost.cost),
                                   rtol=1e-3, atol=1e-4)
        return
    assert_parity(ref, got, iter_slack=2 if case == "banded_off" else 1,
                  **tol)
    np.testing.assert_allclose(got[1].final_lambda.numpy(),
                               np.asarray(ref[1].final_lambda), rtol=1e-6)
    if case == "prior_off_history":
        assert_history(ref, got, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["prior", "jennrich_sampson"])
def test_twin_history_matches_pallas_kernel(case, dtype):
    """tests/test_fused.py:239-300: the per-iteration history of the
    fused path — errs, deltas2, successes (is_good, through rejections)
    and num_hist — on the prior and on Jennrich-Sampson."""
    if case == "prior":
        opts = _opts(save_history=True)
        y, inv, x0 = _prior(16, 6, dtype, 13)
        jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
        ref = j_fused(j_prior, opts, jnp.asarray(x0[0]),
                      jax.tree_util.tree_map(lambda a: a[0], jd),
                      interpret=True)(jnp.asarray(x0), jd)
        td = prior_problem_from_numpy(y, inv, device="cpu", dtype=TDT[dtype])
        got = fused_batched_solver(
            prior_residual, options_from_reference(opts),
            torch.from_numpy(x0[0]), PriorProblem(td.y[0], td.inv_std[0]))(
                torch.from_numpy(x0), td)
        tol = dict(rtol=1e-5, atol=1e-6)
    else:
        opts = _opts(save_history=True, max_iters=20, max_consec_failures=5)
        x0 = np.random.default_rng(1).uniform(0.1, 0.45, (12, 2)).astype(dtype)
        ref = j_fused(j_jennrich, opts, jnp.asarray(x0[0]), None,
                      interpret=True)(jnp.asarray(x0))
        got = to.batched_optimize(torch.from_numpy(x0),
                                  jennrich_sampson_residuals,
                                  options_from_reference(opts))
        assert int(got[1].num_failures.sum()) > 0
        # ill-conditioned: the wider tolerances of tests/test_fused.py:118
        tol = dict(rtol=2e-3, atol=1e-3)
    assert got[1].errs.shape == (x0.shape[0], opts.max_iters + 1)
    assert got[1].successes.dtype == torch.bool
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    assert_history(ref, got, **tol)


def _color_cases():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(10, 8))

    def mixed_t(x):
        return torch.cat([3.0 * x[:-1] * x[1:], x * x - 2.0])

    def mixed_j(x):
        return jnp.concatenate([3.0 * x[:-1] * x[1:], x * x - 2.0])

    x8 = rng.normal(size=(8,))
    return {
        "chain": (lambda x: x[:-1] - x[1:], lambda x: x[:-1] - x[1:],
                  np.zeros(8), 7),
        "dense": (lambda x: torch.from_numpy(A) @ x,
                  lambda x: jnp.asarray(A) @ x, np.zeros(8), 10),
        "mixed": (mixed_t, mixed_j, x8, 15),
    }


@pytest.mark.parametrize("name", ["prior50", "chain", "dense", "mixed"])
def test_coloring_matches_reference(name):
    if name == "prior50":
        y, inv, x0 = _prior(1, 50, np.float32, 0)
        tfn, jfn, x, n = prior_residual, j_prior, x0[0], 50
        tdata = PriorProblem(torch.from_numpy(y[0]), torch.from_numpy(inv[0]))
        jdata = JPrior(jnp.asarray(y[0]), jnp.asarray(inv[0]))
    else:
        tfn, jfn, x, n = _color_cases()[name]
        tdata = jdata = None
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    got = detect_diag_coloring(tfn, tx, tdata, mf.tangent_spec(tx), n,
                               x.size, tx.dtype)
    ref = j_detect(jfn, jx, jdata, jmf.tangent_spec(jx), n, x.size, jx.dtype)
    assert (got is None) == (ref is None)
    if ref is None:
        assert name == "dense"
        return
    assert got.n_colors == ref.n_colors and got.identity == ref.identity
    np.testing.assert_array_equal(got.probes, ref.probes)
    np.testing.assert_array_equal(got.recovery, ref.recovery)
    assert got.identity == (name == "prior50")


def test_fused_envelope():
    y, inv, x0 = _prior(4, 3, np.float32, 0)
    x_ex = torch.from_numpy(x0[0])
    d_ex = PriorProblem(torch.from_numpy(y[0]), torch.from_numpy(inv[0]))

    def ok(opts, fn=prior_residual, data=d_ex, x=x_ex):
        return fused_supported(options_from_reference(opts), "residuals", x,
                               residual_fn=fn, data_example=data)

    assert ok(_opts())
    assert ok(_opts(solver_type=jto.GaussNewton))
    # the JAX envelope
    assert not ok(_opts(hessian=dict(save_last=True, carry_system=True)))
    assert not ok(_opts(stop_callback=lambda e, d, g: False))
    assert not ok(jto.Options(solver_type=jto.GradientDescent))
    assert not ok(_opts(check_final_cost=True))
    assert not ok(_opts(hessian=dict(check_min_H_diag=1e-3)))
    assert not fused_supported(options_from_reference(_opts()), "acc", x_ex,
                               residual_fn=prior_residual, data_example=d_ex)
    # DogLeg and the history are inside it, as in the JAX envelope
    assert ok(_opts(solver_type=jto.DogLeg))
    assert ok(_opts(save_history=True))
    assert ok(_opts(solver_type=jto.DogLeg, save_history=True))
    # multi-color probes: any coloring runs the twin on the CPU
    assert ok(_opts(), fn=lambda x: x[:-1] - x[1:], data=None,
              x=torch.zeros(8))
    # mixed parameter dtypes
    assert not ok(_opts(), fn=lambda x: torch.cat([x["a"], x["b"]]),
                  data=None, x={"a": torch.zeros(2),
                                "b": torch.zeros(2, dtype=torch.float64)})
    # on the CPU any residual runs the twin: no registered family needed
    assert ok(_opts(), fn=lambda x: 2.0 * (x - 1.0), data=None)
    assert {f.id for f in cuda_solver.FAMILIES.values()} == {0, 1, 2, 3, 4}
    # the repair of ROADMAP Queue 3: print_failure is inside the envelope,
    # as in the JAX one
    assert ok(_opts(log=jto.LogOptions(print_failure=True)))


def test_batched_solver_dispatch_on_cpu():
    """solver="fused" inside the envelope runs the twin; outside it, the
    batch-native loop with CG semantics — same answers either way (a
    min-H-diag check the prior never trips takes the loop)."""
    y, inv, x0 = _prior(8, 4, np.float64, 1)
    td = prior_problem_from_numpy(y, inv, device="cpu",
                                  dtype=torch.float64)
    tx = torch.from_numpy(x0)
    fused = to.batched_optimize(tx, prior_residual,
                                options_from_reference(_opts()),
                                data_batch=td)
    loop = to.batched_optimize(
        tx, prior_residual,
        options_from_reference(_opts(
            save_history=True, hessian=dict(check_min_H_diag=1e-30))),
        data_batch=td)
    assert loop[1].errs.shape == (8, 11) and fused[1].errs.shape == (8, 0)
    np.testing.assert_allclose(fused[0].numpy(), loop[0].numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(fused[1].stop_reason.numpy(),
                                  loop[1].stop_reason.numpy())
    np.testing.assert_array_equal(fused[1].num_iters.numpy(),
                                  loop[1].num_iters.numpy())
    assert cuda_solver.fused_solve.launches == 0


def test_fused_print_failure_matches_pallas_kernel(capsys):
    """``log.print_failure`` does not take the fused path out of its
    envelope: the twin gives the x, stop reasons and iterations it gives
    without it, prints nothing, and matches the JAX fused kernel run with
    the same option; the cg loop serves it as the JAX loop does."""
    y, inv, x0 = _prior(8, 3, np.float64, 4)
    opts = _opts(log=jto.LogOptions(print_failure=True))
    jd = JPrior(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
    ref = j_fused(j_prior, opts, jnp.asarray(x0[0]),
                  jax.tree_util.tree_map(lambda a: a[0], jd),
                  interpret=True)(jnp.asarray(x0), jd)
    td = prior_problem_from_numpy(y, inv, device="cpu", dtype=torch.float64)
    tx = torch.from_numpy(x0)
    capsys.readouterr()
    got = to.batched_optimize(tx, prior_residual,
                              options_from_reference(opts), data_batch=td)
    plain = to.batched_optimize(tx, prior_residual,
                                options_from_reference(_opts()),
                                data_batch=td)
    assert capsys.readouterr().out == ""
    assert torch.equal(got[0], plain[0])
    assert torch.equal(got[1].stop_reason, plain[1].stop_reason)
    assert torch.equal(got[1].num_iters, plain[1].num_iters)
    assert_parity(ref, got)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    # the cg loop serves print_failure: the JAX loop's result, and no line
    # where no instance fails (the JAX loop under vmap prints a line for
    # every instance: its lax.cond is a select there)
    opts_cg = _opts(log=jto.LogOptions(print_failure=True),
                    hessian=dict(solver="cg"))
    ref_cg = jax.jit(j_batched_solver(
        j_prior, opts_cg, "residuals", jnp.asarray(x0[0]),
        jax.tree_util.tree_map(lambda a: a[0], jd)))(jnp.asarray(x0), jd)
    jax.effects_barrier()
    capsys.readouterr()
    got_cg = to.batched_optimize(tx, prior_residual,
                                 options_from_reference(opts_cg),
                                 data_batch=td)
    assert capsys.readouterr().out == ""
    assert_parity(ref_cg, got_cg)
    np.testing.assert_array_equal(got_cg[1].stop_reason.numpy(),
                                  np.asarray(ref_cg[1].stop_reason))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["prior", "prior_coloring_off",
                                  "prior_wide_f64", "jennrich_sampson"])
def test_k2_kernel_matches_twin_on_gpu(case):
    """K2 against its twin on the card: closed-form step (prior), per-dim
    diag sweeps + PCG through Jᵀ(Jp) (coloring off, Jennrich-Sampson), and
    shared memory above 48 KB per warp (d = 600 in float64: 77 KB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    dev = torch.device("cuda")
    B, d, dtype, kw = {
        "prior": (2000, 50, np.float32, {}),
        "prior_coloring_off": (500, 20, np.float32,
                               dict(hessian=dict(diag_coloring="off"))),
        "prior_wide_f64": (64, 600, np.float64, {}),
        "jennrich_sampson": (1000, 2, np.float32,
                             dict(max_iters=20, max_consec_failures=5)),
    }[case]
    opts = options_from_reference(_opts(**kw))
    if case == "jennrich_sampson":
        x0 = np.random.default_rng(2).uniform(0.1, 0.45, (B, d))
        fn, data, d_ex = jennrich_sampson_residuals, None, None
    else:
        y, inv, x0 = _prior(B, d, dtype, 2)
        fn = prior_residual
        data = prior_problem_from_numpy(y, inv, device=dev, dtype=TDT[dtype])
        d_ex = PriorProblem(data.y[0], data.inv_std[0])
    x = torch.from_numpy(x0.astype(dtype)).to(dev)
    plan = cuda_solver.fused_plan(opts, "residuals", x[0], residual_fn=fn,
                                  data_example=d_ex)
    assert plan is not None
    assert (plan.coloring is None) == (case in ("prior_coloring_off",
                                                "jennrich_sampson"))
    before = cuda_solver.fused_solve.launches
    got = cuda_solver.fused_solve(fn, opts, x, data, plan)
    assert cuda_solver.fused_solve.launches == before + 1
    ref = cuda_solver.fused_solve_plain(fn, opts, x, data, plan)
    to_cpu = [(a.cpu(), map_output(lambda v: v.cpu(), o)) for a, o in (ref, got)]
    if case == "jennrich_sampson":
        assert_parity(*to_cpu, rtol=2e-3, atol=1e-3, iter_slack=2,
                      fail_slack=2, grad_rtol=2e-2)
    else:
        assert_parity(*to_cpu)


def _k2_pairs():
    """The (S, E) pairs csrc/solver_seg.cuh builds for each family: the
    widths of ``K2_SEGMENTS`` with the family's ``kSegE`` (csrc/solver.cuh),
    from the least segment (``min_segment``: one lane where kSegE ≥ kMaxM,
    else 2) up while (S/2)·E < kMaxM (every S a plan takes for max(d,
    n_res) ≤ the family's largest, kMaxM ≤ 64).  The SE3 family has a
    register kernel of its own (tests/test_torch_se3.py)."""
    import re
    from tinyopt_tpu_torch import _build
    with open(f"{_build.CSRC}/solver_seg.cuh") as f:
        seg = f.read()
    with open(f"{_build.CSRC}/solver.cuh") as f:
        hdr = f.read()
    widths = re.search(r"#define K2_SEGMENTS\(X\)([^\n]*)", seg).group(1)
    widths = [int(w) for w in re.findall(r"X\((\d+)\)", widths)]
    pairs = {}
    for fam, name in ((0, "PriorFamily"), (1, "JenSamFamily"),
                      (3, "PowellFamily"), (4, "WoodFamily")):
        body = re.search(rf"struct {name} {{.*?kMaxM = \d+;", hdr,
                         re.S).group(0)
        E = int(re.search(r"kSegE = (\d+);", body).group(1))
        max_m = int(re.search(r"kMaxM = (\d+);", body).group(1))
        least = 1 if E >= max_m else 2
        pairs[fam] = {(S, E) for S in widths
                      if S == least or (S > least and (S // 2) * E < max_m)}
    return pairs


@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("case,d", [
    (c, d) for c in ("prior_identity", "prior_none")
    for d in (1, 2, 9, 16, 17, 32, 33, 50, 64, 65, 600)]
    + [("jennrich_sampson", 2), ("powell_multi", 4), ("powell_none", 4),
       ("wood_multi", 4), ("wood_none", 4)])
def test_k2_launch_plan(case, d, itemsize, solver):
    """K2's kernel and geometry from the shapes and the solver alone: the
    register kernel up to max(d, n_res) = 64 on segments that hold every
    entry, with a pair of (S, E) the kernel is built for, Powell's and
    Wood's families one instance a lane (S = 1) and one warp a block; past
    64, the warp kernel.  The dogleg instances take the plan of the LM
    ones."""
    family, n_res, coloring = {
        "prior_identity": (0, d, "identity"), "prior_none": (0, d, None),
        "jennrich_sampson": (1, 10, None), "powell_multi": (3, 4, "multi"),
        "powell_none": (3, 4, None), "wood_multi": (4, 6, "multi"),
        "wood_none": (4, 6, None)}[case]
    B = 10_007
    code = cuda_solver.SOLVER_CODES[{"lm": to.LevenbergMarquardt,
                                     "dogleg": to.DogLeg}[solver]]
    plan = cuda_solver.k2_launch_plan(B, d, n_res, itemsize, family, coloring,
                                      code)
    assert plan == cuda_solver.k2_launch_plan(B, d, n_res, itemsize, family,
                                              coloring, 0)
    m = max(d, n_res)
    assert plan.S * plan.E >= m
    assert plan.S & (plan.S - 1) == 0 and 1 <= plan.S <= 32
    if m > cuda_solver.SEG_MAX:
        assert plan.path == "warp" and plan.S == 32
        # 4 warps a block while their shared memory fits 48 KB
        per_warp = (14 * d + 2 * n_res) * itemsize
        assert plan.warps == max(w for w in (1, 2, 4)
                                 if w == 1 or w * per_warp <= 48 * 1024)
        assert plan.smem_bytes == plan.warps * per_warp
        assert plan.grid * plan.warps >= B
        return
    assert plan.path == "segment" and plan.smem_bytes == 0
    assert (plan.S, plan.E) in _k2_pairs()[family]
    assert plan.E == cuda_solver.SEG_E[family]
    # the least segment that holds max(d, n_res) entries: one lane for the
    # families of fixed shape, whose E holds every entry
    fixed = family in cuda_solver.FIXED_SHAPES
    assert (plan.S == 1) == fixed
    assert plan.S == (1 if fixed else 2) or (plan.S // 2) * plan.E < m
    if fixed:
        assert plan.E == m
    # a warp a block for one lane an instance: the 313 blocks of 10k
    # instances cover all 132 SMs of an H100
    assert plan.warps == (1 if fixed else cuda_solver.SEG_WARPS)
    per_block = plan.warps * 32 // plan.S
    assert plan.grid == -(-B // per_block)


def test_k2_launch_plan_small_batch_and_errors():
    """No more warps a block than the batch needs; bad inputs raise."""
    plan = cuda_solver.k2_launch_plan(1, 50, 50, 4, 0, "identity")
    assert plan.path == "segment" and plan.warps == 1 and plan.grid == 1
    for bad in [(3, 50, 50, 2, 0, None), (3, 50, 50, 4, 7, None),
                (3, 3, 10, 4, 1, None), (3, 2, 10, 4, 1, "identity"),
                (3, 50, 50, 4, 0, "two colors"), (3, 50, 50, 4, 0, None, 3),
                # families of fixed shape, colorings a family is not
                # built for, and the warp kernel's missing multi-color
                # branch
                (3, 5, 4, 4, 3, "multi"), (3, 4, 4, 4, 4, "multi"),
                (3, 4, 4, 4, 3, "identity"), (3, 50, 50, 4, 0, "multi"),
                (3, 2, 10, 4, 1, "multi")]:
        with pytest.raises(ValueError):
            cuda_solver.k2_launch_plan(*bad)


def test_k2_supports_is_the_launch_plans_envelope():
    """``k2_supports`` decides the shapes and colorings ``fused_plan``
    admits on the card, and ``k2_launch_plan`` plans exactly those; an id
    that is no family of K2's raises."""
    for args, ok in [((0, 50, 50, "identity"), True), ((0, 600, 600, None), True),
                     ((0, 50, 50, "multi"), False), ((1, 2, 10, None), True),
                     ((1, 3, 10, None), False), ((1, 2, 10, "identity"), False),
                     ((2, 6, 12, None, 7), True), ((2, 6, 13, None, 7), False),
                     ((2, 6, 12, "identity", 7), False), ((3, 4, 4, "multi"), True),
                     ((3, 4, 4, None), True), ((3, 5, 4, "multi"), False),
                     ((3, 4, 4, "identity"), False), ((4, 4, 6, "multi"), True),
                     ((4, 4, 4, "multi"), False), ((0, 50, 50, None, 51), False)]:
        assert cuda_solver.k2_supports(*args) is ok, args
        if ok:
            cuda_solver.k2_launch_plan(3, *args[1:3], 4, args[0], *args[3:4],
                                       1, *args[4:])
        else:
            with pytest.raises(ValueError, match="not built for"):
                cuda_solver.k2_launch_plan(3, *args[1:3], 4, args[0],
                                           *args[3:4], 1, *args[4:])
    with pytest.raises(ValueError, match="unknown residual family"):
        cuda_solver.k2_supports(7, 4, 4, None)


def test_k2_entry_point_matches_its_declaration():
    """The plan and the solver's parameters reach csrc/solver.cu through
    ctypes: the C entry points take as many arguments as ``_build.load``
    declares, the path codes are those of ``enum Path``, and the ctypes
    structs name the C structs' fields in their order."""
    import inspect
    import re
    from tinyopt_tpu_torch import _build
    with open(f"{_build.CSRC}/solver.cuh") as f:
        hdr = f.read()
    with open(f"{_build.CSRC}/solver.cu") as f:
        src = f.read()
    enum = re.search(r"enum Path \{([^}]*)\}", hdr).group(1)
    codes = {m[0]: int(m[1]) for m in re.findall(r"kPath(\w+) = (\d+)", enum)}
    assert {k.lower(): v for k, v in codes.items()} == cuda_solver.PATH_CODES
    enum = re.search(r"enum Solver \{([^}]*)\}", hdr).group(1)
    codes = {m[0]: int(m[1]) for m in re.findall(r"kSolver(\w+) = (\d+)",
                                                 enum)}
    assert codes == {"GN": 0, "LM": 1, "DogLeg": 2}
    assert {t.name: c for t, c in cuda_solver.SOLVER_CODES.items()} == {
        "GAUSS_NEWTON": 0, "LEVENBERG_MARQUARDT": 1, "DOGLEG": 2}
    decl = inspect.getsource(_build.load)
    block = decl[decl.index('"tinyopt_solver_f32"'):]
    declared = re.search(r"argtypes = \[([^\]]*)\]", block).group(1)
    n_declared = declared.count(",") + 1
    for name in ("tinyopt_solver_f32", "tinyopt_solver_f64"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
        assert params.count(",") + 1 == n_declared == 12, name
    # the register kernels' launcher takes the plans' least segment (one
    # lane, the fixed shapes), and the entry point holds Powell and Wood to
    # the shapes the plan and the families' compiled constants fix
    with open(f"{_build.CSRC}/solver_seg.cuh") as f:
        seg = f.read()
    least = int(re.search(r"if \(S < (\d+) \|\| S > 32", seg).group(1))
    assert least == 1 == min(
        cuda_solver.k2_launch_plan(3, d, n, 4, fam, col).S
        for fam, (d, n) in cuda_solver.FIXED_SHAPES.items()
        for col in ("multi", None))
    for fam, name in ((3, "Powell"), (4, "Wood")):
        d, n = cuda_solver.FIXED_SHAPES[fam]
        assert (f"(p->family == k{name} && (p->d != {d} || p->n_res != {n}))"
                in src), name
        body = re.search(rf"struct {name}Family {{.*?kMaxM = \d+;", hdr,
                         re.S).group(0)
        assert re.search(r"kD = (\d+), kNRes = (\d+);", body).groups() \
            == (str(d), str(n)), name
    for struct, cls in (("SolverParams", _build.SolverParams),
                        ("SolverIO", _build.SolverIO)):
        body = re.search(rf"struct {struct} \{{([^}}]*)\}}", hdr).group(1)
        names = re.findall(r"\*?(\w+)\s*[,;]", re.sub(r"//[^\n]*", "", body))
        assert names == [f[0] for f in cls._fields_], struct


def test_k2_register_kernels_are_instantiated():
    """Every register-kernel launcher the entry point can call (type ×
    dogleg × history) is instantiated in exactly one source of its own,
    each a translation unit that ``_build`` compiles in parallel."""
    import glob
    import re
    from tinyopt_tpu_torch import _build
    seen = []
    for src in glob.glob(f"{_build.CSRC}/solver_seg*.cu"):
        with open(src) as f:
            found = re.findall(r"^K2_SEG_INSTANCE\(, (\w+), (\w+), (\w+)\)",
                               f.read(), re.M)
        assert len(found) == 1, src
        seen += found
    assert sorted(seen) == sorted(
        (t, dl, h) for t in ("float", "double") for dl in ("false", "true")
        for h in ("false", "true"))
    assert all(s in _build.sources() for s in glob.glob(
        f"{_build.CSRC}/solver_seg*.cu"))


def _k2_case(B, d, dtype, seed, kw, dev, nan_at=None):
    y, inv, x0 = _prior(B, d, dtype, seed)
    if nan_at is not None:
        inv[nan_at] = np.nan
    data = prior_problem_from_numpy(y, inv, device=dev, dtype=TDT[dtype])
    x = torch.from_numpy(x0).to(dev)
    opts = options_from_reference(_opts(**kw))
    plan = cuda_solver.fused_plan(opts, "residuals", x[0],
                                  residual_fn=prior_residual,
                                  data_example=PriorProblem(data.y[0],
                                                            data.inv_std[0]))
    assert plan is not None
    before = cuda_solver.fused_solve.launches
    got = cuda_solver.fused_solve(prior_residual, opts, x, data, plan)
    assert cuda_solver.fused_solve.launches == before + 1
    ref = cuda_solver.fused_solve_plain(prior_residual, opts, x, data, plan)
    return [(a.cpu(), map_output(lambda v: v.cpu(), o)) for a, o in (ref, got)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B", [1, 3, 10_007])
@pytest.mark.parametrize("d", [1, 17, 50, 64, 65])
def test_k2_dogleg_shapes_on_gpu(dtype, B, d):
    """K2's dogleg against its twin on the card: the register kernel's
    segments of 2 to 16 lanes and its largest d, the warp kernel past it,
    the closed-form and the PCG solves; equal stop reasons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    dev = torch.device("cuda")
    for coloring in ("auto", "off"):
        kw = dict(solver_type=jto.DogLeg,
                  hessian=dict(diag_coloring=coloring))
        ref, got = _k2_case(B, d, dtype, 17 + d, kw, dev)
        assert_parity(ref, got)
        np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                      ref[1].stop_reason.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["prior", "prior_dogleg_off", "prior_wide",
                                  "jennrich_sampson"])
def test_k2_history_on_gpu(case, dtype):
    """K2's history rows against the twin's on the card: the register
    kernel (prior, and the dogleg with PCG), the warp kernel (d = 65) and
    Jennrich-Sampson through rejections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    dev = torch.device("cuda")
    if case == "jennrich_sampson":
        x0 = np.random.default_rng(3).uniform(0.1, 0.45, (1000, 2))
        x = torch.from_numpy(x0.astype(dtype)).to(dev)
        opts = options_from_reference(_opts(max_iters=20, save_history=True,
                                             max_consec_failures=5))
        fn = jennrich_sampson_residuals
        plan = cuda_solver.fused_plan(opts, "residuals", x[0], residual_fn=fn)
        got = cuda_solver.fused_solve(fn, opts, x, None, plan)
        ref = cuda_solver.fused_solve_plain(fn, opts, x, None, plan)
        ref, got = [(a.cpu(), map_output(lambda v: v.cpu(), o))
                    for a, o in (ref, got)]
        assert_parity(ref, got, rtol=2e-3, atol=1e-3, iter_slack=2,
                      fail_slack=2, grad_rtol=2e-2)
        tol = dict(rtol=2e-3, atol=1e-3)
    else:
        kw = dict(save_history=True)
        if case == "prior_dogleg_off":
            kw.update(solver_type=jto.DogLeg,
                      hessian=dict(diag_coloring="off"))
        d = 65 if case == "prior_wide" else 50
        ref, got = _k2_case(2000, d, dtype, 23, kw, dev)
        assert_parity(ref, got)
        tol = dict(rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  ref[1].stop_reason.numpy())
    outr, outg = ref[1], got[1]
    np.testing.assert_array_equal(outg.num_hist.numpy(), outr.num_hist.numpy())
    np.testing.assert_array_equal(outg.successes.numpy(),
                                  outr.successes.numpy())
    for a, b in ((outg.errs, outr.errs), (outg.deltas2, outr.deltas2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    past = torch.arange(outg.errs.shape[1])[None, :] >= outg.num_hist[:, None]
    assert bool(torch.all(outg.errs[past] == 0))
    assert not bool(torch.any(outg.successes[past]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B", [1, 3, 10_007])
@pytest.mark.parametrize("d", [1, 9, 16, 17, 32, 33, 50, 64, 65])
def test_k2_shapes_on_gpu(dtype, B, d):
    """K2 against its twin on the card at the edges of its plans: segments
    of 2 to 16 lanes, entries past d on a segment's last lanes, the
    register kernel's largest d and the warp kernel past it; LM and GN,
    the closed-form step and PCG; batches smaller than a warp's
    segments and larger than the grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    dev = torch.device("cuda")
    for kw in ({}, dict(solver_type=jto.GaussNewton),
               dict(hessian=dict(diag_coloring="off")),
               dict(solver_type=jto.GaussNewton,
                    hessian=dict(diag_coloring="off"))):
        assert_parity(*_k2_case(B, d, dtype, 7 + d, kw, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_nan_neighbour_on_gpu(dtype):
    """One instance with inv_std = nan stops with SYSTEM_HAS_NAN_OR_INF;
    the instances sharing its warp match the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    dev = torch.device("cuda")
    for d, kw in ((50, {}), (9, dict(hessian=dict(diag_coloring="off")))):
        ref, got = _k2_case(64, d, dtype, 11, kw, dev, nan_at=(5, 3))
        assert_parity(ref, got)
        stops = got[1].stop_reason.numpy()
        assert stops[5] == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
        assert np.all(np.delete(stops, 5) > 0)
        np.testing.assert_array_equal(stops, ref[1].stop_reason.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_jennrich_sampson_spread_on_gpu(dtype, solver):
    """Jennrich-Sampson from starts spread so that the segments of one warp
    stop at different iterations, against the twin; with the dogleg also
    near the singular minimum, where both Levenberg fallbacks run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    x0 = rng.uniform(0.1, 0.45, (1000, 2))
    x0[::3] = 0.2578 + rng.uniform(-1e-3, 1e-3, (334, 2))   # near the optimum
    x = torch.from_numpy(x0.astype(dtype)).to(dev)
    kw = dict(max_iters=20, max_consec_failures=5)
    if solver == "dogleg":
        kw["solver_type"] = jto.DogLeg
    opts = options_from_reference(_opts(**kw))
    fn = jennrich_sampson_residuals
    plan = cuda_solver.fused_plan(opts, "residuals", x[0], residual_fn=fn)
    got = cuda_solver.fused_solve(fn, opts, x, None, plan)
    ref = cuda_solver.fused_solve_plain(fn, opts, x, None, plan)
    got, ref = [(a.cpu(), map_output(lambda v: v.cpu(), o))
                for a, o in (got, ref)]
    assert_parity(ref, got, rtol=2e-3, atol=1e-3, iter_slack=2,
                  fail_slack=2, grad_rtol=2e-2)
    S = cuda_solver.k2_launch_plan(1000, 2, plan.n_res, x.element_size(), 1,
                                   None).S
    iters = got[1].num_iters.numpy()[: 32 // S]
    assert len(set(iters.tolist())) > 1, iters
