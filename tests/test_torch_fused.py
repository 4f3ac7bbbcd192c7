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
    # not ported into K2 yet: DogLeg, history, multi-color probes
    assert not ok(_opts(solver_type=jto.DogLeg))
    assert not ok(_opts(save_history=True))
    assert not ok(_opts(), fn=lambda x: x[:-1] - x[1:], data=None,
                  x=torch.zeros(8))
    # mixed parameter dtypes
    assert not ok(_opts(), fn=lambda x: torch.cat([x["a"], x["b"]]),
                  data=None, x={"a": torch.zeros(2),
                                "b": torch.zeros(2, dtype=torch.float64)})
    # on the CPU any residual runs the twin: no registered family needed
    assert ok(_opts(), fn=lambda x: 2.0 * (x - 1.0), data=None)
    assert set(cuda_solver.FAMILIES.values()) == {0, 1}


def test_batched_solver_dispatch_on_cpu():
    """solver="fused" inside the envelope runs the twin; outside it, the
    batch-native loop with CG semantics — same answers either way."""
    y, inv, x0 = _prior(8, 4, np.float64, 1)
    td = prior_problem_from_numpy(y, inv, device="cpu",
                                  dtype=torch.float64)
    tx = torch.from_numpy(x0)
    fused = to.batched_optimize(tx, prior_residual,
                                options_from_reference(_opts()),
                                data_batch=td)
    loop = to.batched_optimize(
        tx, prior_residual,
        options_from_reference(_opts(save_history=True)), data_batch=td)
    assert loop[1].errs.shape == (8, 11) and fused[1].errs.shape == (8, 0)
    np.testing.assert_allclose(fused[0].numpy(), loop[0].numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(fused[1].stop_reason.numpy(),
                                  loop[1].stop_reason.numpy())
    np.testing.assert_array_equal(fused[1].num_iters.numpy(),
                                  loop[1].num_iters.numpy())
    assert cuda_solver.fused_solve.launches == 0


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
