"""K2's multi-color Curtis–Powell–Reid branch: the port's fused twin with
diag_coloring "auto" on the hard suite's coupled problems (Powell singular
and Wood, 2 colors each) against the JAX package's fused Pallas kernel in
interpret mode, against its own "off" run bit for bit, a single-color
coloring that is not the identity through the closed-form step, and
Huber-whitened residuals through the twin; the kernel itself against the
twin on the card (``cuda`` mark)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.losses.robust_norms import huber as j_huber
from tinyopt_tpu.losses.robust_norms import robust_whiten as j_whiten
from tinyopt_tpu.models import problems as jp
from tinyopt_tpu.ops.pallas_solver import fused_batched_solver as j_fused

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import options_from_reference
from tinyopt_tpu_torch.losses.robust_norms import huber, robust_whiten
from tinyopt_tpu_torch.models import problems as tp
from tinyopt_tpu_torch.ops import cuda_solver
from tinyopt_tpu_torch.output import map_output

torch.set_num_threads(1)

#: the standard starts of tests/optimize_hard.cpp
STARTS = {"powell": (3.0, -1.0, 0.0, 1.0), "wood": (-3.0, -1.0, -3.0, -1.0)}
FNS = {"powell": (tp.powell_singular_residuals, jp.powell_singular_residuals),
       "wood": (tp.wood_residuals, jp.wood_residuals)}
SOLVERS = {"lm": jto.LevenbergMarquardt, "dogleg": jto.DogLeg}


def _opts(solver="lm", max_iters=200, coloring="auto"):
    """The hard suite's options of the fused solver: max_consec_failures 0
    (no failure budget), every other field at its default."""
    return jto.Options(
        max_iters=max_iters, max_consec_failures=0,
        solver_type=SOLVERS[solver],
        hessian=jto.HessianOptions(solver="fused", save_last=False,
                                   carry_system=False,
                                   diag_coloring=coloring))


def _starts(name, B=16, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (np.asarray(STARTS[name]) + 0.1 * rng.standard_normal((B, 4))
            ).astype(dtype)


def assert_parity(ref, got, rtol=1e-5, atol=1e-6, iter_slack=1,
                  fail_slack=0, grad_rtol=1e-4):
    """tests/test_fused.py:51 ``_assert_parity``: JAX kernel vs K2 twin,
    and equal stop reasons."""
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
    np.testing.assert_array_equal(outg.stop_reason.numpy(),
                                  np.asarray(outr.stop_reason))


def _twin(fn, opts, x, data=None, d_ex=None):
    topts = options_from_reference(opts)
    plan = cuda_solver.fused_plan(topts, "residuals", x[0], residual_fn=fn,
                                  data_example=d_ex)
    assert plan is not None
    return plan, cuda_solver.fused_solve(fn, topts, x, data, plan)


@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("name", ["powell", "wood"])
def test_twin_multicolor_matches_pallas_kernel(name, solver):
    """Powell singular and Wood get a 2-color coloring; the twin's colored
    diag(H) (one jvp a color, the recovery sum) and PCG step match the JAX
    kernel's (its HIGHEST-precision recovery matmul) in float64, from 16
    perturbed standard starts, 200 iterations: LM reaches MIN_ERROR on
    both, the dogleg on Wood and MAX_ITERS on Powell."""
    tfn, jfn = FNS[name]
    x0 = _starts(name)
    opts = _opts(solver)
    ref = j_fused(jfn, opts, jnp.asarray(x0[0]), None,
                  interpret=True)(jnp.asarray(x0))
    plan, got = _twin(tfn, opts, torch.from_numpy(x0))
    assert plan.coloring.n_colors == 2 and not plan.coloring.identity
    assert_parity(ref, got)
    expected = {("powell", "dogleg"): to.StopReason.MAX_ITERS}.get(
        (name, solver), to.StopReason.MIN_ERROR)
    assert bool(torch.all(got[1].stop_reason == int(expected)))


@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("name", ["powell", "wood"])
def test_twin_multicolor_equals_coloring_off(name, solver):
    """On these structures every row has one non-zero column per color, so
    the colored diag(H) is exact: "auto" and "off" (a jvp a dimension) give
    the same x, iterations and stop reasons bit for bit
    (tests/test_fused.py:445-470 of the Pallas kernel)."""
    tfn, _ = FNS[name]
    x0 = torch.from_numpy(_starts(name, seed=1))
    runs = {}
    for coloring in ("auto", "off"):
        plan, runs[coloring] = _twin(tfn, _opts(solver, 40, coloring), x0)
        assert (plan.coloring is None) == (coloring == "off")
    (xa, oa), (xo, oo) = runs["auto"], runs["off"]
    assert torch.equal(xa, xo)
    assert torch.equal(oa.num_iters, oo.num_iters)
    assert torch.equal(oa.stop_reason, oo.stop_reason)
    assert torch.equal(oa.final_grad, oo.final_grad)


def _two_priors_t(x, data):
    return torch.cat([(x - data[0]) * data[1], 2.0 * (x - data[2])])


def _two_priors_j(x, data):
    return jnp.concatenate([(x - data[0]) * data[1], 2.0 * (x - data[2])])


@pytest.mark.parametrize("solver", ["lm", "dogleg"])
def test_twin_single_color_closed_form(solver):
    """Two prior rows a dimension: one color that is not the identity
    (rows d..2d-1 are structural too), so diag(H) comes from the one probe
    and its recovery and the damped step is closed form, as in the JAX
    kernel's n_colors == 1 branch (pallas_solver.py:348)."""
    rng = np.random.default_rng(5)
    B, d = 12, 5
    y, s, z, x0 = (rng.uniform(-1, 1, (B, d)), rng.uniform(0.5, 2, (B, d)),
                   rng.uniform(-1, 1, (B, d)), rng.uniform(-1, 1, (B, d)))
    opts = _opts(solver, max_iters=10)
    jd = tuple(jnp.asarray(a) for a in (y, s, z))
    ref = j_fused(_two_priors_j, opts, jnp.asarray(x0[0]),
                  tuple(a[0] for a in jd), interpret=True)(jnp.asarray(x0),
                                                           jd)
    td = tuple(torch.from_numpy(a) for a in (y, s, z))
    plan, got = _twin(_two_priors_t, opts, torch.from_numpy(x0), td,
                      tuple(a[0] for a in td))
    assert plan.coloring.n_colors == 1 and not plan.coloring.identity
    assert_parity(ref, got)


def test_twin_robust_whitened_parity():
    """tests/test_fused.py:90-108: Huber-whitened prior residuals through
    the fused path, float32 (rtol 1e-4, atol 1e-5: association order
    compounds through the whitening's square roots)."""
    rng = np.random.default_rng(11)
    B, d = 24, 6
    y = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    inv = (1.0 / rng.uniform(0.1, 1.1, (B, d))).astype(np.float32)
    x0 = rng.uniform(-1, 1, (B, d)).astype(np.float32)

    def robust_t(x, data):
        r = (x - data.y) * data.inv_std
        return torch.func.vmap(
            lambda ri: robust_whiten(ri[None], huber, 0.5))(r)

    def robust_j(x, data):
        r = (x - data.y) * data.inv_std
        return jax.vmap(lambda ri: j_whiten(ri[None], j_huber, 0.5))(r)

    opts = jto.Options(max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
                       min_step_norm2=1e-16, max_consec_failures=3,
                       hessian=jto.HessianOptions(
                           solver="fused", save_last=False, cg_iters=8,
                           carry_system=False))
    jd = jp.PriorProblem(y=jnp.asarray(y), inv_std=jnp.asarray(inv))
    ref = j_fused(robust_j, opts, jnp.asarray(x0[0]),
                  jax.tree_util.tree_map(lambda a: a[0], jd),
                  interpret=True)(jnp.asarray(x0), jd)
    td = tp.PriorProblem(torch.from_numpy(y), torch.from_numpy(inv))
    _, got = _twin(robust_t, opts, torch.from_numpy(x0), td,
                   tp.PriorProblem(td.y[0], td.inv_std[0]))
    assert_parity(ref, got, rtol=1e-4, atol=1e-5)


def test_batched_optimize_takes_the_fused_path_with_colors():
    """``batched_optimize(..., solver="fused")`` on Powell singular runs the
    fused path (the twin on the CPU, K2 on the card), as the JAX package
    runs its kernel, and reaches the loop's answer."""
    x0 = torch.from_numpy(_starts("powell", B=8, seed=2))
    topts = options_from_reference(_opts("lm", 60))
    plan = cuda_solver.fused_plan(topts, "residuals", x0[0],
                                  residual_fn=tp.powell_singular_residuals)
    assert plan is not None and plan.coloring.n_colors == 2
    x, out = to.batched_optimize(x0, tp.powell_singular_residuals, topts)
    xf, outf = cuda_solver.fused_solve_plain(
        tp.powell_singular_residuals, topts, x0, None, plan)
    assert torch.equal(x, xf) and torch.equal(out.num_iters, outf.num_iters)
    assert bool(torch.all(out.stop_reason == int(to.StopReason.MIN_ERROR)))
    assert float(x.abs().max()) < 1e-2


@pytest.mark.parametrize("name", ["powell", "wood"])
def test_float32_residuals_keep_automatic_differentiation(name):
    """torch.func's forward mode gives a float64 tangent to a 0-d float32
    tensor times a Python float (Powell's ``x1 + 10.0 * x2`` of an
    unpacked x); the Jacobian is cast back to the parameters' type, so
    float32 Powell and Wood keep automatic differentiation instead of
    falling back to finite differences: the loop reaches the float64
    loop's stops and point, and ``solver="fused"`` takes the fused path
    (the twin here, K2 on the card)."""
    from tinyopt_tpu_torch.optimize import resolve_mode
    tfn, _ = FNS[name]
    x0 = torch.from_numpy(_starts(name, B=8, seed=4, dtype=np.float32))
    assert resolve_mode(tfn, to.Options(), "auto", x0[0]) \
        == ("residuals", False)
    lo = to.Options(max_iters=200, max_consec_failures=0)
    x, out = to.batched_optimize(x0, tfn, lo)
    x64, out64 = to.batched_optimize(x0.double(), tfn, lo)
    assert not out.num_diff_used
    assert bool(torch.all(out.stop_reason == int(to.StopReason.MIN_ERROR)))
    assert torch.equal(out.stop_reason, out64.stop_reason)
    torch.testing.assert_close(x.double(), x64, rtol=0, atol=1e-3)
    fused = options_from_reference(_opts("lm"))
    xf, outf = to.batched_optimize(x0, tfn, fused)
    plan = cuda_solver.fused_plan(fused, "residuals", x0[0], residual_fn=tfn)
    xr, outr = cuda_solver.fused_solve_plain(tfn, fused, x0, None, plan)
    assert not outf.num_diff_used
    assert torch.equal(xf, xr) and torch.equal(outf.num_iters, outr.num_iters)


def _k2_pair(name, solver, dtype, B, coloring="auto", nan_at=None):
    dev = torch.device("cuda")
    tfn, _ = FNS[name]
    x0 = torch.from_numpy(_starts(name, B=B, seed=B, dtype=dtype)).to(dev)
    if nan_at is not None:
        x0[nan_at] = float("nan")
    opts = options_from_reference(_opts(solver, coloring=coloring))
    plan = cuda_solver.fused_plan(opts, "residuals", x0[0], residual_fn=tfn)
    assert plan is not None
    assert (plan.coloring is None) == (coloring == "off")
    before = cuda_solver.fused_solve.launches
    got = cuda_solver.fused_solve(tfn, opts, x0, None, plan)
    assert cuda_solver.fused_solve.launches == before + 1
    ref = cuda_solver.fused_solve_plain(tfn, opts, x0, None, plan)
    return [(a.cpu(), map_output(lambda v: v.cpu(), o)) for a, o in (ref, got)]


def _k2_check(ref, got, dtype):
    """K2 against its twin: float64 x to rtol 1e-10 with equal stop reasons
    and iterations; float32 to rtol 1e-4 / atol 1e-5 with the same
    success (chip_smoke.py phase 4c)."""
    (xr, outr), (xg, outg) = ref, got
    if dtype == np.float64:
        torch.testing.assert_close(xg, xr, rtol=1e-10, atol=1e-12,
                                   equal_nan=True)
        assert torch.equal(outg.stop_reason, outr.stop_reason)
        assert torch.equal(outg.num_iters, outr.num_iters)
    else:
        torch.testing.assert_close(xg, xr, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)
    assert torch.equal(outg.succeeded(), outr.succeeded())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("name", ["powell", "wood"])
@pytest.mark.parametrize("B", [1, 3, 31, 32, 33, 257, 10_000])
def test_k2_multicolor_on_gpu(B, name, solver, dtype):
    """K2's multi-color branch (Powell and Wood families, one instance a
    lane, 32 a warp) against the twin, and K2 "auto" against K2 "off" bit
    for bit, on a partial warp, a full one and one past it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    if B == 10_000 and (name, solver) == ("powell", "dogleg"):
        B = 2000        # 200 iterations of the twin's host loop
    ref, got = _k2_pair(name, solver, dtype, B)
    _k2_check(ref, got, dtype)
    _, off = _k2_pair(name, solver, dtype, B, coloring="off")
    assert torch.equal(got[0], off[0])
    assert torch.equal(got[1].num_iters, off[1].num_iters)
    assert torch.equal(got[1].stop_reason, off[1].stop_reason)


def _nan_stops_alone(stops, nan_at):
    """The NaN start stops with SYSTEM_HAS_NAN_OR_INF, every other one
    succeeds."""
    assert stops[nan_at].item() == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
    assert bool(torch.all(torch.cat([stops[:nan_at], stops[nan_at + 1:]])
                          > 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,solver", [("wood", "lm"), ("powell", "dogleg")])
@pytest.mark.parametrize("B,nan_at", [(31, 16), (32, 16), (33, 16), (64, 5),
                                      (257, 144)])
def test_k2_multicolor_nan_neighbour_on_gpu(B, nan_at, name, solver, dtype):
    """An instance whose start is NaN, in the middle of a warp, stops with
    SYSTEM_HAS_NAN_OR_INF; the instances of its warp match the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    ref, got = _k2_pair(name, solver, dtype, B, nan_at=nan_at)
    _k2_check(ref, got, dtype)
    _nan_stops_alone(got[1].stop_reason, nan_at)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("name", ["powell", "wood"])
def test_batched_optimize_multicolor_on_gpu(name, solver, dtype):
    """``batched_optimize(..., solver="fused")`` on the card, the public
    entry: the solver's plan, parameters and color tables built once, one
    K2 launch and no K1, bit for bit the result of ``fused_solve`` on the
    same plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    from tinyopt_tpu_torch.ops import cuda_cg
    tfn, _ = FNS[name]
    x0 = torch.from_numpy(_starts(name, B=1000, seed=7, dtype=dtype)).cuda()
    opts = options_from_reference(_opts(solver))
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    x, out = to.batched_optimize(x0, tfn, opts)
    torch.cuda.synchronize()
    assert (cuda_cg.cg_solve.launches, cuda_solver.fused_solve.launches) \
        == (0, 1)
    plan = cuda_solver.fused_plan(opts, "residuals", x0[0], residual_fn=tfn)
    assert plan.coloring.n_colors == 2
    xr, outr = cuda_solver.fused_solve(tfn, opts, x0, None, plan)
    assert torch.equal(x, xr)
    assert torch.equal(out.num_iters, outr.num_iters)
    assert torch.equal(out.stop_reason, outr.stop_reason)
    assert bool(torch.all(out.succeeded()))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 257])
def test_k2_single_color_closed_form_on_gpu(B, solver):
    """K2's multi-color instances with one color take the closed-form step
    (the JAX kernel's n_colors == 1 branch), as the twin does.  No
    registered family has such a coloring, so the test gives Wood's family
    one color by hand: the all-ones probe and the structural recovery
    (diag(H) over-estimated, H taken as diagonal); K2 replays the twin's
    arithmetic on it, beside a NaN start in the middle of a warp (B > 1:
    instance 0 is the example the plan probes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    from tinyopt_tpu_torch.ops.coloring import DiagColoring
    tfn, _ = FNS["wood"]
    x0 = torch.from_numpy(_starts("wood", B=B, seed=3)).cuda()
    nan_at = 16 if B > 16 else None
    if nan_at is not None:
        x0[nan_at] = float("nan")
    opts = options_from_reference(_opts(solver, max_iters=50))
    plan = cuda_solver.fused_plan(opts, "residuals", x0[0], residual_fn=tfn)
    J = torch.func.jacfwd(tfn)(torch.tensor([0.3, -0.7, 1.1, 0.9],
                                            dtype=torch.float64))
    one = DiagColoring(probes=np.ones((1, 4)),
                       recovery=(J != 0).double().numpy(), n_colors=1)
    plan1 = plan._replace(coloring=one)
    before = cuda_solver.fused_solve.launches
    got = cuda_solver.fused_solve(tfn, opts, x0, None, plan1)
    assert cuda_solver.fused_solve.launches == before + 1
    ref = cuda_solver.fused_solve_plain(tfn, opts, x0, None, plan1)
    ref, got = [(a.cpu(), map_output(lambda v: v.cpu(), o))
                for a, o in (ref, got)]
    _k2_check(ref, got, np.float64)
    if nan_at is not None:
        _nan_stops_alone(got[1].stop_reason, nan_at)
    # the one-color solve is another algorithm than the two-color one
    two = cuda_solver.fused_solve_plain(tfn, opts, x0, None, plan)
    assert not torch.equal(two[0].cpu(), got[0])
