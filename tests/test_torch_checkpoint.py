"""Segments, checkpoints, the Stepper, the timeout loop and
profile_iterations of tinyopt_tpu_torch, against themselves and the JAX
package (tests/test_checkpoint.py).

The contract within the port: N segments of k iterations — with a
``save_state`` / ``load_state`` round trip between them — follow the
trajectory of one unsegmented solve bit for bit (``torch.equal`` on x,
stop reasons, iteration counts and history), batched too.  Against the
JAX package: float64, rtol 1e-5 and equal stop reasons."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu import checkpoint as jck
from tinyopt_tpu.models.problems import rosenbrock_residuals as j_rosen

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import checkpoint as ck
from tinyopt_tpu_torch.interop import options_from_reference
from tinyopt_tpu_torch.models.problems import (make_prior_batch,
                                               prior_residual,
                                               rosenbrock_residuals)

torch.set_num_threads(1)

X0 = [-1.2, 1.0]


def _tx(v=X0):
    return torch.tensor(v, dtype=torch.float64)


def _assert_same(a, b):
    """Bit for bit: x, stop reasons, iterations, failures, cost, history."""
    (xa, oa), (xb, ob) = a, b
    assert torch.equal(xa, xb)
    for k in ("stop_reason", "num_iters", "num_failures", "num_hist",
              "errs", "deltas2", "successes"):
        assert torch.equal(getattr(oa, k), getattr(ob, k)), k
    assert torch.equal(oa.final_cost.cost, ob.final_cost.cost)


def test_disk_round_trip_is_invisible(tmp_path):
    """Three segments with a save / load after the first are bit-identical
    to three without it, and follow the JAX package's segments."""
    opts = jto.Options(max_consec_failures=0)
    solver = ck.segment_solver(rosenbrock_residuals,
                               options_from_reference(opts), _tx(),
                               iters_per_segment=10)

    def run3(with_disk):
        x, out, st = solver.start(_tx())
        if with_disk:
            p = os.path.join(str(tmp_path), "ck.pt")
            ck.save_state(p, st)
            st = ck.load_state(p, solver.abstract_state())
        x, out, st = solver.resume(st)
        x, out, st = solver.resume(st)
        return x, out, st

    xa, outa, sta = run3(True)
    xb, outb, stb = run3(False)
    assert torch.equal(xa, xb) and torch.equal(sta.best_x, stb.best_x)
    assert torch.equal(outa.final_cost.cost, outb.final_cost.cost)
    js = jck.segment_solver(j_rosen, opts, jnp.asarray(X0),
                            iters_per_segment=10)
    xr, outr, str_ = js.start(jnp.asarray(X0))
    for _ in range(2):
        xr, outr, str_ = js.resume(str_)
    np.testing.assert_allclose(xa.numpy(), np.asarray(xr), rtol=1e-10)
    np.testing.assert_allclose(sta.best_x[0].numpy(),
                               np.asarray(str_.best_x), rtol=1e-10)
    assert int(outa.stop_reason) == int(outr.stop_reason)


def test_run_matches_unchunked():
    """run() equals one unsegmented solve with the same budget, history
    included, and the JAX package's run()."""
    opts = jto.Options(max_iters=29, max_consec_failures=0)
    topts = options_from_reference(opts)
    ref = to.optimize(_tx(), rosenbrock_residuals, topts)
    solver = ck.segment_solver(rosenbrock_residuals, topts, _tx(),
                               iters_per_segment=10)
    x, out, _ = solver.run(_tx())
    _assert_same((x, out), ref)
    js = jck.segment_solver(j_rosen, opts, jnp.asarray(X0),
                            iters_per_segment=10)
    xr, outr, _ = js.run(jnp.asarray(X0))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-10)
    assert int(out.num_iters) == int(outr.num_iters)
    assert int(out.num_iters) == int(out.num_hist) == len(out.errs_list) > 10
    np.testing.assert_allclose(out.errs_list, outr.errs_list, rtol=1e-9)


def test_run_until_convergence():
    solver = ck.segment_solver(lambda x: x * x - 2.0, to.Options(),
                               torch.tensor(1.0, dtype=torch.float64),
                               iters_per_segment=2)
    x, out, _ = solver.run(torch.tensor(1.0, dtype=torch.float64))
    assert bool(out.converged())
    assert abs(float(x) - 2 ** 0.5) < 1e-7


def test_first_order_state_survives(tmp_path):
    """Adam's moments live in the segment state: segments with a disk
    round trip continue the same trajectory, bit for bit against the
    unsegmented solve and to rounding against the JAX package."""
    opts = jto.Options(solver_type=jto.Adam, max_consec_failures=0,
                       max_iters=19, adam=jto.AdamOptions(lr=0.1))
    topts = options_from_reference(opts)
    x0 = [3.0, -2.0]
    cost = lambda x: torch.sum((x - 1.0) ** 2)        # noqa: E731
    x_ref, _ = to.optimize(_tx(x0), cost, topts, mode="cost")
    solver = ck.segment_solver(cost, topts, _tx(x0), mode="cost",
                               iters_per_segment=5)
    x, out, st = solver.start(_tx(x0))
    p = os.path.join(str(tmp_path), "ck.pt")
    ck.save_state(p, st)
    st = ck.load_state(p, solver.abstract_state())
    for _ in range(3):                   # 20 iterations in all
        x, out, st = solver.resume(st)
    assert torch.equal(st.best_x[0], x_ref)
    xr, _ = jto.optimize(jnp.asarray(x0),
                         lambda x: jnp.sum((x - 1.0) ** 2), opts, mode="cost")
    np.testing.assert_allclose(st.best_x[0].numpy(), np.asarray(xr),
                               rtol=1e-10)


@pytest.mark.parametrize("max_iters,per_segment,expected", [
    (12, 5, 13), (3, 10, 4)], ids=["total", "first_segment"])
def test_run_honors_budget(max_iters, per_segment, expected):
    """run() stops at the original max_iters + 1 even when no criterion
    fires, every segment (the first included) sized to the budget left,
    as the JAX package's run()."""
    opts = jto.Options(solver_type=jto.GradientDescent, max_iters=max_iters,
                       min_error=0.0, min_rerr_dec=0.0, min_step_norm2=0.0,
                       min_grad_norm2=0.0, max_consec_failures=0,
                       gd=jto.GDOptions(lr=1e-6))
    solver = ck.segment_solver(lambda x: torch.sum(x * x),
                               options_from_reference(opts), _tx([1.0]),
                               mode="cost", iters_per_segment=per_segment)
    x, out, _ = solver.run(_tx([1.0]))
    js = jck.segment_solver(lambda x: jnp.sum(x * x), opts, jnp.ones(1),
                            mode="cost", iters_per_segment=per_segment)
    xr, outr, _ = js.run(jnp.ones(1))
    assert int(out.num_iters) == int(outr.num_iters) == expected
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-12)


def test_check_final_cost_fallback():
    """With check_final_cost the segmented run's x carries a cost no
    larger than final_cost (options.h:43), as in the JAX package."""
    opts = jto.Options(check_final_cost=True, max_iters=20,
                       max_consec_failures=0)
    solver = ck.segment_solver(rosenbrock_residuals,
                               options_from_reference(opts), _tx(),
                               iters_per_segment=7)
    x, out, _ = solver.run(_tx())
    r = rosenbrock_residuals(x)
    assert float(torch.sum(r * r)) <= float(out.final_cost.cost) + 1e-12
    xr, outr, _ = jck.segment_solver(j_rosen, opts, jnp.asarray(X0),
                                     iters_per_segment=7).run(
                                         jnp.asarray(X0))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-10)
    assert int(out.num_iters) == int(outr.num_iters)


def test_requires_x_example():
    with pytest.raises(ValueError, match="x_example"):
        ck.segment_solver(lambda x: x, to.Options())


@pytest.mark.parametrize("kind", ["lm_cg", "adam", "lbfgs"])
def test_batched_segments_equal_one_solve(kind, tmp_path):
    """A batch in segments of 2 with a disk round trip after the first
    equals one batched solve bit for bit; instances that stop early stay
    stopped (the phase-9 check of chip_smoke.py at a small size)."""
    data, x0 = make_prior_batch(6, 5, torch.float64, device="cpu")
    data = type(data)(data.y, data.inv_std)
    hess = to.HessianOptions(solver="cg", cg_iters=3, carry_system=False,
                             save_last=False)
    opts = {"lm_cg": to.Options(max_iters=9, hessian=hess,
                                max_consec_failures=2),
            "adam": to.Options(solver_type=to.Adam, max_iters=9,
                               adam=to.AdamOptions(lr=0.05)),
            "lbfgs": to.Options(solver_type=to.LBFGS, max_iters=9)}[kind]
    ref = to.batched_optimize(x0, prior_residual, opts, data_batch=data,
                              mode="residuals")
    seg = ck.segment_solver(prior_residual, opts, x0[0], mode="residuals",
                            iters_per_segment=2,
                            data_example=type(data)(*(a[0] for a in data)))
    p = os.path.join(str(tmp_path), "seg.pt")
    seen = []

    def round_trip_once(st):
        if seen:
            return st
        seen.append(st)
        ck.save_state(p, st)
        return ck.load_state(p, seg.abstract_state(x0))

    x, out, _ = seg.run(x0, data, on_segment=round_trip_once)
    assert seen and int(out.num_iters.max()) > 2
    _assert_same((x, out), ref)


def test_batched_run_stops_instances_apart():
    """Instances of one batch stop at different iterations; run() keeps
    each one's stop reason, count and history."""
    data, x0 = make_prior_batch(5, 3, torch.float64, device="cpu",
                                seed=4)
    opts = to.Options(solver_type=to.LBFGS, max_iters=30)
    ref = to.batched_optimize(x0, prior_residual, opts, data_batch=data,
                              mode="residuals")
    assert len(set(ref[1].num_iters.tolist())) > 1
    seg = ck.segment_solver(prior_residual, opts, x0[0], mode="residuals",
                            iters_per_segment=3,
                            data_example=type(data)(*(a[0] for a in data)))
    _assert_same(seg.run(x0, data)[:2], ref)


class TestStepper:
    def test_step_by_step_matches_optimize(self):
        """N + 1 step() calls equal optimize(max_iters=N) and the JAX
        package's stepper."""
        N = 25
        opts = jto.Options(max_iters=N, max_consec_failures=0)
        topts = options_from_reference(opts)
        x_ref, out_ref = to.optimize(_tx(), rosenbrock_residuals, topts)
        st_api = to.stepper(rosenbrock_residuals, topts, x_example=_tx())
        x, out, state = st_api.step(_tx())
        n = 1
        while (int(out.stop_reason) in (int(to.StopReason.MAX_ITERS),
                                        int(to.StopReason.NONE))
               and n < N + 1):
            x, out, state = st_api.step(state=state)
            n += 1
        assert torch.equal(st_api.best_x(state), x_ref)
        assert float(out.final_cost.cost) == float(out_ref.final_cost.cost)
        js = jto.stepper(j_rosen, opts, x_example=jnp.asarray(X0))
        _, _, jstate = js.step(jnp.asarray(X0))
        for _ in range(N):
            _, _, jstate = js.step(state=jstate)
        np.testing.assert_allclose(st_api.best_x(state).numpy(),
                                   np.asarray(js.best_x(jstate)), rtol=1e-10)

    def test_stop_reason_propagates(self):
        st_api = to.stepper(lambda x: x * x - 2.0,
                            to.Options(min_error=1e-12),
                            x_example=torch.tensor(1.0, dtype=torch.float64))
        x, out, state = st_api.step(torch.tensor(1.0, dtype=torch.float64))
        for _ in range(20):
            if int(out.stop_reason) != int(to.StopReason.MAX_ITERS):
                break
            x, out, state = st_api.step(state=state)
        assert int(out.stop_reason) == int(to.StopReason.MIN_ERROR)
        assert abs(float(st_api.best_x(state)) - 2.0 ** 0.5) < 1e-6

    def test_custom_outer_logic(self):
        st_api = to.stepper(rosenbrock_residuals,
                            to.Options(max_consec_failures=0),
                            x_example=_tx())
        x, out, state = st_api.step(_tx())
        costs = [float(st_api.evaluate(st_api.best_x(state)))]
        for _ in range(80):
            x, out, state = st_api.step(state=state)
            costs.append(float(st_api.evaluate(st_api.best_x(state))))
            if costs[-1] < 1e-3:
                break
        assert costs[-1] < 1e-3 and costs[-1] <= costs[0]

    def test_arg_validation(self):
        st_api = to.stepper(rosenbrock_residuals, to.Options(),
                            x_example=_tx())
        with pytest.raises(ValueError):
            st_api.step()
        _, _, state = st_api.step(_tx())
        with pytest.raises(ValueError):
            st_api.step(_tx(), state=state)


@pytest.mark.parametrize("budget_ms", [1e-9, 1e6], ids=["tiny", "generous"])
def test_timeout(budget_ms):
    """max_duration_ms far below one iteration stops TIMED_OUT after the
    first with x at the best point; a generous budget equals the plain
    solve bit for bit; both as the JAX package's timeout loop."""
    opts = jto.Options(max_iters=30, max_consec_failures=0,
                       max_duration_ms=budget_ms)
    topts = options_from_reference(opts)
    x, out = to.optimize(_tx(), rosenbrock_residuals, topts)
    xr, outr = jto.optimize(jnp.asarray(X0), j_rosen, opts)
    assert int(out.stop_reason) == int(outr.stop_reason)
    assert int(out.num_iters) == int(outr.num_iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-10)
    if budget_ms < 1:
        assert int(out.stop_reason) == int(to.StopReason.TIMED_OUT)
        assert torch.equal(x, _tx())
    else:
        plain = to.optimize(_tx(), rosenbrock_residuals,
                            topts.replace(max_duration_ms=0.0))
        _assert_same((x, out), plain)


def test_profile_iterations_matches_reference():
    rng = np.random.default_rng(0)
    y = rng.normal(size=6)
    o = jto.Options(max_iters=10)
    ty = torch.from_numpy(y)
    x, out, taus = to.profile_iterations(
        torch.zeros(6, dtype=torch.float64), lambda x: x - ty,
        options_from_reference(o), perturb=0.0)
    x_ref, out_ref = to.optimize(torch.zeros(6, dtype=torch.float64),
                                 lambda x: x - ty, options_from_reference(o))
    assert torch.equal(x, x_ref)
    assert int(out.num_iters) == int(out_ref.num_iters) == len(taus)
    assert int(out.stop_reason) == int(out_ref.stop_reason)
    assert (taus > 0).all()
    assert float(out.duration_ms) == pytest.approx(taus.sum() * 1e3,
                                                   rel=1e-5)
    jy = jnp.asarray(y)
    xj, outj, tj = jto.profile_iterations(jnp.zeros(6), lambda x: x - jy, o,
                                          perturb=0.0)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-15)
    assert int(outj.num_iters) == int(out.num_iters)
    # a perturbed start still converges
    x, out, _ = to.profile_iterations(torch.zeros(6, dtype=torch.float64),
                                      lambda x: x - ty,
                                      options_from_reference(o),
                                      perturb=1e-6, seed=3)
    assert bool(out.converged())
    np.testing.assert_allclose(x.numpy(), y, atol=1e-5)


def test_dispatch_floor_positive():
    assert 0 < to.dispatch_floor(device="cpu") < 1.0
    assert 0 < jto.dispatch_floor() < 1.0


def test_log_dropped_is_false():
    """The port prints from the host: no requested line is dropped."""
    _, out = to.optimize(torch.tensor(1.0, dtype=torch.float64),
                         lambda x: x * x - 2.0,
                         to.Options(max_iters=7,
                                    log=to.LogOptions(enable=True)))
    assert out.log_dropped is False and bool(out.converged())


@pytest.mark.cuda
def test_batched_segments_on_gpu(tmp_path):
    """On the card, through "cg" (K1 each iteration): segments of 2 with a
    disk round trip equal one batched solve bit for bit, and the state
    loads back onto the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    from tinyopt_tpu_torch.ops import cuda_cg
    data, x0 = make_prior_batch(1000, 50, torch.float32, seed=2)
    opts = to.Options(max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
                      max_consec_failures=3,
                      hessian=to.HessianOptions(solver="cg", cg_iters=8,
                                                save_last=False,
                                                carry_system=False))
    ref = to.batched_optimize(x0, prior_residual, opts, data_batch=data)
    seg = ck.segment_solver(prior_residual, opts, x0[0],
                            iters_per_segment=2,
                            data_example=type(data)(*(a[0] for a in data)))
    p = os.path.join(str(tmp_path), "seg.pt")

    def round_trip(st):
        ck.save_state(p, st)
        st2 = ck.load_state(p, seg.abstract_state(x0))
        assert st2.x.device.type == "cuda"
        return st2

    cuda_cg.cg_solve.launches = 0
    got = seg.run(x0, data, on_segment=round_trip)[:2]
    assert cuda_cg.cg_solve.launches > 0
    _assert_same(got, ref)
