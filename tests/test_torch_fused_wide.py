"""The fused path just past max(P, D, n_res) = 64, where on the card a
generated K2 family runs in K2's warp kernel (``csrc/solver_warp.cuh``) —
the robust point-to-point SE3 fit at 24 points (72 residuals), the 2-color
banded residual with data at d = 72 with its coloring ("auto") and without
("off"), LM and the dogleg, the Huber curve fit at 80 samples — against the
JAX package's fused Pallas kernel in interpret mode, in float64, per
instance: the port's ``batched_optimize`` runs ``fused_solve_plain`` here,
the twin the warp kernel is held to on the card
(tests/test_torch_codegen_warp.py, ``chip_smoke.py`` phase 23).
Tolerances are ``_assert_parity``'s (tests/test_fused.py:51: x and the
cost to rtol 1e-5, the gradient to 1e-4, the same success and
convergence classes, iterations within one, failures equal), or the JAX
test's own wider ones for the banded residual (:149, :466)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu.losses.robust_norms import huber as j_huber
from tinyopt_tpu.losses.robust_norms import robust_whiten as j_whiten
from tinyopt_tpu.ops.pallas_solver import fused_batched_solver as j_fused

import tinyopt_tpu_torch as to
import torch_manifold_cases as cases
from tinyopt_tpu_torch.interop import options_from_reference
from tinyopt_tpu_torch.models import curve_fit
from tinyopt_tpu_torch.ops import cuda_solver

torch.set_num_threads(1)

B = 8
ICP_POINTS, ICP_OUTLIERS = 24, 4
BAND_D, CURVE_N = 72, 80


def _opts(**kw):
    """tests/test_fused.py ``_opts`` with the fused solver."""
    hk = dict(save_last=False, solver="fused", cg_iters=8,
              carry_system=False)
    hk.update(kw.pop("hessian", {}))
    for k, v in dict(max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
                     min_step_norm2=1e-16, max_consec_failures=3,
                     save_history=False).items():
        kw.setdefault(k, v)
    return jto.Options(hessian=jto.HessianOptions(**hk), **kw)


def _j_banded(x, y):
    return jnp.concatenate([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


def _t_banded(x, y):
    return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


def _j_curve_huber(x, d):
    t, y = d
    r = x[0] * jnp.exp(x[1] * t) - y
    return jax.vmap(lambda ri: j_whiten(ri[None], j_huber,
                                        curve_fit.TH2))(r)


#: name -> (the port's residual, the JAX options, the widths)
CASES = {
    "icp_huber": (cases.residual("icp_huber"), cases.jax_options(),
                  (7, 6, 3 * ICP_POINTS)),
    "banded": (_t_banded, _opts(), (BAND_D, BAND_D, BAND_D)),
    "banded_off": (_t_banded, _opts(hessian=dict(diag_coloring="off")),
                   (BAND_D, BAND_D, BAND_D)),
    "banded_dl": (_t_banded, _opts(solver_type=jto.DogLeg),
                  (BAND_D, BAND_D, BAND_D)),
    "banded_dl_off": (_t_banded, _opts(solver_type=jto.DogLeg, hessian=dict(
        diag_coloring="off")), (BAND_D, BAND_D, BAND_D)),
    "curve_huber": (curve_fit.huber_residuals, jto.Options(
        max_iters=30, max_consec_failures=0, hessian=jto.HessianOptions(
            solver="fused", save_last=False, carry_system=False)),
        (2, 2, CURVE_N)),
}


def _inputs(name):
    """(the JAX residual, JAX x0 and data, the port's x0 and data) of a
    case, drawn with numpy (float64)."""
    rng = np.random.default_rng(20)
    if name == "icp_huber":
        _, SO3, SE3, _, _, icp_residual = cases._lib("jax")
        pts = jnp.asarray(rng.uniform(-1, 1, (B, ICP_POINTS, 3)))
        w = rng.uniform(-0.5, 0.5, (B, 6))
        true = SE3.exp(jnp.asarray(w))
        tgt = (SO3(true.rotation.wxyz[:, None, :]).apply(pts)
               + true.translation[:, None, :]
               + jnp.asarray(1e-3 * rng.normal(size=(B, ICP_POINTS, 3))))
        tgt = jnp.concatenate(
            [tgt[:, :ICP_OUTLIERS]
             + jnp.asarray(0.5 * rng.normal(size=(B, ICP_OUTLIERS, 3))),
             tgt[:, ICP_OUTLIERS:]], 1)
        from tinyopt_tpu.models.se3_refinement import SE3RefinementData
        jx = SE3.exp(jnp.asarray(w + 0.1 * rng.normal(size=(B, 6))))
        jd = SE3RefinementData(pts, tgt)
        tx, td = cases.to_port(name, jx, jd)

        def jfn(T, d):
            return icp_residual(T, d.points, d.targets,
                               robust_th=cases.ICP_TH)
        return jfn, jx, jd, tx, td
    if name.startswith("banded"):
        x0 = np.zeros((B, BAND_D))
        y = rng.normal(size=(B, BAND_D))
        return (_j_banded, jnp.asarray(x0), jnp.asarray(y),
                torch.as_tensor(x0), torch.as_tensor(y))
    t = np.tile(np.linspace(0.0, 2.0, CURVE_N), (B, 1))
    y = 1.7 * np.exp(0.8 * t) + 0.05 * rng.normal(size=(B, CURVE_N))
    y[:, ::4] += rng.uniform(3, 12, (B, CURVE_N // 4)) * rng.choice(
        [-1, 1], (B, CURVE_N // 4))
    x0 = np.stack([rng.uniform(0.8, 1.2, B), rng.uniform(0.4, 0.6, B)], 1)
    return (_j_curve_huber, jnp.asarray(x0),
            (jnp.asarray(t), jnp.asarray(y)), torch.as_tensor(x0),
            curve_fit.CurveData(torch.as_tensor(t), torch.as_tensor(y)))


@pytest.fixture(scope="module")
def solved():
    """Each case solved once by the JAX kernel in interpret mode and by the
    port's fused path."""
    cache = {}

    def get(name):
        if name not in cache:
            fn, jopts, _ = CASES[name]
            jfn, jx, jd, tx, td = _inputs(name)
            ex = jax.tree_util.tree_map(lambda v: v[0], (jx, jd))
            ref = j_fused(jfn, jopts, *ex, interpret=True)(jx, jd)
            topts = options_from_reference(jopts)
            got = to.batched_optimize(tx, fn, topts, data_batch=td)
            cache[name] = (ref, got, tx, td, topts)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_fused_matches_jax_kernel(name, solved):
    """The port's fused path against the JAX kernel per instance:
    ``_assert_parity``'s tolerances, with the banded dogleg's two
    iterations of slack (tests/test_fused.py:149) and the banded LM's one
    failure (:466)."""
    (xr, outr), (xg, outg), *_ = solved(name)
    slack = 2 if name.startswith("banded_dl") else 1
    fail_slack = 1 if name in ("banded", "banded_off") else 0
    np.testing.assert_allclose(cases.flat(xg), cases.flat(xr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= slack
    assert np.max(np.abs(outg.num_failures.numpy()
                         - np.asarray(outr.num_failures))) <= fail_slack
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outg.final_grad.numpy(),
                               np.asarray(outr.final_grad), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_plan_of_each_case(name, solved):
    """On the card each case takes K2's warp kernel (a generated family
    past 64: tests/test_torch_codegen_warp.py traces them), with the JAX
    kernel's coloring: 2 colors on the banded residual with "auto", none
    with "off"."""
    _, _, tx, td, topts = solved(name)
    fn, _, widths = CASES[name]
    x_ex, d_ex = pytree.tree_map(lambda a: a[0], (tx, td))
    plan = cuda_solver.fused_plan(topts, "residuals", x_ex, residual_fn=fn,
                                  data_example=d_ex)
    assert (plan.spec.params, plan.spec.dims, plan.n_res) == widths
    kind = cuda_solver.coloring_kind(plan.coloring)
    if name in ("banded", "banded_dl"):
        assert kind == "multi" and plan.coloring.n_colors == 2
    elif name.startswith("banded"):
        assert kind is None
    G = cuda_solver.GENERATED
    assert cuda_solver.k2_refusal(G, plan.spec, plan.n_res,
                                  plan.coloring) == ""
    kp = cuda_solver.k2_launch_plan(
        10_000, plan.spec.dims, plan.n_res, 8, G, kind,
        cuda_solver.SOLVER_CODES[topts.solver_type], plan.spec.params)
    assert (kp.path, kp.S) == ("warp", 32)


def test_banded_coloring_on_equals_off(solved):
    """The 2-color probing gives the port's fused solve at d = 72 bit for
    bit what per-dimension sweeps give (tests/test_fused.py:445)."""
    _, (xg, outg), *_ = solved("banded")
    _, (x_off, out_off), *_ = solved("banded_off")
    assert torch.equal(x_off, xg)
    assert torch.equal(out_off.num_iters, outg.num_iters)
    assert torch.equal(out_off.stop_reason, outg.stop_reason)
