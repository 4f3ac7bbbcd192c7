"""The fused path on the residuals that, on the card, only a generated K2
family takes (``ops/residual_codegen.py``) — the JAX fused suite's
Huber-whitened prior, the residual closed over constants, the dict
parameters and the 2-color banded residuals (tests/test_fused.py) —
against the JAX package's fused Pallas kernel in interpret mode, in
float64, per instance: the port's ``batched_optimize`` runs
``fused_solve_plain`` here, the twin the generated K2 is held to on the card
(tests/test_torch_codegen.py, ``chip_smoke.py`` phase 21).  Tolerances are
``_assert_parity``'s (tests/test_fused.py:51: rtol 1e-5, one iteration of
slack, the same success and convergence class), or the JAX test's own
wider ones where it has them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.losses.robust_norms import huber as j_huber
from tinyopt_tpu.losses.robust_norms import robust_whiten as j_whiten
from tinyopt_tpu.models.problems import PriorProblem as JPrior
from tinyopt_tpu.ops.pallas_solver import fused_batched_solver as j_fused

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import options_from_reference
from tinyopt_tpu_torch.losses.robust_norms import huber, robust_whiten
from tinyopt_tpu_torch.models.problems import PriorProblem
from tinyopt_tpu_torch.ops import cuda_solver

torch.set_num_threads(1)


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


def _j_robust_prior(x, data):
    r = (x - data.y) * data.inv_std
    return jax.vmap(lambda ri: j_whiten(ri[None], j_huber, 0.5))(r)


def _t_robust_prior(x, data):
    r = (x - data.y) * data.inv_std
    return torch.func.vmap(lambda ri: robust_whiten(ri[None], huber, 0.5))(r)


def _j_no_data(x):
    return jnp.stack([x[0] * x[0] - 2.0, 0.5 * (x[0] - 1.0)])


def _t_no_data(x):
    return torch.stack([x[0] * x[0] - 2.0, 0.5 * (x[0] - 1.0)])


def _j_dict(x, data):
    return jnp.concatenate([x["a"] - data["ta"], 2.0 * (x["b"] - data["tb"])])


def _t_dict(x, data):
    return torch.cat([x["a"] - data["ta"], 2.0 * (x["b"] - data["tb"])])


def _j_banded(x):
    return jnp.concatenate([x[:-1] - 0.5 * x[1:], x - 1.0])


def _t_banded(x):
    return torch.cat([x[:-1] - 0.5 * x[1:], x - 1.0])


def _j_banded_data(x, y):
    return jnp.concatenate([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


def _t_banded_data(x, y):
    return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


def _inputs(name):
    """(JAX residual, port residual, options, x0 and data as numpy pytrees)
    of a named case, the sizes of tests/test_fused.py, drawn with numpy."""
    rng = np.random.default_rng(17)
    if name == "robust_prior":
        y = rng.uniform(-1, 1, (24, 6))
        inv = 1.0 / rng.uniform(0.1, 1.1, (24, 6))
        return (_j_robust_prior, _t_robust_prior, _opts(),
                rng.uniform(-1, 1, (24, 6)), ("prior", y, inv))
    if name == "no_data":
        return (_j_no_data, _t_no_data, _opts(),
                np.linspace(0.5, 3.0, 12)[:, None], None)
    if name == "dict":
        return (_j_dict, _t_dict, _opts(),
                {"a": rng.normal(size=(10, 3)), "b": rng.normal(size=(10, 2))},
                {"ta": np.ones((10, 3)), "tb": np.full((10, 2), 0.5)})
    if name == "banded":
        return (_j_banded, _t_banded, _opts(),
                1.0 + 0.3 * rng.normal(size=(16, 8)), None)
    if name == "banded_dogleg":
        return (_j_banded_data, _t_banded_data, _opts(solver_type=jto.DogLeg),
                np.zeros((12, 6)), rng.normal(size=(12, 6)))
    raise KeyError(name)


def _jax_tree(a):
    if a is None:
        return None
    if isinstance(a, tuple) and a[0] == "prior":
        return JPrior(jnp.asarray(a[1]), jnp.asarray(a[2]))
    return jax.tree_util.tree_map(jnp.asarray, a)


def _torch_tree(a):
    if a is None:
        return None
    if isinstance(a, tuple) and a[0] == "prior":
        return PriorProblem(torch.as_tensor(a[1]), torch.as_tensor(a[2]))
    if isinstance(a, dict):
        return {k: torch.as_tensor(v) for k, v in a.items()}
    return torch.as_tensor(a)


CASES = ("robust_prior", "no_data", "dict", "banded", "banded_dogleg")


@pytest.fixture(scope="module")
def solved():
    """Each case solved once by the JAX kernel in interpret mode and by the
    port's fused path (float64)."""
    cache = {}

    def get(name):
        if name not in cache:
            jfn, tfn, opts, x0, data = _inputs(name)
            jx, jd = _jax_tree(x0), _jax_tree(data)
            x_ex = jax.tree_util.tree_map(lambda a: a[0], jx)
            d_ex = (None if jd is None
                    else jax.tree_util.tree_map(lambda a: a[0], jd))
            solve = j_fused(jfn, opts, x_ex, d_ex, interpret=True)
            ref = solve(jx) if jd is None else solve(jx, jd)
            tx, td = _torch_tree(x0), _torch_tree(data)
            got = to.batched_optimize(tx, tfn, options_from_reference(opts),
                                      data_batch=td)
            cache[name] = (ref, got, tfn, tx, td,
                           options_from_reference(opts))
        return cache[name]
    return get


def _leaves(x):
    if isinstance(x, dict):
        return [np.asarray(x[k]) for k in sorted(x)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", CASES)
def test_port_fused_matches_jax_kernel(name, solved):
    """The port's fused path against the JAX kernel per instance: x and the
    cost to rtol 1e-5, the gradient to 1e-4, the same success and
    convergence classes, iterations within one and failures equal — but
    where tests/test_fused.py allows more: the banded dogleg two
    iterations of slack (:149), the banded LM one failure (:466 holds x
    and the classes only; here two of the 16 instances count one
    rejection more or less, x within 1e-8)."""
    (xr, outr), (xg, outg), *_ = solved(name)
    rtol, atol = 1e-5, 1e-6
    slack, fail_slack = {"banded": (1, 1), "banded_dogleg": (2, 0)}.get(
        name, (1, 0))
    for a, b in zip(_leaves(xg), _leaves(xr)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= slack
    assert np.max(np.abs(outg.num_failures.numpy()
                         - np.asarray(outr.num_failures))) <= fail_slack
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(outg.final_grad.numpy(),
                               np.asarray(outr.final_grad), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name,d,n_res,coloring", [
    ("robust_prior", 6, 6, "identity"), ("no_data", 1, 2, "multi"),
    ("dict", 5, 5, "identity"), ("banded", 8, 15, "multi"),
    ("banded_dogleg", 6, 6, "multi")])
def test_generated_family_of_each_case(name, d, n_res, coloring, solved):
    """On the card each case takes a generated family: ``k2_envelope`` on
    the example gives one of the expected widths, the plan's coloring is
    the JAX kernel's (an identity, one color, two colors), and K2 plans it
    one instance a thread; the family's data row packs the case's data."""
    _, _, tfn, tx, td, opts = solved(name)
    x_ex = (tx[0] if not isinstance(tx, dict)
            else {k: v[0] for k, v in tx.items()})
    d_ex = None if td is None else torch.utils._pytree.tree_map(
        lambda a: a[0], td)
    fid, fam, why = cuda_solver.k2_envelope(tfn, x_ex, d_ex)
    assert fid == cuda_solver.GENERATED, why
    assert (fam.d, fam.n_res) == (d, n_res)
    plan = cuda_solver.fused_plan(opts, "residuals", x_ex, residual_fn=tfn,
                                  data_example=d_ex)
    assert cuda_solver.coloring_kind(plan.coloring) == coloring
    assert cuda_solver.k2_supports(fid, d, n_res, coloring)
    kp = cuda_solver.k2_launch_plan(10_000, d, n_res, 8, fid, coloring,
                                    cuda_solver.SOLVER_CODES[opts.solver_type])
    assert (kp.path, kp.S, kp.E) == ("segment", 1, max(d, n_res))
    B = len(next(iter(torch.utils._pytree.tree_leaves(tx))))
    row = fam.pack_data(td, B, torch.float64, torch.device("cpu"))
    assert (row is None) == (td is None)
    if row is not None:
        assert tuple(row.shape) == (B, fam.q)


def test_banded_coloring_on_equals_off(solved):
    """tests/test_fused.py:445's strongest check on the port: the 2-color
    probing gives the fused solve bit for bit what per-dimension sweeps
    give."""
    _, (xg, outg), tfn, tx, td, opts = solved("banded")
    import dataclasses
    off = dataclasses.replace(opts, hessian=dataclasses.replace(
        opts.hessian, diag_coloring="off"))
    x_off, out_off = to.batched_optimize(tx, tfn, off)
    assert torch.equal(x_off, xg)
    assert torch.equal(out_off.num_iters, outg.num_iters)
    assert torch.equal(out_off.stop_reason, outg.stop_reason)
