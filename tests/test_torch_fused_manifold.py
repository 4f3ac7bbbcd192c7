"""The fused path on residuals over manifold parameters of the SE3 kind —
``chip_smoke.py`` phase 22's SE3 pose prior (LM and the dogleg), its
{SE3, bias} pytree and the point-to-point SE3 fit with and without Huber
whitening (``tests/torch_manifold_cases.py``) — against the JAX package's
fused Pallas kernel in interpret mode, in float64, per instance: the
port's ``batched_optimize`` runs ``fused_solve_plain`` here, the twin
that the generated K2 family, traced through the retraction, is held to on
the card (tests/test_torch_codegen_manifold.py, phase 22).  The inputs
are drawn with numpy and built by the JAX package's manifolds; the states
cross by ``interop``.  Tolerances are ``_assert_parity``'s
(tests/test_fused.py:51: x and the cost to rtol 1e-5, the gradient to
1e-4, the same success and convergence classes, iterations within one).
The SO3, SE23 and SEn3 cases are in tests/test_torch_fused_manifold_so3.py
(the JAX kernel's compile takes ~10-30 s a case, so the cases are split
over two files)."""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import torch_manifold_cases as cases
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.ops import cuda_solver

torch.set_num_threads(1)

B = 8
NAMES = ("se3_prior", "se3_bias", "icp_huber", "icp_plain")
#: each case's seed
SEEDS = {n: 40 + k for k, n in enumerate(cases.NAMES)}


@pytest.fixture(scope="module")
def solved():
    """Each case solved once by the JAX kernel and by the port."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = cases.solve_both(name, B, SEEDS[name])
        return cache[name]
    return get


def assert_parity(ref, got):
    """tests/test_fused.py:51 ``_assert_parity`` per instance, and every
    instance succeeding."""
    (xr, outr), (xg, outg) = ref, got
    np.testing.assert_allclose(cases.flat(xg), cases.flat(xr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= 1
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outg.final_grad.numpy(),
                               np.asarray(outr.final_grad), rtol=1e-4,
                               atol=1e-5)
    assert bool(torch.all(outg.succeeded()))


def check_family(name, tx, td, topts):
    """On the card the case takes a generated family: ``k2_envelope`` on
    the example gives the case's (P, D, n_res), K2 plans it one instance a
    thread with E = max(P, D, n_res), and the family's data row packs the
    case's data."""
    x_ex, d_ex = pytree.tree_map(lambda a: a[0], (tx, td))
    fid, fam, why = cuda_solver.k2_envelope(cases.residual(name), x_ex,
                                            d_ex)
    assert fid == cuda_solver.GENERATED, why
    P, D, n_res = cases.WIDTHS[name]
    assert (fam.p, fam.d, fam.n_res) == (P, D, n_res)
    assert mf.tangent_spec(x_ex).params == P
    plan = cuda_solver.fused_plan(topts, "residuals", x_ex,
                                  residual_fn=cases.residual(name),
                                  data_example=d_ex)
    kind = cuda_solver.coloring_kind(plan.coloring)
    assert cuda_solver.k2_supports(fid, D, n_res, kind, P)
    kp = cuda_solver.k2_launch_plan(10_000, D, n_res, 8, fid, kind, 1, P)
    assert (kp.path, kp.S, kp.E) == ("segment", 1, max(P, D, n_res))
    row = fam.pack_data(td, B, torch.float64, torch.device("cpu"))
    assert tuple(row.shape) == (B, fam.q)


@pytest.mark.parametrize("name", NAMES)
def test_port_fused_matches_jax_kernel(name, solved):
    """The port's fused path against the JAX kernel per instance."""
    ref, got, *_ = solved(name)
    assert_parity(ref, got)


@pytest.mark.parametrize("name", NAMES)
def test_generated_family_of_each_case(name, solved):
    """The case's generated family and K2 plan (:func:`check_family`)."""
    _, _, tx, td, topts = solved(name)
    check_family(name, tx, td, topts)


def test_dogleg_se3_prior_matches_jax_kernel():
    """The SE3 pose prior with the dogleg (phase 22's third se3_prior
    cell) against the JAX kernel, stop reasons equal too."""
    ref, got, *_ = cases.solve_both("se3_prior", B, 7, dogleg=True)
    assert_parity(ref, got)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
