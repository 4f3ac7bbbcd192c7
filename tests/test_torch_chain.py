"""The chain solver and the pose graph of tinyopt_tpu_torch — ``chain.py``
(``ChainSystem``, ``chain_system``, ``chain_optimize``,
``chain_marginals``), ``models/pose_graph.py`` and
``interop.pose_graph_data_from_numpy`` — against the JAX package on the
same graphs (``make_pose_graph`` draws from numpy in the JAX package's
order), in float64: tests/test_chain.py and tests/test_pose_graph.py.
Solves are held with tests/test_fused.py:51's tolerances (rtol 1e-5 on x,
cost and gradient, iterations within 1, the same success and convergence
class) by both tridiagonal methods; marginals and covariances to 1e-8;
the generated graph to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu.chain import chain_optimize as j_chain_optimize
from tinyopt_tpu.models import pose_graph as jpg

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.chain import ChainSystem, chain_system
from tinyopt_tpu_torch.interop import (pose_graph_data_from_numpy,
                                       se3_from_numpy)
from tinyopt_tpu_torch.manifolds import SE3
from tinyopt_tpu_torch.models import pose_graph as tpg
from tinyopt_tpu_torch.ops import tridiag
from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc

torch.set_num_threads(1)

F64 = torch.float64
SOLVERS = ("LEVENBERG_MARQUARDT", "GAUSS_NEWTON", "DOGLEG")


def _leaves(x):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(x)]


def _tleaves(x):
    return [a.numpy() for a in mf.tree_leaves_sorted(x)]


def _assert_parity(ref, got, rtol=1e-5, atol=1e-6, iter_slack=1):
    """tests/test_fused.py:51's rule, one instance or a batch."""
    (xr, outr), (xg, outg) = ref, got
    for a, b in zip(_leaves(xr), _tleaves(xg)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    assert np.array_equal(np.asarray(outr.succeeded()),
                          outg.succeeded().numpy())
    assert np.array_equal(np.asarray(outr.converged()),
                          outg.converged().numpy())
    assert np.max(np.abs(np.asarray(outr.num_iters)
                         - outg.num_iters.numpy())) <= iter_slack
    assert np.max(np.abs(np.asarray(outr.num_failures)
                         - outg.num_failures.numpy())) == 0
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(outg.final_grad.numpy(),
                               np.asarray(outr.final_grad),
                               rtol=1e-4, atol=1e-5)


def _port_graph(jdata, jx0):
    data = pose_graph_data_from_numpy(*_leaves(jdata), device="cpu",
                                      dtype=F64)
    x0 = se3_from_numpy(*_leaves(jx0), device="cpu", dtype=F64)
    return data, x0


@pytest.fixture(scope="module")
def graph12():
    """The 12-pose / 4-loop graph of tests/test_chain.py::test_gn_and_dogleg
    and the JAX package's solves of it, one a solver type."""
    jdata, jx0, _ = jpg.make_pose_graph(n_poses=12, extra_loops=4,
                                        noise=1e-3, init_noise=0.05, seed=5)
    runs = {st: jpg.pose_graph_optimize(
        jx0, jdata, jto.Options(solver_type=getattr(jto.SolverType, st)))
        for st in SOLVERS}
    return jdata, jx0, runs


@pytest.fixture(scope="module")
def port_lm(graph12):
    """The port's LM solve of the fixture's graph, by "auto" (the scan on
    the CPU), and the tridiagonal solves it took by method."""
    data, x0 = _port_graph(*graph12[:2])
    before = dict(tridiag.SOLVES)
    got = tpg.pose_graph_optimize(x0, data)
    return got, {k: tridiag.SOLVES[k] - before[k] for k in before}


@pytest.mark.parametrize("seed", [5, 8])
def test_make_pose_graph_matches_reference(graph12, seed):
    """The fixture's graph (seed 5) and one more of its size, whose JAX
    ops are compiled already."""
    if seed == 5:
        jd, jx0 = graph12[:2]
        jtrue = None
    else:
        jd, jx0, jtrue = jpg.make_pose_graph(12, 4, noise=1e-3,
                                             init_noise=0.05, seed=seed)
    td, tx0, ttrue = tpg.make_pose_graph(12, 4, noise=1e-3, init_noise=0.05,
                                         seed=seed, device="cpu")
    np.testing.assert_array_equal(td.edges.numpy(), np.asarray(jd.edges))
    pairs = list(zip(_leaves(jd)[1:] + _leaves(jx0),
                     _tleaves(td)[1:] + _tleaves(tx0)))
    if jtrue is not None:
        pairs += list(zip(_leaves(jtrue), _tleaves(ttrue)))
    for a, b in pairs:
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    carried, _ = _port_graph(jd, jx0)
    for a, b in zip(_leaves(jd), _tleaves(carried)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(
        tpg.pose_graph_residuals(tx0, td).numpy(),
        np.asarray(jpg.pose_graph_residuals(jx0, jd)), rtol=1e-12,
        atol=1e-12)


@pytest.mark.parametrize("method", ["scan", "cr"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_pose_graph_optimize_parity(graph12, solver, method):
    jdata, jx0, runs = graph12
    data, x0 = _port_graph(jdata, jx0)
    before = dict(tridiag.SOLVES)
    got = tpg.pose_graph_optimize(
        x0, data, to.Options(solver_type=getattr(to.SolverType, solver)),
        method=method)
    other = "cr" if method == "scan" else "scan"
    assert tridiag.SOLVES[method] > before[method]
    assert tridiag.SOLVES[other] == before[other]
    _assert_parity(runs[solver], got)
    assert bool(got[1].converged()) and float(got[1].final_cost.cost) < 1e-3


def test_auto_takes_scan_on_the_cpu(graph12, port_lm):
    got, solves = port_lm
    assert solves["scan"] > 0 and solves["cr"] == 0
    _assert_parity(graph12[2]["LEVENBERG_MARQUARDT"], got)


def test_pure_chain_no_loops():
    jd, jx0, _ = jpg.make_pose_graph(n_poses=10, extra_loops=0, noise=0.0,
                                     init_noise=0.05, seed=0)
    ref = jpg.pose_graph_optimize(jx0, jd)
    data, x0 = _port_graph(jd, jx0)
    x, out = tpg.pose_graph_optimize(x0, data)
    _assert_parity(ref, (x, out))
    # stops at min_error (1e-12); the noise-free optimum is exact
    assert bool(out.converged()) and float(out.final_cost.cost) < 1e-11
    assert out.final_hessian.U.shape == (10, 6, 0)


def _spring(rng, N, d):
    target = rng.normal(size=(N - 1, d))
    edges = np.stack([np.arange(N - 1), np.arange(1, N)], 1)
    edges = np.concatenate([edges, [[0, N - 1]]])
    e_data = np.concatenate([target, rng.normal(size=(1, d))])
    return edges, e_data


def test_euclidean_blocks_and_errors():
    """chain_optimize on plain (N, d) Euclidean blocks, a spring chain with
    one long-range loop, against the JAX package's chain_optimize and the
    port's dense solve; then the edge-validation, method and first-order
    errors."""
    N, d = 20, 2
    edges, e_data = _spring(np.random.default_rng(7), N, d)

    def edge_fn(a, b, t):
        return (b - a) - t

    def anchor(a, _):
        return a

    ref = j_chain_optimize(jnp.zeros((N, d)), edge_fn, edges,
                           jnp.asarray(e_data), unary_fn=anchor,
                           unary_nodes=[0], unary_data=jnp.zeros((1, d)))
    x0 = torch.zeros((N, d), dtype=F64)
    td = torch.from_numpy(e_data)
    x, out = to.chain_optimize(x0, edge_fn, edges, td, unary_fn=anchor,
                               unary_nodes=[0],
                               unary_data=torch.zeros((1, d), dtype=F64))
    _assert_parity(ref, (x, out))
    assert bool(out.converged())

    def full_res(x):
        r = torch.func.vmap(edge_fn)(x[edges[:, 0]], x[edges[:, 1]], td)
        return torch.cat([r.reshape(-1), x[0]])

    xd, _ = to.optimize(x0, full_res)
    np.testing.assert_allclose(x.numpy(), xd.numpy(), rtol=1e-9, atol=1e-9)

    with pytest.raises(ValueError, match="self-edges"):
        to.chain_optimize(x0, edge_fn, np.asarray([[2, 2]]), td[:1])
    with pytest.raises(ValueError, match="edges must be"):
        to.chain_optimize(x0, edge_fn, np.asarray([0, 1, 2]), td[:1])
    with pytest.raises(ValueError, match="method"):
        to.chain_optimize(x0, edge_fn, edges, td, method="dense")
    for st in (to.SolverType.ADAM, to.SolverType.GRADIENT_DESCENT):
        with pytest.raises(ValueError, match="Gauss-Newton/LM"):
            to.chain_optimize(x0, edge_fn, edges, td,
                              to.Options(solver_type=st))


@pytest.mark.parametrize("method", ["scan", "cr"])
def test_batched_chains_match_jax_vmap(method):
    """Three chains in one batch (edge data (B, E, d)) against the JAX
    package's vmap of chain_optimize (tests/test_chain.py:223-246)."""
    rng = np.random.default_rng(9)
    N, d, Bb = 8, 2, 3
    targets = rng.normal(size=(Bb, N - 1, d))
    edges = np.stack([np.arange(N - 1), np.arange(1, N)], 1)

    def edge_fn(a, b, t):
        return (b - a) - t

    def solve_one(tgt):
        return j_chain_optimize(
            jnp.zeros((N, d)), edge_fn, edges, tgt,
            unary_fn=lambda a, _: a, unary_nodes=[0],
            unary_data=jnp.zeros((1, d)), jit=False)

    ref = jax.vmap(solve_one)(jnp.asarray(targets))
    x0 = torch.zeros((N, d), dtype=F64)
    spec = mf.tangent_spec(x0)
    acc, ev, n_res, propose = chain_system(
        x0, edge_fn, edges, torch.from_numpy(targets), lambda a, _: a, [0],
        torch.zeros((Bb, 1, d), dtype=F64), spec, method=method)
    assert n_res == (N - 1) * d + d
    xb, out = optimize_from_acc(x0.reshape(1, -1).expand(Bb, -1), acc, ev,
                                to.Options(), spec, propose=propose)
    _assert_parity(ref, (xb.reshape(Bb, N, d), out))
    expect = np.concatenate([np.zeros((Bb, 1, d)),
                             np.cumsum(targets, axis=1)], axis=1)
    np.testing.assert_allclose(xb.reshape(Bb, N, d).numpy(), expect,
                               atol=1e-6)
    assert isinstance(out.final_hessian, ChainSystem)
    assert out.final_hessian.D.shape == (Bb, N, d, d)


@pytest.mark.parametrize("rescaled", [False, True])
def test_pose_graph_marginals(graph12, port_lm, rescaled):
    """At the JAX package's LM solution, carried across: the marginals
    against JAX's, the dense inverse's diagonal blocks and, for the LM run
    of each package, ``Output.covariance()``."""
    jdata, jx0, runs = graph12
    jx, jout = runs["LEVENBERG_MARQUARDT"]
    data, _ = _port_graph(jdata, jx0)
    x = se3_from_numpy(*_leaves(jx), device="cpu", dtype=F64)
    marg = tpg.pose_graph_marginals(x, data, rescaled=rescaled)
    ref = np.asarray(jpg.pose_graph_marginals(jx, jdata, rescaled=rescaled))
    np.testing.assert_allclose(marg.numpy(), ref, rtol=1e-8, atol=1e-12)
    out = port_lm[0][1]
    cov = out.covariance(rescaled=rescaled)
    np.testing.assert_allclose(
        cov.numpy(), np.asarray(jout.covariance(rescaled=rescaled)),
        rtol=1e-8, atol=1e-12)
    N, d = 12, 6
    H = out.final_hessian
    np.testing.assert_allclose(
        H.to_dense().numpy(),
        torch.func.vmap(H.matvec, in_dims=1, out_dims=1)(
            torch.eye(N * d, dtype=F64)).numpy(), rtol=1e-12, atol=1e-12)
    if not rescaled:
        blocks = torch.stack([cov[i * d:(i + 1) * d, i * d:(i + 1) * d]
                              for i in range(N)])
        np.testing.assert_allclose(H.marginals().numpy(), blocks.numpy(),
                                   rtol=1e-8, atol=1e-12)


def test_marginals_nan_without_gauge():
    """No anchor: H is singular along the gauge, the marginals NaN."""
    jdata, jx0, _ = jpg.make_pose_graph(n_poses=6, extra_loops=2, seed=1)
    data, x0 = _port_graph(jdata, jx0)
    marg = to.chain_marginals(x0, tpg.pose_graph_edge_fn,
                              data.edges.numpy(), (data.meas_q, data.meas_t))
    assert torch.isnan(marg).all()


def test_scale_convergence_chi2():
    """500 poses, 30 loops, σ = 1e-3 (tests/test_chain.py:156-170), on the
    port alone: converges to the DOF-predicted χ² level."""
    n, loops, sig = 500, 30, 1e-3
    data, x0, _ = tpg.make_pose_graph(n, loops, noise=sig, init_noise=0.05,
                                      seed=3, device="cpu")
    x, out = tpg.pose_graph_optimize(x0, data)
    assert bool(out.converged()), int(out.stop_reason)
    dof = 6 * int(data.edges.shape[0]) + 6 - 6 * n
    assert float(out.final_cost.cost) < 3.0 * max(dof, 1) * sig ** 2
    r0 = tpg.pose_graph_residuals(x0, data)
    assert float(out.final_cost.cost) < 1e-3 * float(torch.sum(r0 * r0))


def test_matfree_pose_graph():
    """The pose-graph residuals through GN-CG (tests/test_pose_graph.py:50,
    at 6 poses and 20 CG iterations instead of 30 and 120: the port's
    matrix-free products through torch.func cost ~0.1 s each on the CPU
    at 10 poses): the noise-free poses recovered."""
    data, x0, true = tpg.make_pose_graph(n_poses=6, extra_loops=2, seed=6,
                                         device="cpu")
    x, out = to.matfree_optimize(
        x0, lambda p: tpg.pose_graph_residuals(p, data),
        to.Options(max_iters=100, max_consec_failures=0), cg_iters=20)
    assert bool(out.succeeded())
    err = torch.linalg.vector_norm((true.inverse() @ x).log(), dim=-1)
    assert float(err.max()) < 1e-5


def test_chain_system_pytree():
    """The loop selects a ChainSystem per instance leaf by leaf."""
    H = ChainSystem(torch.ones(2, 3, 2, 2), torch.ones(2, 2, 2, 2),
                    torch.ones(2, 3, 2, 1), torch.ones(2, 3, 2))
    leaves, spec = pytree.tree_flatten(H)
    assert len(leaves) == 4
    assert isinstance(pytree.tree_unflatten(leaves, spec), ChainSystem)
    assert H.dims == 6 and H.shape == (6, 6)
    assert isinstance(SE3.identity(F64, batch=(3,)), SE3)
