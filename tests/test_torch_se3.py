"""The flagship SE(3) pose refinement on tinyopt_tpu_torch against the JAX
package: the Jacobian through the retraction, the loop ("cholesky" and
"cg"; LM, GN and DogLeg), the fused twin against the Pallas kernel in
interpret mode (the SE3 family and a mixed {SE3, bias} pytree), K2's
launch plans for the SE3 family, and — on a CUDA device — K2's SE3 family
against its twin."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu.diff.auto import residual_jacobian as j_residual_jacobian
from tinyopt_tpu.manifolds import SE3 as JSE3
from tinyopt_tpu.manifolds import SO3 as JSO3
from tinyopt_tpu.models.se3_refinement import SE3RefinementData as JData
from tinyopt_tpu.models.se3_refinement import make_se3_refinement as j_make
from tinyopt_tpu.models.se3_refinement import se3_residual as j_se3_residual
from tinyopt_tpu.ops.coloring import detect_diag_coloring as j_detect
from tinyopt_tpu.ops.pallas_solver import fused_batched_solver as j_fused
from tinyopt_tpu.parallel.batched import batched_solver as j_batched_solver

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.diff.auto import residual_jacobian
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       se3_from_numpy,
                                       se3_refinement_data_from_numpy)
from tinyopt_tpu_torch.manifolds import SE3, SO3
from tinyopt_tpu_torch.models.se3_refinement import (SE3RefinementData,
                                                     make_se3_refinement,
                                                     se3_residual)
from tinyopt_tpu_torch.ops import cuda_solver
from tinyopt_tpu_torch.ops.coloring import detect_diag_coloring
from tinyopt_tpu_torch.output import map_output

torch.set_num_threads(1)

F64 = torch.float64


def _options(solver="cholesky", **kw):
    """``bench_se3``'s options (benchmarks/run_benchmarks.py:240-242) with
    the given solver."""
    kw.setdefault("max_iters", 10)
    kw.setdefault("max_consec_failures", 3)
    hk = dict(save_last=False, solver=solver, carry_system=False)
    hk.update(kw.pop("hessian", {}))
    return jto.Options(hessian=jto.HessianOptions(**hk), **kw)


def _jax_problem(B, K, seed, noise=1e-3):
    """JAX's instances (float64) and the same values on the port."""
    data, x0, true = j_make(B, K, noise=noise, dtype=jnp.float64, seed=seed)
    tdata = se3_refinement_data_from_numpy(data.points, data.targets,
                                           device="cpu", dtype=F64)
    tx0 = se3_from_numpy(x0.rotation.wxyz, x0.translation, device="cpu",
                         dtype=F64)
    return (data, x0), (tdata, tx0), true


def _flat(x):
    """Every stored value of a (batched) pose pytree, (B, P) numpy."""
    leaves = (pytree.tree_leaves(x) if isinstance(x, SE3)
              else jax.tree_util.tree_leaves(x))
    return np.concatenate([np.asarray(a).reshape(np.shape(a)[0], -1)
                           for a in leaves], axis=-1)


def assert_parity(ref, got, rtol=1e-5, atol=1e-6, iter_slack=1,
                  fail_slack=0, grad_rtol=1e-4):
    """tests/test_fused.py:51 ``_assert_parity`` on pose pytrees."""
    (xr, outr), (xg, outg) = ref, got
    np.testing.assert_allclose(_flat(xg), _flat(xr), rtol=rtol, atol=atol)
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


def test_residual_jacobian_matches_reference():
    """J of δ ↦ r(T ⊞ δ) at δ = 0 on ``se3_residual``, one instance."""
    (jdata, jx0), (tdata, tx0), _ = _jax_problem(3, 5, 1)
    for b in range(3):
        jx = jax.tree_util.tree_map(lambda a: a[b], jx0)
        jd = jax.tree_util.tree_map(lambda a: a[b], jdata)
        rr, Jr = j_residual_jacobian(lambda T: j_se3_residual(T, jd), jx)
        tx = pytree.tree_map(lambda a: a[b], tx0)
        td = SE3RefinementData(*(a[b] for a in tdata))
        r, J = residual_jacobian(lambda T: se3_residual(T, td), tx)
        assert J.shape == (15, 6)
        np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(J.numpy(), np.asarray(Jr), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
@pytest.mark.parametrize("method", ["lm", "gn", "dogleg"])
def test_loop_matches_reference(solver, method):
    """The batch-native loop on the flagship's data (B = 32, K = 12) against
    the JAX package's vmap of its loop, per instance."""
    kw = {"gn": dict(solver_type=jto.GaussNewton),
          "dogleg": dict(solver_type=jto.DogLeg)}.get(method, {})
    opts = _options(solver, **kw)
    (jdata, jx0), (tdata, tx0), _ = _jax_problem(32, 12, 2)
    solve = jax.jit(j_batched_solver(
        j_se3_residual, opts, "residuals",
        jax.tree_util.tree_map(lambda a: a[0], jx0),
        jax.tree_util.tree_map(lambda a: a[0], jdata)))
    ref = solve(jx0, jdata)
    got = to.batched_optimize(tx0, se3_residual,
                              options_from_reference(opts), data_batch=tdata)
    assert isinstance(got[0], SE3)
    assert got[1].final_grad.shape == (32, 6)
    assert_parity(ref, got)
    assert bool(torch.all(got[1].converged()))


@pytest.fixture(scope="module")
def pallas_refs():
    """The JAX fused kernel in interpret mode (tests/test_fused.py runs it
    so on the CPU), once for the module: the SE3 family's problem (B = 8,
    K = 4) and the mixed {SE3, bias} pytree of tests/test_fused.py:338-364
    (B = 8), each beside the inputs the port gets."""
    opts = _options("fused")
    (jdata, jx0), (tdata, tx0), _ = _jax_problem(8, 4, 3)
    se3 = j_fused(j_se3_residual, opts,
                  jax.tree_util.tree_map(lambda a: a[0], jx0),
                  jax.tree_util.tree_map(lambda a: a[0], jdata),
                  interpret=True)(jx0, jdata)
    rng = np.random.default_rng(9)
    jT = JSE3.exp(jnp.asarray(0.1 * rng.normal(size=(8, 6))))
    bias = rng.normal(size=(8, 2))
    tgt = rng.normal(size=(8, 2))
    jx = {"T": jT, "bias": jnp.asarray(bias)}

    def jres(x, d):
        return jnp.concatenate([x["T"].log(), 2.0 * (x["bias"] - d)])

    mixed = j_fused(jres, opts, jax.tree_util.tree_map(lambda a: a[0], jx),
                    jnp.asarray(tgt[0]), interpret=True)(jx, jnp.asarray(tgt))
    tx = {"T": se3_from_numpy(jT.rotation.wxyz, jT.translation,
                              device="cpu", dtype=F64),
          "bias": torch.tensor(bias)}
    return dict(opts=opts, se3=(se3, tx0, tdata),
                mixed=(mixed, tx, torch.tensor(tgt)))


def test_fused_twin_matches_pallas_kernel_se3(pallas_refs):
    """K2's twin on the SE3 family's problem: the retraction branch of the
    JAX kernel (``ret_flat``), P = 7 and D = 6, no coloring (J is dense)."""
    ref, tx0, tdata = pallas_refs["se3"]
    topts = options_from_reference(pallas_refs["opts"])
    x_ex = pytree.tree_map(lambda a: a[0], tx0)
    d_ex = SE3RefinementData(*(a[0] for a in tdata))
    plan = cuda_solver.fused_plan(topts, "residuals", x_ex,
                                  residual_fn=se3_residual, data_example=d_ex)
    assert plan is not None and plan.coloring is None
    assert (plan.spec.params, plan.spec.dims, plan.n_res) == (7, 6, 12)
    got = to.batched_optimize(tx0, se3_residual, topts, data_batch=tdata)
    assert cuda_solver.fused_solve.launches == 0
    assert_parity(ref, got)
    np.testing.assert_array_equal(got[1].stop_reason.numpy(),
                                  np.asarray(ref[1].stop_reason))
    assert bool(torch.all(got[1].succeeded()))


def test_fused_twin_matches_pallas_kernel_mixed_pytree(pallas_refs):
    """tests/test_fused.py:338-364 on the twin: an SE3 pose beside a
    Euclidean leaf, P = 9 stored values and D = 8 tangent dimensions."""
    ref, tx, tgt = pallas_refs["mixed"]
    topts = options_from_reference(pallas_refs["opts"])

    def res(x, d):
        return torch.cat([x["T"].log(), 2.0 * (x["bias"] - d)])

    got = to.batched_optimize(tx, res, topts, data_batch=tgt)
    (xr, outr), (xg, outg) = ref, got
    np.testing.assert_allclose(xg["bias"].numpy(), np.asarray(xr["bias"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xg["T"].translation.numpy(),
                               np.asarray(xr["T"].translation), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(xg["T"].rotation.wxyz.numpy(),
                               np.asarray(xr["T"].rotation.wxyz), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(xg["bias"].numpy(), tgt.numpy(), atol=1e-3)
    np.testing.assert_array_equal(outg.stop_reason.numpy(),
                                  np.asarray(outr.stop_reason))
    np.testing.assert_array_equal(outg.num_iters.numpy(),
                                  np.asarray(outr.num_iters))
    assert bool(torch.all(outg.succeeded()))


def test_flagship_batched_refinement_converges():
    """tests/test_se3.py:180-198 on the port: 32 noise-free instances of
    12 points, default options, the true poses recovered."""
    data, x0, true = make_se3_refinement(32, n_points=12, noise=0.0,
                                         dtype=F64, seed=7, device="cpu")
    x, out = to.batched_optimize(x0, se3_residual, to.Options(),
                                 data_batch=data)
    assert bool(torch.all(out.succeeded()))
    err_rot = torch.linalg.vector_norm(
        (x.rotation @ SO3(true.rotation.wxyz).inverse()).log(), dim=-1)
    err_t = torch.linalg.vector_norm(x.translation - true.translation,
                                     dim=-1)
    assert float(err_rot.max()) < 1e-5 and float(err_t.max()) < 1e-5


def test_single_pose_prior_matches_reference():
    """README §Manifolds: ``optimize(SE3.identity(), lambda T: (prior_inv
    @ T).log())``, one instance, against the JAX package."""
    d = np.array([0.3, -0.2, 0.5, 0.4, -0.6, 0.2])
    jprior = JSE3.exp(jnp.asarray(d))
    jinv = jprior.inverse()
    jx, jout = jto.optimize(JSE3.identity(jnp.float64),
                            lambda T: (jinv @ T).log())
    prior = SE3.exp(torch.tensor(d))
    inv = prior.inverse()
    x, out = to.optimize(SE3.identity(F64), lambda T: (inv @ T).log())
    assert isinstance(x, SE3) and x.translation.shape == (3,)
    np.testing.assert_allclose(x.rotation.wxyz.numpy(),
                               np.asarray(jx.rotation.wxyz), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(x.translation.numpy(),
                               np.asarray(jx.translation), rtol=1e-9,
                               atol=1e-12)
    assert int(out.num_iters) == int(jout.num_iters)
    assert int(out.stop_reason) == int(jout.stop_reason)
    np.testing.assert_allclose(x.translation.numpy(),
                               prior.translation.numpy(), atol=1e-9)


def test_fused_envelope_se3_family():
    """The SE3 family's layout (one SE3 pose, (K, 3) points and targets) and
    its coloring: J is dense, so detection finds none, as the JAX package's
    does (6 colors > max(1, D/2))."""
    fam = cuda_solver.FAMILIES[se3_residual]
    assert fam.id == 2
    assert cuda_solver.SE3_POINTS == {4: 4, 8: 8}
    (jdata, jx0), (tdata, tx0), _ = _jax_problem(2, 5, 4)
    x_ex = pytree.tree_map(lambda a: a[0], tx0)
    d_ex = SE3RefinementData(*(a[0] for a in tdata))
    spec = mf.tangent_spec(x_ex)
    assert fam.accepts(x_ex, spec, d_ex)
    assert not fam.accepts(
        x_ex, spec, SE3RefinementData(d_ex.points[:, :2], d_ex.targets))
    assert not fam.accepts(x_ex, spec, (d_ex.points, d_ex.targets))
    x2 = {"T": x_ex}
    assert not fam.accepts(x2, mf.tangent_spec(x2), d_ex)
    with pytest.raises(ValueError):
        cuda_solver.register_family(lambda x: x, 7)
    got = detect_diag_coloring(se3_residual, x_ex, d_ex, spec, 15, 6, F64)
    ref = j_detect(j_se3_residual,
                   jax.tree_util.tree_map(lambda a: a[0], jx0),
                   JData(*(a[0] for a in jdata)),
                   __import__("tinyopt_tpu").manifold.tangent_spec(
                       jax.tree_util.tree_map(lambda a: a[0], jx0)),
                   15, 6, jnp.float64)
    assert got is None and ref is None
    assert cuda_solver.warp_values(7, 6, 72) == 230


def _se3_pairs(itemsize):
    """The (S, points a lane) pairs csrc/solver_se3.cuh builds the SE3
    family's register kernel for in a type: ``se3_points``'s NP with each
    width of ``K2_SE3_GEOMETRIES`` that ``launch_se3`` instantiates (S = 1,
    or (S/2)·NP < kSE3MaxK)."""
    from tinyopt_tpu_torch import _build
    with open(f"{_build.CSRC}/solver_se3.cuh") as f:
        src = f.read()
    f32, f64 = re.search(r"return sizeof\(T\) == 4 \? (\d+) : (\d+);",
                         src).groups()
    NP = int(f32 if itemsize == 4 else f64)
    max_k = int(re.search(r"constexpr int kSE3MaxK = (\d+);", src).group(1))
    # the register kernel's most points: max(7, 3K) <= SEG_MAX
    assert max_k == cuda_solver.SEG_MAX // 3
    geoms = re.search(r"#define K2_SE3_GEOMETRIES\(X, np\)([^\n]*)",
                      src).group(1)
    widths = [int(w) for w in re.findall(r"X\((\d+), np\)", geoms)]
    return {(S, NP) for S in widths if S == 1 or (S // 2) * NP < max_k}


@pytest.mark.parametrize("solver", ["gn", "lm", "dogleg"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("K", [1, 2, 3, 12, 16, 17, 21, 22, 24, 100])
def test_k2_launch_plan_se3(K, itemsize, solver):
    """K2's plan for the SE3 family (P = 7, D = 6, n_res = 3K): its own
    register kernel up to K = 21 (max(7, 3K) ≤ 64), SE3_POINTS = 4 points a
    lane in float32 and 8 in float64 on the least power of two of lanes S
    (from 1) with S·E ≥ K, every lane of the segment holding the pose-side
    state; past that the warp kernel with 2·7 + 12·6 + 2·3K values a
    warp."""
    code = cuda_solver.SOLVER_CODES[{"gn": to.GaussNewton,
                                     "lm": to.LevenbergMarquardt,
                                     "dogleg": to.DogLeg}[solver]]
    B = 10_007
    plan = cuda_solver.k2_launch_plan(B, 6, 3 * K, itemsize, 2, None, code,
                                      P=7)
    m = max(7, 3 * K)
    if m > cuda_solver.SEG_MAX:
        per_warp = (14 + 72 + 6 * K) * itemsize
        assert plan.path == "warp" and plan.S == 32
        assert plan.warps == max(w for w in (1, 2, 4)
                                 if w == 1 or w * per_warp <= 48 * 1024)
        assert plan.smem_bytes == plan.warps * per_warp
        assert plan.grid * plan.warps >= B
        return
    E = cuda_solver.SE3_POINTS[itemsize]
    assert plan.path == "segment" and plan.E == E and plan.smem_bytes == 0
    assert (plan.S, plan.E) in _se3_pairs(itemsize)
    assert plan.S * E >= K and (plan.S == 1 or (plan.S // 2) * E < K)
    assert plan.S == {4: {1: 1, 2: 1, 3: 1, 12: 4, 16: 4, 17: 8, 21: 8},
                      8: {1: 1, 2: 1, 3: 1, 12: 2, 16: 2, 17: 4,
                          21: 4}}[itemsize][K]
    # one warp a block where an instance takes one lane
    assert plan.warps == (1 if plan.S == 1 else cuda_solver.SEG_WARPS)
    assert plan.grid == -(-B // (plan.warps * 32 // plan.S))


def test_k2_launch_plan_se3_errors():
    """The SE3 family has P = 7, D = 6, three residuals a point and no
    diagonal coloring; a Euclidean family has P = D."""
    for bad in [dict(P=6), dict(P=None), dict(n_res=13),
                dict(coloring="identity"), dict(d=7)]:
        kw = dict(B=3, d=6, n_res=12, itemsize=4, family=2, coloring=None,
                  P=7)
        kw.update(bad)
        with pytest.raises(ValueError):
            cuda_solver.k2_launch_plan(**kw)
    with pytest.raises(ValueError):
        cuda_solver.k2_launch_plan(3, 50, 50, 4, 0, "identity", 1, 51)
    assert cuda_solver.k2_launch_plan(3, 50, 50, 4, 0, "identity", 1, 50) \
        == cuda_solver.k2_launch_plan(3, 50, 50, 4, 0, "identity", 1)


def _k2_se3_case(B, K, dtype, seed, kw, dev, nan_at=None):
    """K2 and its twin on the same SE3 instances on ``dev``."""
    data, xb, _ = make_se3_refinement(B, K, dtype=dtype, seed=seed,
                                      device=dev)
    if nan_at is not None:
        data.targets[nan_at, 1, 2] = float("nan")
    opts = options_from_reference(_options("fused", **kw))
    x_ex = pytree.tree_map(lambda a: a[0], xb)
    plan = cuda_solver.fused_plan(
        opts, "residuals", x_ex, residual_fn=se3_residual,
        data_example=SE3RefinementData(*(a[0] for a in data)))
    assert plan is not None
    x0 = mf.flatten_batch(xb, plan.spec)
    before = cuda_solver.fused_solve.launches
    before_se3 = cuda_solver.fused_solve.se3_launches
    got = cuda_solver.fused_solve(se3_residual, opts, x0, data, plan)
    assert cuda_solver.fused_solve.launches == before + 1
    # the SE3 family's register kernel up to K = 21, the warp kernel past
    assert cuda_solver.fused_solve.se3_launches == before_se3 + (K <= 21)
    ref = cuda_solver.fused_solve_plain(se3_residual, opts, x0, data, plan)
    # the float64 twin on the same values: the float32 twin's own gap
    x64 = cuda_solver.fused_solve_plain(
        se3_residual, opts, x0.double(),
        SE3RefinementData(*(a.double() for a in data)), plan)[0]
    gap = float((ref[0].double() - x64).nan_to_num().abs().max())
    return [(a.cpu(), map_output(lambda v: v.cpu(), o))
            for a, o in (ref, got)] + [gap]


def _se3_kernel_parity(ref, got, dtype, twin_gap=0.0):
    """PERF.md §6: float64 x to rtol 1e-10 with equal stop reasons and
    iterations within 1; float32 x to rtol 1e-4, atol 1e-5 — or twice the
    float32 twin's own gap to the float64 twin where that is larger (few
    points determine a pose poorly: float32 rounding moves it more) — with
    the same success."""
    (xr, outr), (xg, outg) = ref, got
    if dtype == torch.float64:
        torch.testing.assert_close(xg, xr, rtol=1e-10, atol=1e-12,
                                   equal_nan=True)
        assert torch.equal(outg.stop_reason, outr.stop_reason)
        assert int((outg.num_iters - outr.num_iters).abs().max()) <= 1
    else:
        torch.testing.assert_close(xg, xr, rtol=1e-4,
                                   atol=max(1e-5, 2 * twin_gap),
                                   equal_nan=True)
    assert torch.equal(outg.succeeded(), outr.succeeded())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("solver", ["lm", "dogleg", "gn"])
@pytest.mark.parametrize("B,K", [(1, 16), (3, 16), (31, 16), (32, 16),
                                 (33, 16), (257, 16), (1000, 16),
                                 (10_007, 16), (257, 3), (257, 8),
                                 (257, 12), (257, 21), (257, 24)])
def test_k2_se3_on_gpu(B, K, solver, dtype):
    """K2's SE3 family against its twin on the card: the register kernel
    (K ≤ 21; 4 points a lane on 1, 2, 4 or 8 lanes; batches that fill a
    warp's 8 segments, leave it ragged or need the persistent grid to
    stride) and the warp kernel (K = 24)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    kw = {"gn": dict(solver_type=jto.GaussNewton),
          "dogleg": dict(solver_type=jto.DogLeg)}.get(solver, {})
    ref, got, gap = _k2_se3_case(B, K, dtype, 20 + B + K, kw,
                                 torch.device("cuda"))
    _se3_kernel_parity(ref, got, dtype, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("solver", ["lm", "dogleg"])
@pytest.mark.parametrize("B", [64, 10_007])
def test_k2_se3_nan_neighbour_on_gpu(B, solver, dtype):
    """A NaN target stops its instance with SYSTEM_HAS_NAN_OR_INF; the
    instances beside it in its warp (its segment's neighbours) match the
    twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    kw = {"dogleg": dict(solver_type=jto.DogLeg)}.get(solver, {})
    ref, got, gap = _k2_se3_case(B, 16, dtype, 3, kw, torch.device("cuda"),
                                 nan_at=5)
    _se3_kernel_parity(ref, got, dtype, gap)
    stops = got[1].stop_reason
    assert int(stops[5]) == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
    assert bool(torch.all(torch.cat([stops[:5], stops[6:]]) > 0))
