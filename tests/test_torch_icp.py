"""ICP point-cloud registration in tinyopt_tpu_torch (``models/icp.py``)
against the JAX package's ``models/icp.py``: tests/test_icp.py's six
tests, each on a problem made by the JAX package's ``make_icp_problem``
(float64) and carried across with ``interop.icp_problem_from_numpy``.
Poses agree within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu.manifolds import SE3 as JSE3
from tinyopt_tpu.models.icp import icp as j_icp
from tinyopt_tpu.models.icp import make_icp_problem as j_make_icp_problem
from tinyopt_tpu.models.icp import nearest_neighbors as j_nearest_neighbors

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import (icp_problem_from_numpy,
                                       options_from_reference,
                                       se3_from_numpy)
from tinyopt_tpu_torch.manifolds import SE3
from tinyopt_tpu_torch.models.icp import (icp, icp_multi_start,
                                          make_icp_problem,
                                          multi_start_tangents,
                                          nearest_neighbors)
from tinyopt_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

F64 = torch.float64
POSE_TOL = 1e-6


def _problems(**kw):
    """(JAX problem, the same problem in the port), float64."""
    jp = j_make_icp_problem(dtype=jnp.float64, **kw)
    tp = icp_problem_from_numpy(
        np.asarray(jp.src), np.asarray(jp.dst),
        np.asarray(jp.true_pose.rotation.wxyz),
        np.asarray(jp.true_pose.translation), device="cpu", dtype=F64)
    return jp, tp


def _pose_err(pose: SE3, true_pose: SE3):
    return torch.linalg.vector_norm((pose @ true_pose.inverse()).log(),
                                    dim=-1)


def _same_pose(pose: SE3, jpose, tol=POSE_TOL):
    np.testing.assert_allclose(pose.rotation.wxyz.numpy(),
                               np.asarray(jpose.rotation.wxyz), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(pose.translation.numpy(),
                               np.asarray(jpose.translation), rtol=0,
                               atol=tol)


class TestNearestNeighbors:
    def test_matches_bruteforce_and_reference(self):
        rng = np.random.default_rng(0)
        src = rng.uniform(-1, 1, (2, 20, 3))
        dst = rng.uniform(-1, 1, (2, 30, 3))
        idx = nearest_neighbors(torch.from_numpy(src), torch.from_numpy(dst))
        assert idx.shape == (2, 20)
        for b in range(2):
            d = np.linalg.norm(src[b][:, None] - dst[b][None], axis=-1)
            np.testing.assert_array_equal(idx[b].numpy(), d.argmin(axis=1))
            np.testing.assert_array_equal(
                idx[b].numpy(), np.asarray(j_nearest_neighbors(
                    jnp.asarray(src[b]), jnp.asarray(dst[b]))))
        # ties: the first index, as jnp.argmin
        tie = torch.tensor([[0.0, 0.0, 0.0]], dtype=F64)
        two = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], dtype=F64)
        assert nearest_neighbors(tie, two).tolist() == [0]


class TestICP:
    def test_clean_registration(self):
        jp, tp = _problems(n_src=96, n_dst=128, noise=1e-4, seed=0)
        jpose, jout = jax.jit(lambda s, d: j_icp(s, d))(jp.src, jp.dst)
        pose, out = icp(tp.src, tp.dst)
        _same_pose(pose, jpose)
        assert bool(out.succeeded()) and bool(jout.succeeded())
        assert abs(int(out.num_iters) - int(jout.num_iters)) <= 1
        assert float(_pose_err(pose, tp.true_pose)) < 1e-3

    def test_robust_beats_plain_under_outliers(self):
        jp, tp = _problems(n_src=96, n_dst=128, noise=1e-3,
                           outlier_frac=0.15, seed=1)
        jpose_r, _ = jax.jit(lambda s, d: j_icp(s, d, n_outer=15,
                                                robust_th=0.1))(jp.src,
                                                                jp.dst)
        pose_r, _ = icp(tp.src, tp.dst, n_outer=15, robust_th=0.1)
        pose_p, _ = icp(tp.src, tp.dst, n_outer=15)
        _same_pose(pose_r, jpose_r)
        err_r = float(_pose_err(pose_r, tp.true_pose))
        err_p = float(_pose_err(pose_p, tp.true_pose))
        assert err_r < 0.02
        assert err_r < err_p / 10

    def test_batched(self):
        """A batch of 8 pairs in one loop against the JAX package's vmap."""
        jp, tp = _problems(batch=8, n_src=64, n_dst=80, noise=1e-4, seed=2)
        jposes, jouts = jax.jit(jax.vmap(lambda s, d: j_icp(s, d)))(
            jp.src, jp.dst)
        poses, outs = icp(tp.src, tp.dst)
        _same_pose(poses, jposes)
        assert float(_pose_err(poses, tp.true_pose).max()) < 1e-3
        assert bool(outs.succeeded().all())
        np.testing.assert_array_equal(outs.stop_reason.numpy(),
                                      np.asarray(jouts.stop_reason))

    def test_multi_start_escapes_local_minimum(self):
        """A far pose that identity-start ICP cannot reach: the port's
        multi-start (its starts drawn from a seeded CPU generator) picks
        the same start as the JAX package's ``icp`` run from those starts,
        by the rule "identity first, argmin of the final cost"."""
        jp, tp = _problems(n_src=80, n_dst=100, noise=1e-4, pose_scale=1.2,
                           seed=7)
        w = multi_start_tangents(12, spread=1.0, seed=0, dtype=F64)
        assert torch.all(w[0] == 0)
        jposes, jouts = jax.jit(jax.vmap(
            lambda wi: j_icp(jp.src, jp.dst, JSE3.exp(wi), n_outer=12)))(
                jnp.asarray(w.numpy()))
        best = int(jnp.argmin(jouts.final_cost.cost))
        pose1, out1 = icp(tp.src, tp.dst, n_outer=12)
        posem, outm = icp_multi_start(tp.src, tp.dst, n_starts=12,
                                      n_outer=12, spread=1.0)
        _same_pose(posem, jax.tree_util.tree_map(lambda a: a[best], jposes))
        np.testing.assert_allclose(float(outm.final_cost.cost),
                                   float(jouts.final_cost.cost[best]),
                                   rtol=1e-5)
        assert float(outm.final_cost.cost) <= float(out1.final_cost.cost)
        assert float(_pose_err(posem, tp.true_pose)) < 0.02

    def test_custom_options_and_start(self):
        jp, tp = _problems(n_src=64, n_dst=80, noise=1e-4, seed=3)
        jo = jto.Options(solver_type=jto.GaussNewton, max_iters=6,
                         max_consec_failures=0)
        jpose, _ = j_icp(jp.src, jp.dst, pose0=JSE3.identity(jnp.float64),
                         options=jo, n_outer=8)
        pose, _ = icp(tp.src, tp.dst, pose0=SE3.identity(F64),
                      options=options_from_reference(jo), n_outer=8)
        _same_pose(pose, jpose)
        assert float(_pose_err(pose, tp.true_pose)) < 1e-3

    def test_cg_solver_matches_cholesky_and_problem_maker(self):
        """The "cg" inner solve (K1's plain twin on the CPU) registers as
        "cholesky" does, on pairs drawn by the port's own maker."""
        prob = make_icp_problem(4, 48, 64, noise=1e-4, dtype=F64, seed=4,
                                device="cpu")
        assert prob.src.shape == (4, 48, 3) and prob.dst.shape == (4, 64, 3)
        o = to.Options(max_iters=8, max_consec_failures=0,
                       hessian=to.HessianOptions(solver="cg"))
        pose_cg, out_cg = icp(prob.src, prob.dst, options=o)
        pose_ch, _ = icp(prob.src, prob.dst)
        assert float(_pose_err(pose_cg, prob.true_pose).max()) < 1e-3
        torch.testing.assert_close(pose_cg.translation, pose_ch.translation,
                                   rtol=0, atol=1e-6)
        assert bool(out_cg.succeeded().all())

    def test_scan_sized_pair_matches_reference(self):
        """chip_smoke.py phase 14's scan-sized case, its first pair (drawn
        on the CPU by the port's maker with seed 15, as there): 10,000 ->
        10,000 uniform points from the identity, in float64.  The JAX
        package and the port end on the same pose within 1e-6, and
        neither registers the pair after 10 alternations: the
        correspondence local minimum is the algorithm's, not the port's."""
        prob = make_icp_problem(8, 10_000, 10_000, seed=15, device="cpu")
        src, dst = prob.src[0].double(), prob.dst[0].double()
        true = pytree.tree_map(lambda a: a[0].double(), prob.true_pose)
        jpose, _ = jax.jit(lambda s, d: j_icp(s, d))(
            jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()))
        pose, _ = icp(src, dst)
        _same_pose(pose, jpose)
        jerr = float(_pose_err(se3_from_numpy(
            np.asarray(jpose.rotation.wxyz), np.asarray(jpose.translation),
            device="cpu", dtype=F64), true))
        assert abs(float(_pose_err(pose, true)) - jerr) < 1e-6
        assert jerr > 0.1


@pytest.mark.cuda
def test_icp_cg_on_gpu():
    """chip_smoke.py phase 14 in small: ICP through "cg" on the card calls
    K1 and agrees with the CPU within 1e-4 (float32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    assert not torch.backends.cuda.matmul.allow_tf32
    prob = make_icp_problem(64, seed=5, device="cpu")
    o = to.Options(max_iters=8, max_consec_failures=0,
                   hessian=to.HessianOptions(solver="cg"))
    before = cuda_cg.cg_solve.launches
    pose, out = icp(prob.src.cuda(), prob.dst.cuda(), options=o)
    assert cuda_cg.cg_solve.launches > before
    ref, _ = icp(prob.src, prob.dst, options=o)
    torch.testing.assert_close(pose.translation.cpu(), ref.translation,
                               rtol=0, atol=1e-4)
