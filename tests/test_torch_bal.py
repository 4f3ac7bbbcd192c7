"""The BAL camera model and loader of tinyopt_tpu_torch
(``models/bal.py``) against the JAX package's (``tinyopt_tpu.models.bal``,
tests/test_bal.py) on the same inputs, in float64 on the CPU: the
projection and residual to 1e-12, the loader's padded layout of the
committed excerpt equal, the write / load round trip, the synthetic
maker's arrays equal for one seed, and a small solve through
``schur_sparse_optimize`` held to the JAX package's (rtol 1e-5 on x and
cost, iterations within 1, tests/test_fused.py:51)."""

import bz2
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu.models import bal as jbal

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import (bal_cameras_from_numpy,
                                       options_from_reference)
from tinyopt_tpu_torch.manifolds import SE3, SO3
from tinyopt_tpu_torch.models import bal as tbal

torch.set_num_threads(1)

F64 = torch.float64
FIXTURE = str(pathlib.Path(__file__).parent / "data" / "bal_excerpt.txt")


def _close(jtree, ttree, rtol=0.0, atol=0.0):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = pytree.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)


def _jcams_to_torch(cams):
    """A JAX camera pytree carried across by the interop converter."""
    return bal_cameras_from_numpy(
        np.asarray(cams["pose"].rotation.wxyz),
        np.asarray(cams["pose"].translation), np.asarray(cams["intr"]),
        device="cpu", dtype=F64)


class TestCameraModel:
    def test_projection_and_residual_match_reference(self):
        """bal_project / bal_residual on random cameras (rotations,
        distortion) and points in front of them, against the JAX
        package's at 1e-12, and the analytic case of tests/test_bal.py."""
        rng = np.random.default_rng(0)
        p9 = np.concatenate([0.3 * rng.normal(size=(16, 3)),
                             rng.normal(size=(16, 3)),
                             500 + 50 * rng.normal(size=(16, 1)),
                             1e-2 * rng.normal(size=(16, 1)),
                             1e-3 * rng.normal(size=(16, 1))], axis=1)
        jc = jbal.cameras_from_bal(p9)
        tc = tbal.cameras_from_bal(p9, device="cpu")
        pts = rng.normal(size=(16, 3)) + np.array([0.0, 0.0, -5.0])
        obs = rng.normal(size=(16, 2))
        for i in range(16):
            jci = jax.tree_util.tree_map(lambda l: l[i], jc)
            tci = pytree.tree_map(lambda l: l[i], tc)
            np.testing.assert_allclose(
                tbal.bal_residual(tci, torch.tensor(pts[i]),
                                  torch.tensor(obs[i])).numpy(),
                np.asarray(jbal.bal_residual(jci, jnp.asarray(pts[i]),
                                             jnp.asarray(obs[i]))),
                rtol=1e-12, atol=1e-12)
        cam = {"pose": SE3(SO3(torch.tensor([1.0, 0, 0, 0], dtype=F64)),
                           torch.zeros(3, dtype=F64)),
               "intr": torch.tensor([100.0, 0.1, 0.01], dtype=F64)}
        p = np.asarray([0.2, -0.1])               # -P[:2]/z
        n2 = float((p ** 2).sum())
        np.testing.assert_allclose(
            tbal.bal_project(cam, torch.tensor([0.4, -0.2, -2.0],
                                               dtype=F64)).numpy(),
            100.0 * (1.0 + 0.1 * n2 + 0.01 * n2 * n2) * p, rtol=1e-12)

    def test_cameras_round_trip_and_interop(self):
        """cameras_from_bal / cameras_to_bal are mutual inverses (near
        theta = 0 too), equal the JAX package's quaternions, and the interop
        converter carries a JAX camera pytree across unchanged."""
        rng = np.random.default_rng(1)
        aa = np.concatenate([0.5 * rng.normal(size=(20, 3)),
                             1e-14 * rng.normal(size=(3, 3)),
                             np.zeros((1, 3))])
        p9 = np.concatenate([aa, rng.normal(size=(24, 6))], axis=1)
        tc = tbal.cameras_from_bal(p9, device="cpu")
        np.testing.assert_allclose(tbal.cameras_to_bal(tc), p9, atol=1e-12)
        jc = jbal.cameras_from_bal(p9)
        _close(jc, tc)
        _close(jc, _jcams_to_torch(jc))
        np.testing.assert_allclose(tbal.cameras_to_bal(tc),
                                   jbal.cameras_to_bal(jc), atol=1e-15)


class TestLoader:
    def test_excerpt_loads_as_reference(self):
        """The committed BAL excerpt (30 cameras, 600 points, 4,369
        observations) in the padded layout equals the JAX package's."""
        (jo, jc, jm), jx0 = jbal.load_bal(FIXTURE)
        (to_, tc, tm), tx0 = tbal.load_bal(FIXTURE, device="cpu")
        assert tc.dtype == torch.int32 and tuple(tc.shape) == (600, 30)
        assert int(tm.sum()) == 4369
        _close((jo, jc, jm), (to_, tc, tm))
        _close(jx0, tx0)
        assert float(tbal.bal_rmse(*tx0, to_, tc, tm)) == pytest.approx(
            float(jbal.bal_rmse(*jx0, jo, jc, jm)), rel=1e-12)

    def test_write_load_round_trip(self, tmp_path):
        """write_bal then load_bal (plain and .bz2) gives the problem back;
        a K below the densest landmark's count raises; the bucketed layout
        of the written file equals the JAX package's; an unknown layout
        raises."""
        (obs, ci, mk), _, xt, _ = tbal.make_bal_problem(
            n_cams=6, n_pts=40, k_obs=3, noise=0.1, seed=1, device="cpu")
        path = str(tmp_path / "prob.txt")
        tbal.write_bal(path, xt[0], xt[1], obs, ci, mk)
        bz = str(tmp_path / "prob.txt.bz2")
        with open(path, "rb") as f, bz2.open(bz, "wb") as g:
            g.write(f.read())
        for p in (path, bz):
            (obs2, ci2, mk2), x2 = tbal.load_bal(p, device="cpu")
            torch.testing.assert_close(obs2, obs, rtol=0, atol=1e-12)
            assert torch.equal(ci2, ci) and torch.equal(mk2, mk)
            torch.testing.assert_close(x2[1], xt[1], rtol=0, atol=1e-12)
            torch.testing.assert_close(x2[0]["intr"], xt[0]["intr"],
                                       rtol=0, atol=1e-12)
            q1 = x2[0]["pose"].rotation.wxyz
            q0 = xt[0]["pose"].rotation.wxyz
            gap = torch.minimum((q1 - q0).abs().amax(1),
                                (q1 + q0).abs().amax(1))
            assert float(gap.max()) < 1e-12
        # the JAX package reads the port's file to the same problem
        (jo, jc, jm), _ = jbal.load_bal(path)
        _close((jo, jc, jm), (obs, ci, mk), atol=1e-12)
        with pytest.raises(ValueError, match="densest"):
            tbal.load_bal(path, K=2, device="cpu")
        jslabs, _ = jbal.load_bal(path, layout="bucketed", min_bucket=4)
        tslabs, _ = tbal.load_bal(path, layout="bucketed", min_bucket=4,
                                  device="cpu")
        assert len(tslabs) == len(jslabs)
        for js, ts in zip(jslabs, tslabs):
            _close(js[:3], ts[:3])
            np.testing.assert_array_equal(ts[3], np.asarray(js[3]))
        with pytest.raises(ValueError, match="padded"):
            tbal.load_bal(path, layout="ragged", device="cpu")


class TestProblemAndSolve:
    @pytest.mark.parametrize("kw", [
        dict(n_cams=8, n_pts=60, k_obs=3, noise=0.2, seed=3),
        dict(n_cams=6, n_pts=30, k_obs=4, noise=0.5, seed=2,
             outlier_frac=0.1, intr_noise=0.1),
    ])
    def test_make_bal_problem_matches_reference(self, kw):
        """One seed, one problem: data, x0, x_true and the outlier mask
        equal to 1e-12."""
        jdata, jx0, jxt, jbad = jbal.make_bal_problem(**kw)
        tdata, tx0, txt, tbad = tbal.make_bal_problem(**kw, device="cpu")
        _close(jdata, tdata, atol=1e-12)
        _close(jx0, tx0, atol=1e-12)
        _close(jxt, txt, atol=1e-12)
        np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
        assert sorted(tx0[0]) == ["intr", "pose"]

    def test_solve_matches_reference(self):
        """tests/test_bal.py's grid-vs-sparse instance (8 cameras x 60
        points, 9-parameter cameras, so the element-major and global
        tangent layouts differ) through schur_sparse_optimize, against the
        JAX package's, to its noise floor."""
        kw = dict(n_cams=8, n_pts=60, k_obs=3, noise=0.2, seed=3)
        (jo, jc, jm), jx0, _, _ = jbal.make_bal_problem(**kw)
        (to_, tc, tm), tx0, _, _ = tbal.make_bal_problem(**kw, device="cpu")
        o = jto.Options(max_iters=10, max_consec_failures=0,
                        hessian=jto.HessianOptions(save_last=False))
        ref = jto.schur_sparse_optimize(jx0, jbal.bal_residual, jo, jc, jm,
                                        o)
        got = to.schur_sparse_optimize(tx0, tbal.bal_residual, to_, tc, tm,
                                       options_from_reference(o))
        _close(ref[0], got[0], rtol=1e-5, atol=1e-9)
        assert int(got[1].num_iters) == int(ref[1].num_iters)
        assert int(got[1].stop_reason) == int(ref[1].stop_reason)
        np.testing.assert_allclose(float(got[1].final_cost.cost),
                                   float(ref[1].final_cost.cost), rtol=1e-5)
        rmse = float(tbal.bal_rmse(*got[0], to_, tc, tm))
        assert rmse < 0.3, rmse                 # the noise is 0.2 px
