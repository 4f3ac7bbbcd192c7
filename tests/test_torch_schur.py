"""The Schur-complement path of tinyopt_tpu_torch — ``ops/schur.py``
(``SchurSystem``, ``schur_system``), ``sparse.schur_optimize``,
``ops/schur_obs.spd_inv_blocks``, ``ops/linalg.refine_psd_solve``,
``manifold.element_perm`` and ``models/bundle_adjustment.py`` — against
the JAX package on the same inputs made with numpy, in float64:
tests/test_schur.py (without its sparse-observation, banded, windowed and
compile-cache tests, which belong to modules not ported yet),
tests/test_bundle_adjustment.py and tests/test_dogleg.py:200-260.  Solves
are held to rtol 1e-5 on x and cost, iterations within 1 and the same
success and convergence class (tests/test_fused.py:51); assembled
Hessians, steps and covariances to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu import manifold as jmf
from tinyopt_tpu.losses import robust_norms as jrn
from tinyopt_tpu.manifolds import SE3 as JSE3
from tinyopt_tpu.models import bundle_adjustment as jba
from tinyopt_tpu.ops import linalg as jlinalg
from tinyopt_tpu.ops.schur import SchurSystem as JSchurSystem
from tinyopt_tpu.ops.schur import schur_system as j_schur_system
from tinyopt_tpu.ops.schur_obs import spd_inv_blocks as j_spd_inv_blocks
from tinyopt_tpu.optimizers.loop import optimize_from_acc as j_from_acc

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.diff.auto import make_nlls_system
from tinyopt_tpu_torch.interop import (ba_problem_from_numpy,
                                       options_from_reference, se3_from_numpy)
from tinyopt_tpu_torch.losses import robust_norms as trn
from tinyopt_tpu_torch.manifolds import SE3
from tinyopt_tpu_torch.models import bundle_adjustment as tba
from tinyopt_tpu_torch.ops.linalg import refine_psd_solve, solve_psd
from tinyopt_tpu_torch.ops.schur import SchurSystem, schur_system
from tinyopt_tpu_torch.ops.schur_obs import spd_inv_blocks
from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc
from tinyopt_tpu_torch.solvers.step import propose_step

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def jpair(pose, point, obs):
    return jba.project(pose, point[None, :])[0] - obs


def tpair(pose, point, obs):
    return tba.project(pose, point[None, :])[0] - obs


def _ba(**kw):
    """The JAX package's BA problem and the same numbers in the port's
    types (``interop.ba_problem_from_numpy``)."""
    data, x0, _ = jba.make_ba_problem(**kw)
    tdata, tx0 = ba_problem_from_numpy(
        (np.asarray(data.observations), np.asarray(data.mask)),
        np.asarray(x0["poses"].rotation.wxyz),
        np.asarray(x0["poses"].translation), np.asarray(x0["points"]),
        device="cpu", dtype=F64)
    return data, x0, tdata, tx0


def _schur_pair(data, x0, tdata, tx0, o, jfn=jpair, tfn=tpair):
    """(JAX schur_optimize, port schur_optimize) on one problem."""
    ref = jto.schur_optimize((x0["poses"], x0["points"]), jfn,
                             data.observations, data.mask, o)
    got = to.schur_optimize((tx0["poses"], tx0["points"]), tfn,
                            tdata.observations, tdata.mask,
                            options_from_reference(o))
    return ref, got


def assert_parity(ref, got, rtol=1e-5, atol=1e-9, iter_slack=1):
    """tests/test_fused.py:51's parity: x and cost to rtol, iterations
    within ``iter_slack``, the same success and convergence class."""
    (xr, outr), (xg, outg) = ref, got
    for a, b in zip(jax.tree_util.tree_leaves(xr), pytree.tree_leaves(xg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= iter_slack
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=rtol,
                               atol=atol)


def _rmse(x, tdata):
    return float(tba.reprojection_rmse({"points": x[1], "poses": x[0]},
                                       tdata))


# ------------------------------------------------------------ building blocks

class TestSpdInvBlocks:
    """tests/test_schur.py::TestSpdInvBlocks, and the port against the JAX
    package: the closed form at db ≤ 3, the Cholesky inverse above (da = 6
    is the Schur PCG preconditioner's block), NaN for a non-PD block."""

    @pytest.mark.parametrize("db", [1, 2, 3, 4, 6])
    def test_matches_inverse_and_nan_contract(self, db):
        rng = np.random.default_rng(db)
        A = rng.normal(size=(32, db, db))
        C = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(db)
        got = spd_inv_blocks(_t(C)).numpy()
        np.testing.assert_allclose(got, np.linalg.inv(C), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(
            got, np.asarray(j_spd_inv_blocks(jnp.asarray(C))), rtol=1e-9,
            atol=1e-11)
        # leading instance axes
        np.testing.assert_allclose(
            spd_inv_blocks(_t(C).reshape(4, 8, db, db)).numpy(),
            got.reshape(4, 8, db, db), rtol=0, atol=0)
        # non-PD: indefinite and negative-definite blocks -> NaN
        bad = np.asarray([-np.eye(db), np.eye(db) - 2 * np.ones((db, db))])
        out = spd_inv_blocks(_t(bad)).numpy()
        ref = np.asarray(j_spd_inv_blocks(jnp.asarray(bad)))
        assert np.all(np.isnan(out[0])) and np.all(np.isnan(ref[0]))
        if db > 1:
            assert np.any(np.isnan(out[1])) and np.any(np.isnan(ref[1]))


def _acc_pair(xp):
    """A 2 x 2 least squares in ``mode="acc"`` for numpy-like module ``xp``
    (torch or jax.numpy), whose H is JᵀJ with H[0, 1] 1e-3 above H[1, 0]."""
    stack = torch.stack if xp is torch else jnp.stack

    def acc(x):
        r = stack([x[0] - 1.0, x[1] - 2.0, x[0] * x[1] - 3.0])
        z = x[0] * 0.0
        J = stack([stack([z + 1.0, z]), stack([z, z + 1.0]),
                   stack([x[1], x[0]])])
        H = J.T @ J + stack([stack([z, z + 1e-3]), stack([z, z])])
        return (xp.sum(r * r), 3), J.T @ r, H
    return acc


@pytest.mark.parametrize("case", ["solve_psd", "spd_inv_blocks",
                                  "optimize_acc"])
def test_asymmetric_blocks_factor_their_symmetric_part(case):
    """Blocks whose upper triangle differs from the lower one: every
    Cholesky factors the symmetric part (H + Hᵀ)/2, as JAX's ``cholesky``
    does, not the lower triangle alone — ``solve_psd`` on 6 x 6 blocks
    whose strict upper triangle is scaled by 1 + 1e-6, ``spd_inv_blocks`` at
    db = 4 (its Cholesky branch), and one LM step of ``optimize(mode="acc")``
    on an H with H[0, 1] 1e-3 above H[1, 0], each against the JAX package
    (on the lower triangle alone they part by ~6e-7, ~1e-6 and ~1.5e-3)."""
    rng = np.random.default_rng(11)
    if case == "optimize_acc":
        o = jto.Options(max_iters=1, max_consec_failures=0)
        ref, _ = jto.optimize(jnp.asarray([0.5, 1.5]), _acc_pair(jnp), o,
                              mode="acc")
        got, _ = to.optimize(_t([0.5, 1.5]), _acc_pair(torch),
                             options_from_reference(o), mode="acc")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-14)
        return
    d = 6 if case == "solve_psd" else 4
    A = rng.normal(size=(4, d, d))
    H = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(d)
    H = H + np.triu(H, 1) * 1e-6
    if case == "solve_psd":
        b = rng.normal(size=(4, d))
        got, ok = solve_psd(_t(H), _t(b))
        ref, ok_ref = jlinalg.solve_psd(jnp.asarray(H), jnp.asarray(b))
        assert bool(ok.all()) and bool(jnp.all(ok_ref))
    else:
        got = spd_inv_blocks(_t(H))
        ref = j_spd_inv_blocks(jnp.asarray(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


class TestRefine:
    def test_refine_stops_where_corrections_grow(self):
        """Past cond ~ 1/eps32 (eigenvalues 10^-8.5 .. 1, float32) the
        refinement rounds diverge: taking every finite correction, as the
        JAX package does, moves the solution ~40x farther from the float64
        solve of the same matrix in two rounds (the JAX package's own
        rounds: ~850x); the port takes a correction only while it is
        shorter than the one before (the first: than x), so here it keeps
        its first solve."""
        rng = np.random.default_rng(5)
        n = 64
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        S32 = ((Q * np.logspace(-8.5, 0, n)) @ Q.T).astype(np.float32)
        b32 = rng.normal(size=n).astype(np.float32)
        x64 = np.linalg.solve(S32.astype(np.float64), b32.astype(np.float64))
        S, b = torch.from_numpy(S32), torch.from_numpy(b32)
        x0, ok = solve_psd(S, b)
        assert bool(ok)
        x, sizes = x0, []
        for _ in range(2):                  # every finite correction taken
            r = (b.double() - S.double() @ x.double()).float()
            c, _ = solve_psd(S, r)
            sizes.append(float(c.norm()))
            x = x + c

        def err(v):
            return float(np.linalg.norm(np.asarray(v, np.float64) - x64))

        assert sizes[0] > float(x0.norm()), sizes
        assert err(x.numpy()) > 10 * err(x0.numpy())
        assert torch.equal(refine_psd_solve(S, b, x0, 2), x0)
        jx0, _ = jlinalg.solve_psd(jnp.asarray(S32), jnp.asarray(b32))
        jx2 = jlinalg.refine_psd_solve(jnp.asarray(S32), jnp.asarray(b32),
                                       jx0, 2)
        assert err(jx2) > 100 * err(jx0)

    def test_refine_recovers_stored_f32_solution(self):
        """tests/test_schur.py::TestSchurRefine on ``refine_psd_solve``
        itself: on a cond ~1e6 float32 system the plain factorization's
        forward error is ~1e-3; two float64-residual rounds recover the
        stored system's exact solution to ~1e-7, as the JAX package's do."""
        rng = np.random.default_rng(0)
        n = 64
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        S64 = (Q * np.logspace(-6, 0, n)) @ Q.T
        b64 = rng.normal(size=n)
        S32, b32 = S64.astype(np.float32), b64.astype(np.float32)
        x_store = np.linalg.solve(S32.astype(np.float64),
                                  b32.astype(np.float64))
        scale = np.abs(x_store).max()
        S, b = torch.from_numpy(S32), torch.from_numpy(b32)
        x0, ok = solve_psd(S, b)
        assert bool(ok)

        def err(x):
            return float(np.abs(np.asarray(x, np.float64).ravel()
                                - x_store).max() / scale)

        x2 = refine_psd_solve(S, b, x0, 2)
        e0, e2 = err(x0.numpy()), err(x2.numpy())
        assert e0 > 1e-4, e0
        assert e2 < 1e-6, e2
        assert e2 < e0 / 100.0, (e0, e2)
        jx0, _ = jlinalg.solve_psd(jnp.asarray(S32), jnp.asarray(b32))
        jx2 = jlinalg.refine_psd_solve(jnp.asarray(S32), jnp.asarray(b32),
                                       jx0, 2)
        assert err(jx2) < 1e-6
        assert np.abs(x2.numpy() - np.asarray(jx2)).max() / scale < 2e-6
        # batched over a leading axis: each instance refined on its own
        xb = refine_psd_solve(S.expand(2, n, n), b.expand(2, n),
                              x0.expand(2, n), 2)
        for row in xb:
            assert err(row.numpy()) < 1e-6
        # no round: x unchanged
        assert torch.equal(refine_psd_solve(S, b, x0, 0), x0)


class TestElementPerm:
    def test_matches_reference(self):
        rng = np.random.default_rng(0)
        w = rng.normal(size=(4, 6))
        cams_j = {"f": jnp.ones((4, 1)), "pose": JSE3.exp(jnp.asarray(w))}
        cams_t = {"f": torch.ones((4, 1), dtype=F64), "pose": SE3.exp(_t(w))}
        np.testing.assert_array_equal(mf.element_perm(cams_t, 4),
                                      jmf.element_perm(cams_j, 4))
        assert mf.element_perm(cams_t["pose"], 4) is None
        assert mf.element_perm(torch.zeros((4, 3)), 4) is None
        with pytest.raises(ValueError, match="divisible"):
            mf.element_perm(cams_t, 3)


# ------------------------------------------------------------ SchurSystem

def _random_system(seed=0, n_a=3, da=2, n_b=5, db=3, coupling=0.1):
    rng = np.random.default_rng(seed)

    def spd(n, d):
        A = rng.normal(size=(n, d, d))
        return A @ A.transpose(0, 2, 1) + 3.0 * np.eye(d)

    Ba, C = spd(n_a, da), spd(n_b, db)
    E = coupling * rng.normal(size=(n_a, n_b, da, db))
    return (JSchurSystem(jnp.asarray(Ba), jnp.asarray(C), jnp.asarray(E)),
            SchurSystem(_t(Ba), _t(C), _t(E)))


class TestSchurSystemAlgebra:
    def test_to_dense_and_matvec(self):
        Hj, H = _random_system()
        Hd = H.to_dense().numpy()
        assert Hd.shape == H.shape and H.dims == 3 * 2 + 5 * 3
        np.testing.assert_allclose(Hd, Hd.T, atol=1e-12)
        np.testing.assert_allclose(Hd, np.asarray(Hj.to_dense()), rtol=0,
                                   atol=0)
        v = np.random.default_rng(1).normal(size=(H.dims,))
        np.testing.assert_allclose(H.matvec(_t(v)).numpy(), Hd @ v,
                                   rtol=1e-10, atol=1e-12)
        # a leading instance axis: each instance its own system
        Hb = SchurSystem(*(torch.stack([a, 2 * a]) for a in
                           (H.Ba, H.C, H.E)))
        vb = _t(np.stack([v, -v]))
        np.testing.assert_allclose(Hb.matvec(vb).numpy(),
                                   np.stack([Hd @ v, -2 * Hd @ v]),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(Hb.to_dense()[1].numpy(), 2 * Hd,
                                   rtol=0, atol=0)

    def test_block_inverse_matches_dense(self):
        """inv() (block inversion) == the dense inverse of to_dense() and
        the JAX package's inv()."""
        Hj, H = _random_system(seed=2)
        cov = H.inv().to_dense().numpy()
        np.testing.assert_allclose(cov @ H.to_dense().numpy(),
                                   np.eye(H.dims), atol=1e-8)
        np.testing.assert_allclose(cov, np.asarray(Hj.inv().to_dense()),
                                   rtol=1e-9, atol=1e-12)

    def test_has_no_diagonal(self):
        """The JAX loop's check_min_H_diag raises TypeError on a
        SchurSystem (jnp.diagonal of the NamedTuple): no diagonal()."""
        _, H = _random_system()
        assert not hasattr(H, "diagonal")


class TestExactElimination:
    @pytest.mark.parametrize("solver", ["lm", "dogleg"])
    def test_propose_matches_dense_solve(self, solver):
        """One damped Schur step == the dense (H + λ·diag) step on the
        same normal equations, and == the JAX package's Schur step."""
        data, x0, tdata, tx0 = _ba(n_cams=3, n_pts=10)
        xj = (x0["poses"], x0["points"])
        spec_j = jmf.tangent_spec(xj)
        jacc, _, _, jprop = j_schur_system(jpair, xj[0], xj[1],
                                           data.observations, data.mask,
                                           spec_j)
        Hj, gj, _ = jax.jit(jacc)(xj)
        xt = (tx0["poses"], tx0["points"])
        spec = mf.tangent_spec(xt)
        acc, ev, n_res, prop = schur_system(
            tpair, xt[0], xt[1], tdata.observations[None],
            tdata.mask[None], spec)
        xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], xt), spec)
        H, g, cost = acc(xb)
        assert int(n_res[0]) == 2 * int(torch.count_nonzero(tdata.mask))

        acc_d, _, _ = make_nlls_system(
            lambda x: tba.ba_residuals({"points": x[1], "poses": x[0]},
                                       tdata), xt, spec)
        Hd, gd, cost_d = acc_d(xb)
        np.testing.assert_allclose(g.numpy(), gd.numpy(), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(gj), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(H.to_dense().numpy(), Hd.numpy(),
                                   rtol=1e-9, atol=1e-12)
        assert float(cost.cost[0]) == pytest.approx(float(cost_d.cost[0]),
                                                    rel=1e-12)
        assert float(ev(xb).cost[0]) == pytest.approx(float(cost.cost[0]),
                                                      rel=1e-12)

        st = {"lm": jto.LevenbergMarquardt, "dogleg": jto.DogLeg}[solver]
        oj = jto.Options(solver_type=st)
        o = options_from_reference(oj)
        jprop_o = jax.jit(lambda H, g, lam: jprop(H, g, lam, oj))
        for lam in (1e-4, 1e-1, 10.0):
            lam_t = torch.full((1,), lam, dtype=F64)
            dx, ok = prop(H, g, lam_t, o)
            dx_j, ok_j = jprop_o(Hj, gj, jnp.asarray(lam))
            assert bool(ok[0]) == bool(ok_j)
            np.testing.assert_allclose(dx[0].numpy(), np.asarray(dx_j),
                                       rtol=1e-7, atol=1e-10)
            if solver == "lm":
                dx_d, ok_d = propose_step(Hd, gd, lam_t, o)
                assert bool(ok[0]) and bool(ok_d[0])
                np.testing.assert_allclose(dx.numpy(), dx_d.numpy(),
                                           rtol=1e-7, atol=1e-10)

    def test_full_solve_matches_dense(self):
        data, x0, tdata, tx0 = _ba(n_cams=4, n_pts=12)
        oj = jto.Options(max_iters=30, max_consec_failures=0)
        o = options_from_reference(oj)
        x_s, out_s = to.schur_optimize((tx0["poses"], tx0["points"]), tpair,
                                       tdata.observations, tdata.mask, o)
        x_d, out_d = to.optimize(
            tx0, lambda p: tba.ba_residuals(p, tdata), o)
        assert int(out_s.num_iters) == int(out_d.num_iters)
        assert int(out_s.stop_reason) == int(out_d.stop_reason)
        assert float(out_s.final_cost.cost) == pytest.approx(
            float(out_d.final_cost.cost), rel=1e-6, abs=1e-18)
        np.testing.assert_allclose(x_s[1].numpy(), x_d["points"].numpy(),
                                   rtol=1e-5, atol=1e-7)
        ref = jto.schur_optimize((x0["poses"], x0["points"]), jpair,
                                 data.observations, data.mask, oj)
        assert_parity(ref, (x_s, out_s))


# ------------------------------------------------------------ schur_optimize

class TestSchurOptimize:
    @pytest.mark.parametrize("solver", ["lm", "gn", "dogleg"])
    def test_partial_visibility(self, solver):
        """TestBA::test_partial_visibility with each solver (GN fails on
        the gauge-singular system, SOLVER_FAILED on both sides, as
        TestBA::test_gn_mode_matches_dense)."""
        st = {"lm": jto.LevenbergMarquardt, "gn": jto.GaussNewton,
              "dogleg": jto.DogLeg}[solver]
        data, x0, tdata, tx0 = _ba(n_cams=5, n_pts=24, visibility=0.7,
                                   seed=3)
        o = jto.Options(max_iters=50, max_consec_failures=0, solver_type=st)
        ref, got = _schur_pair(data, x0, tdata, tx0, o)
        assert_parity(ref, got)
        assert int(got[1].stop_reason) == int(ref[1].stop_reason)
        if solver == "gn":
            assert int(got[1].stop_reason) == int(to.StopReason.SOLVER_FAILED)
        elif solver == "lm":
            assert bool(got[1].converged()) and _rmse(got[0], tdata) < 1e-8

    @pytest.mark.parametrize("hess", [dict(schur_refine=2),
                                      dict(schur_cg_iters=8),
                                      dict(use_ldlt=False)])
    def test_reduced_solve_options(self, hess):
        """hessian.schur_refine, schur_cg_iters (block-Jacobi PCG on the
        reduced system) and use_ldlt=False against the JAX package."""
        data, x0, tdata, tx0 = _ba(n_cams=5, n_pts=24, visibility=0.7,
                                   seed=3, noise=1e-4)
        o = jto.Options(max_iters=30, max_consec_failures=0, min_error=0.0,
                        hessian=jto.HessianOptions(**hess))
        ref, got = _schur_pair(data, x0, tdata, tx0, o)
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        assert _rmse(got[0], tdata) < 2e-4

    def test_larger_problem_converges(self):
        """TestBA::test_larger_problem_converges: 10 cameras x 200
        landmarks (660 tangent dims), the reduced system 60 x 60."""
        data, x0, tdata, tx0 = _ba(n_cams=10, n_pts=200, noise=1e-3, seed=7)
        o = jto.Options(max_iters=40, max_consec_failures=0, min_error=0.0)
        ref, got = _schur_pair(data, x0, tdata, tx0, o)
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        assert _rmse(got[0], tdata) < 2e-3

    def test_dogleg_matches_dense_and_reference(self):
        """tests/test_dogleg.py::test_schur_dogleg_matches_dense."""
        data, x0, tdata, tx0 = _ba(n_cams=3, n_pts=10)
        oj = jto.Options(solver_type=jto.DogLeg, max_iters=30,
                         max_consec_failures=0)
        ref, got = _schur_pair(data, x0, tdata, tx0, oj)
        assert_parity(ref, got)
        _, out_d = to.optimize(tx0, lambda p: tba.ba_residuals(p, tdata),
                               options_from_reference(oj))
        assert int(got[1].stop_reason) == int(out_d.stop_reason)
        assert float(got[1].final_cost.cost) == pytest.approx(
            float(out_d.final_cost.cost), rel=1e-5, abs=1e-16)

    def test_dogleg_gauge_null_space(self):
        """tests/test_dogleg.py::TestGaugeSingular: the two-stage
        Levenberg fallback takes LM-grade steps on BA's 7-dim gauge."""
        data, x0, tdata, tx0 = _ba(n_cams=6, n_pts=64, noise=1e-4, seed=9)
        o = jto.Options(max_iters=10, max_consec_failures=0,
                        solver_type=jto.DogLeg,
                        hessian=jto.HessianOptions(save_last=False))
        ref, got = _schur_pair(data, x0, tdata, tx0, o)
        assert_parity(ref, got)
        assert got[1].final_hessian is None
        assert _rmse(got[0], tdata) < 1.2e-4 and bool(got[1].succeeded())

    def test_validation_and_min_h_diag(self):
        _, _, tdata, tx0 = _ba(n_cams=3, n_pts=8)
        with pytest.raises(ValueError, match=r"\(a0, b0\)"):
            to.schur_optimize(tx0, tpair, tdata.observations, tdata.mask)
        with pytest.raises(ValueError, match="first-order"):
            to.schur_optimize((tx0["poses"], tx0["points"]), tpair,
                              tdata.observations, tdata.mask,
                              to.Options(solver_type=to.Adam))
        data, x0, _, _ = _ba(n_cams=3, n_pts=8)
        o = jto.Options(hessian=jto.HessianOptions(check_min_H_diag=1e-9))
        with pytest.raises(TypeError):
            jto.schur_optimize((x0["poses"], x0["points"]), jpair,
                               data.observations, data.mask, o)
        with pytest.raises(TypeError, match="check_min_H_diag"):
            to.schur_optimize((tx0["poses"], tx0["points"]), tpair,
                              tdata.observations, tdata.mask,
                              options_from_reference(o))


def _anchored_j(a_i, b_j, d_ij):
    return jnp.stack([a_i[0] + b_j[0] - d_ij, 0.3 * a_i[0], 0.3 * b_j[0]])


def _anchored_t(a_i, b_j, d_ij):
    return torch.stack([a_i[0] + b_j[0] - d_ij, 0.3 * a_i[0], 0.3 * b_j[0]])


class TestCovarianceAndCounts:
    """tests/test_schur.py::TestCovarianceAndCounts: a bipartite residual
    with per-pair priors (no gauge freedom), partly masked."""

    @pytest.fixture(scope="class")
    def solves(self):
        rng = np.random.default_rng(5)
        n_a, n_b = 3, 4
        a_true = rng.normal(size=(n_a, 1))
        b_true = rng.normal(size=(n_b, 1))
        d = (a_true[:, None, 0] + b_true[None, :, 0]
             + 1e-2 * rng.normal(size=(n_a, n_b)))
        mask = (rng.random((n_a, n_b)) < 0.75).astype(np.float64)
        o = jto.Options(max_iters=30)
        ref = jto.schur_optimize((jnp.zeros((n_a, 1)), jnp.zeros((n_b, 1))),
                                 _anchored_j, jnp.asarray(d),
                                 jnp.asarray(mask), o)
        got = to.schur_optimize(
            (torch.zeros((n_a, 1), dtype=F64),
             torch.zeros((n_b, 1), dtype=F64)), _anchored_t, _t(d),
            _t(mask), options_from_reference(o))
        return ref, got, mask

    def test_num_residuals_counts_observed_pairs_only(self, solves):
        ref, got, mask = solves
        assert_parity(ref, got)
        n = int(got[1].final_cost.num_residuals)
        assert n == int(np.count_nonzero(mask)) * 3
        assert n == int(ref[1].final_cost.num_residuals)

    def test_output_covariance_matches_dense_inverse(self, solves):
        ref, got, _ = solves
        out = got[1]
        assert bool(out.converged())
        H = out.final_hessian
        assert isinstance(H, SchurSystem)
        cov = out.covariance().numpy()
        assert np.all(np.isfinite(cov))
        np.testing.assert_allclose(cov, np.linalg.inv(H.to_dense().numpy()),
                                   rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(cov, np.asarray(ref[1].covariance()),
                                   rtol=1e-9, atol=1e-12)
        cov_r = out.covariance(rescaled=True).numpy()
        n = int(out.final_cost.num_residuals)
        c = float(out.final_cost.cost)
        np.testing.assert_allclose(cov_r, cov * (c * c / (n - H.dims)),
                                   rtol=1e-9)
        np.testing.assert_allclose(
            cov_r, np.asarray(ref[1].covariance(rescaled=True)), rtol=1e-9,
            atol=1e-12)


class TestMultiLeafCamera:
    def test_focal_and_pose_camera(self):
        """Cameras {"f": (n, 1), "pose": SE3}: the element-major block
        algebra meets the loop's leaf-major layout through em2gl / gl2em
        (``element_perm``); x, the final Hessian (global layout) and the
        covariance against the JAX package."""
        data, x0, tdata, tx0 = _ba(n_cams=4, n_pts=12, noise=1e-4, seed=2)
        f0 = 1.0 + 0.02 * np.random.default_rng(4).normal(size=(4, 1))
        f0[0] = 1.0

        def jfn(cam, point, obs):
            return cam["f"][0] * jba.project(cam["pose"], point[None, :])[0] \
                - obs

        def tfn(cam, point, obs):
            return cam["f"][0] * tba.project(cam["pose"], point[None, :])[0] \
                - obs

        o = jto.Options(max_iters=25, max_consec_failures=0)
        ref = jto.schur_optimize(({"f": jnp.asarray(f0),
                                   "pose": x0["poses"]}, x0["points"]),
                                 jfn, data.observations, data.mask, o)
        got = to.schur_optimize(({"f": _t(f0), "pose": tx0["poses"]},
                                 tx0["points"]), tfn, tdata.observations,
                                tdata.mask, options_from_reference(o))
        assert_parity(ref, got)
        H = got[1].final_hessian
        assert H.em2gl is not None
        np.testing.assert_allclose(H.to_dense().numpy(),
                                   np.asarray(ref[1].final_hessian.to_dense()),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got[1].final_grad.numpy(),
                                   np.asarray(ref[1].final_grad), rtol=1e-5,
                                   atol=1e-12)
        v = np.random.default_rng(0).normal(size=H.dims)
        np.testing.assert_allclose(H.matvec(_t(v)).numpy(),
                                   H.to_dense().numpy() @ v, rtol=1e-10,
                                   atol=1e-12)


class TestRobustSchur:
    """tests/test_schur.py::TestRobustSchur through the port's
    ``robust_whiten`` and ``gnc_anneal`` (its compile-cache test has no
    counterpart: the port has no solve cache)."""

    @pytest.fixture(scope="class")
    def problem(self):
        data, x0, tdata, tx0 = _ba(n_cams=6, n_pts=64, noise=1e-3, seed=13)
        rng = np.random.default_rng(99)
        mask = np.asarray(data.mask)
        out_grid = rng.uniform(size=mask.shape) < 0.15
        gross = rng.uniform(0.3, 0.7, data.observations.shape) * \
            rng.choice([-1.0, 1.0], data.observations.shape)
        obs = np.asarray(data.observations)
        obs_bad = np.where((out_grid * mask)[:, :, None] > 0, obs + gross,
                           obs)
        clean_mask = mask * (1.0 - out_grid.astype(float))
        clean = tba.BAData(tdata.observations, _t(clean_mask))

        def clean_rmse(x):
            return _rmse(x, clean)

        return dict(data=data, x0=x0, tdata=tdata, tx0=tx0, obs_bad=obs_bad,
                    clean_mask=clean_mask, clean_rmse=clean_rmse)

    def _solve(self, p, jfn, tfn, o, mask=None):
        mask = np.asarray(p["data"].mask) if mask is None else mask
        ref = jto.schur_optimize(
            (p["x0"]["poses"], p["x0"]["points"]), jfn,
            jnp.asarray(p["obs_bad"]), jnp.asarray(mask), o)
        got = to.schur_optimize(
            (p["tx0"]["poses"], p["tx0"]["points"]), tfn, _t(p["obs_bad"]),
            _t(mask), options_from_reference(o))
        return ref, got

    def test_gnc_geman_mcclure_reaches_oracle(self, problem):
        p = problem
        o = jto.Options(max_iters=60, max_consec_failures=0, min_error=0.0)
        x_orc, _ = to.schur_optimize(
            (p["tx0"]["poses"], p["tx0"]["points"]), tpair,
            _t(p["obs_bad"]), _t(p["clean_mask"]), options_from_reference(o))
        oracle = p["clean_rmse"](x_orc)
        sched = trn.gnc_schedule(0.5, 5e-3, steps=5)
        assert tuple(sched) == tuple(jrn.gnc_schedule(0.5, 5e-3, steps=5))
        to_o = options_from_reference(o)

        def stage_t(x, th2, fn):
            return to.schur_optimize(x, fn, _t(p["obs_bad"]),
                                     p["tdata"].mask, to_o)

        def stage_j(x, th2, fn):
            return jto.schur_optimize(x, fn, jnp.asarray(p["obs_bad"]),
                                      p["data"].mask, o)

        got = trn.gnc_anneal(stage_t, (p["tx0"]["poses"],
                                       p["tx0"]["points"]), sched,
                             residual_fn=tpair, robust_fn=trn.geman_mcclure)
        ref = jrn.gnc_anneal(stage_j, (p["x0"]["poses"], p["x0"]["points"]),
                             sched, residual_fn=jpair,
                             robust_fn=jrn.geman_mcclure)
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        assert p["clean_rmse"](got[0]) < 1.05 * oracle

    def test_single_stage_huber_beats_plain(self, problem):
        """Huber against the JAX package; plain least squares only to its
        first 10 iterations and the criteria: the gross outliers drag it
        through points near a camera's depth clamp, where rounding decides
        the path (the JAX package's own run from x0 one ulp away parts
        from it at iteration 11; the port's at iteration 23)."""
        p = problem
        o = jto.Options(max_iters=60, max_consec_failures=0, min_error=0.0,
                        save_history=True)
        ref_p, (x_plain, out_plain) = self._solve(p, jpair, tpair, o)
        np.testing.assert_allclose(out_plain.errs[:10].numpy(),
                                   np.asarray(ref_p[1].errs)[:10], rtol=1e-9)
        assert int(out_plain.stop_reason) == int(ref_p[1].stop_reason)
        th2 = (5e-3) ** 2

        def jfn(pose, point, obs):
            return jrn.robust_whiten(jpair(pose, point, obs), jrn.huber, th2)

        def tfn(pose, point, obs):
            return trn.robust_whiten(tpair(pose, point, obs), trn.huber, th2)

        ref, got = self._solve(p, jfn, tfn, o)
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        e_plain, e_rob = p["clean_rmse"](x_plain), p["clean_rmse"](got[0])
        assert e_rob < 2e-2, e_rob
        assert e_plain > 4 * e_rob, (e_plain, e_rob)


class TestBatchedSystem:
    def test_batch_matches_vmap_of_reference(self):
        """``schur_system`` on 3 instances (own data, masks and starts)
        through ``optimize_from_acc`` against the JAX package's vmap of
        one instance's solve, per instance, final SchurSystem included."""
        probs = [jba.make_ba_problem(n_cams=3, n_pts=10, noise=1e-3,
                                     visibility=0.9, seed=s)
                 for s in range(3)]
        stack = lambda f: jnp.stack([f(p) for p in probs])  # noqa: E731
        obs = stack(lambda p: p[0].observations)
        mask = stack(lambda p: p[0].mask)
        xj = (JSE3(type(probs[0][1]["poses"].rotation)(
                  stack(lambda p: p[1]["poses"].rotation.wxyz)),
                   stack(lambda p: p[1]["poses"].translation)),
              stack(lambda p: p[1]["points"]))
        oj = jto.Options(max_iters=20, max_consec_failures=0)
        x_one = jax.tree_util.tree_map(lambda a: a[0], xj)
        spec_j = jmf.tangent_spec(x_one)

        def one(x, ob, m):
            acc, ev, _, prop = j_schur_system(jpair, x[0], x[1], ob, m,
                                              spec_j)
            return j_from_acc(x, acc, ev, oj, spec_j, propose=prop)

        ref = jax.jit(jax.vmap(one))(xj, obs, mask)

        poses = se3_from_numpy(np.asarray(xj[0].rotation.wxyz),
                               np.asarray(xj[0].translation), "cpu", F64)
        xt = (poses, _t(xj[1]))
        t_one = pytree.tree_map(lambda a: a[0], xt)
        spec = mf.tangent_spec(t_one)
        acc, ev, n_res, prop = schur_system(tpair, t_one[0], t_one[1],
                                            _t(obs), _t(mask), spec)
        np.testing.assert_array_equal(
            n_res.numpy(), 2 * np.count_nonzero(np.asarray(mask),
                                                axis=(1, 2)))
        x, out = optimize_from_acc(mf.flatten_batch(xt, spec), acc, ev,
                                   options_from_reference(oj), spec,
                                   propose=prop)
        assert_parity(ref, (mf.unflatten(x, spec), out))
        for a, b in zip((out.final_hessian.Ba, out.final_hessian.C,
                         out.final_hessian.E),
                        (ref[1].final_hessian.Ba, ref[1].final_hessian.C,
                         ref[1].final_hessian.E)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


# ------------------------------------------------------------ the BA model

def _leaves_close(jtree, ttree, tol):
    jl, tl = jax.tree_util.tree_leaves(jtree), pytree.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.double().numpy(),
                                   np.asarray(a, np.float64), rtol=0,
                                   atol=tol)


class TestBundleAdjustmentModel:
    @pytest.mark.parametrize("kw", [
        dict(n_cams=4, n_pts=16),
        dict(n_cams=5, n_pts=24, visibility=0.8, seed=3),
        dict(n_cams=7, n_pts=30, noise=1e-3, seed=11),
        dict(n_cams=4, n_pts=16, noise=1e-3, seed=7, dtype="float32"),
    ])
    def test_make_ba_problem_matches_reference(self, kw):
        """One seed, one problem: data, x0 and x_true equal to 1e-12 in
        float64 (1e-6 in float32), with the points first in x0."""
        tol = 1e-6 if kw.get("dtype") == "float32" else 1e-12
        jkw = dict(kw, dtype=getattr(jnp, kw.get("dtype", "float64")))
        tkw = dict(kw, dtype=getattr(torch, kw.get("dtype", "float64")))
        jd, jx0, jxt = jba.make_ba_problem(**jkw)
        td, tx0, txt = tba.make_ba_problem(**tkw, device="cpu")
        assert list(tx0) == ["points", "poses"]
        _leaves_close(tuple(jd), tuple(td), tol)
        _leaves_close(jx0, tx0, tol)
        _leaves_close(jxt, txt, tol)
        assert float(tba.reprojection_rmse(tx0, td)) == pytest.approx(
            float(jba.reprojection_rmse(jx0, jd)), rel=1e-6)

    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_make_ba_problem_sparse_matches_reference(self, dtype):
        tol = 1e-6 if dtype == "float32" else 1e-12
        (jo, jc, jm), jx0, jxt = jba.make_ba_problem_sparse(
            n_cams=20, n_pts=50, k_obs=4, noise=1e-4, seed=3,
            dtype=getattr(jnp, dtype))
        (to_, tc, tm), tx0, txt = tba.make_ba_problem_sparse(
            n_cams=20, n_pts=50, k_obs=4, noise=1e-4, seed=3,
            dtype=getattr(torch, dtype), device="cpu")
        assert tc.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        _leaves_close((jo, jm), (to_, tm), tol)
        _leaves_close(jx0, tx0, tol)
        _leaves_close(jxt, txt, tol)
        assert float(tba.reprojection_rmse_sparse(
            tx0, to_, tc, tm)) == pytest.approx(float(
                jba.reprojection_rmse_sparse(jx0, jo, jc, jm)), rel=1e-5)
        assert float(tba.reprojection_rmse_sparse(txt, to_, tc, tm)) < 2e-4
        # the JAX problem carried across: the same tensors
        (io, ic, im), ix0 = ba_problem_from_numpy(
            tuple(np.asarray(a) for a in (jo, jc, jm)),
            np.asarray(jx0["poses"].rotation.wxyz),
            np.asarray(jx0["poses"].translation), np.asarray(jx0["points"]),
            device="cpu", dtype=getattr(torch, dtype))
        assert ic.dtype == torch.int32 and list(ix0) == ["points", "poses"]
        _leaves_close((jo, jm), (io, im), 0.0)
        _leaves_close(jx0, ix0, 0.0)

    def test_tangent_layout_points_first(self):
        jd, jx0, _ = jba.make_ba_problem(n_cams=4, n_pts=16)
        _, tx0, _ = tba.make_ba_problem(n_cams=4, n_pts=16, device="cpu")
        spec, spec_j = mf.tangent_spec(tx0), jmf.tangent_spec(jx0)
        assert spec.dims == spec_j.dims == 4 * 6 + 16 * 3
        assert spec.leaf_dims == tuple(spec_j.leaf_dims) == (48, 24)
        assert spec.offsets == tuple(spec_j.offsets)

    @pytest.mark.parametrize("case", ["dense", "visibility", "noisy",
                                      "matfree"])
    def test_solves_match_reference(self, case):
        """tests/test_bundle_adjustment.py's TestBundleAdjustment through
        ``optimize`` and ``matfree_optimize``: x, cost and the final
        gradient (in the tangent layout, points first) against the JAX
        package, and its accuracy criteria.  The matrix-free case lets CG
        run to its tolerance (100 iterations at 48 dims): truncated CG on
        the gauge-singular system amplifies rounding (at 6 x 40 and 80
        iterations the JAX package's own run from x0 one ulp away ends
        2.8e-6 from it)."""
        kw, iters = {
            "dense": (dict(n_cams=4, n_pts=16), 100),
            "visibility": (dict(n_cams=5, n_pts=24, visibility=0.8, seed=3),
                           100),
            "noisy": (dict(n_cams=4, n_pts=16, noise=1e-3, seed=7), 150),
            "matfree": (dict(n_cams=3, n_pts=10, seed=5), 100),
        }[case]
        data, x0, _, _ = _ba(**kw)
        _, tx0, _ = tba.make_ba_problem(**kw, device="cpu")
        tdata, _ = ba_problem_from_numpy(
            (np.asarray(data.observations), np.asarray(data.mask)),
            np.zeros((1, 4)), np.zeros((1, 3)), np.zeros((1, 3)),
            device="cpu", dtype=F64)
        o = jto.Options(max_iters=iters, max_consec_failures=0)
        if case == "matfree":
            ref = jto.matfree_optimize(
                x0, lambda p: jba.ba_residuals(p, data), o, cg_iters=100)
            got = to.matfree_optimize(
                tx0, lambda p: tba.ba_residuals(p, tdata),
                options_from_reference(o), cg_iters=100)
        else:
            ref = jto.optimize(x0, lambda p: jba.ba_residuals(p, data), o)
            got = to.optimize(tx0, lambda p: tba.ba_residuals(p, tdata),
                              options_from_reference(o))
            np.testing.assert_allclose(got[1].final_grad.numpy(),
                                       np.asarray(ref[1].final_grad),
                                       rtol=1e-4, atol=1e-10)
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        rmse = float(tba.reprojection_rmse(got[0], tdata))
        if case == "noisy":
            assert rmse == pytest.approx(1e-3, rel=0.5)
        else:
            assert rmse < 1e-6


# ------------------------------------------------------- on the card only

def _tpair_prior(pose, point, obs):
    """``tpair`` with a 0.1 prior on the pose's log and the point: plain
    BA's 7-dim gauge leaves H singular and its covariance rounding
    noise."""
    return torch.cat([tpair(pose, point, obs), 0.1 * pose.log(),
                      0.1 * point])


@pytest.mark.cuda
def test_schur_optimize_on_gpu():
    """chip_smoke.py phase 16b in small: schur_optimize with GN, LM and
    the dogleg on the card against the CPU port (float64), and the
    covariance of a saved SchurSystem with a prior."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td, tx0, _ = tba.make_ba_problem(n_cams=6, n_pts=64, noise=1e-4,
                                     seed=9, device="cpu")

    def both(fn, o):
        runs = []
        for dev in ("cuda", "cpu"):
            x0 = pytree.tree_map(lambda a: a.to(dev), tx0)
            d = pytree.tree_map(lambda a: a.to(dev), td)
            runs.append(to.schur_optimize((x0["poses"], x0["points"]), fn,
                                          d.observations, d.mask, o))
        return runs

    for st in (to.GaussNewton, to.LevenbergMarquardt, to.DogLeg):
        o = to.Options(max_iters=15, max_consec_failures=0, solver_type=st)
        (xg, og), (xc, oc) = both(tpair, o)
        assert int(og.stop_reason) == int(oc.stop_reason)
        assert int(og.num_iters) == int(oc.num_iters)
        for a, b in zip(pytree.tree_leaves(xg), pytree.tree_leaves(xc)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)
    (_, og), (_, oc) = both(_tpair_prior, to.Options(max_iters=15))
    covc = oc.covariance()
    assert bool(torch.isfinite(covc).all())
    torch.testing.assert_close(og.covariance().cpu(), covc, rtol=0,
                               atol=1e-9 * float(covc.abs().max()))
