"""The sparse-observation (point-major) Schur path of tinyopt_tpu_torch —
``ops/schur_obs.py`` (``obs_linearize``, the reduce, the reduced solve on
each route, ``SchurObsSystem``, the marginals, ``grid_to_obs``) and
``sparse.schur_sparse_optimize`` / ``schur_sparse_covariance`` — against
the JAX package on the same inputs made with numpy, in float64 on the CPU
(tests/test_schur.py's sparse-observation and banded tests,
tests/test_cov_scale.py's marginals).  Solves are held to rtol 1e-5 on x
and cost, iterations within 1 and the same success and convergence class
(tests/test_fused.py:51); Jacobians to 1e-12; the reduce, the reduced
solves and the covariances to 1e-10 relative or better."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu import manifold as jmf
from tinyopt_tpu.manifolds import SE3 as JSE3, SO3 as JSO3
from tinyopt_tpu.models import bundle_adjustment as jba
from tinyopt_tpu.ops import schur_obs as jso

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.interop import (ba_problem_from_numpy,
                                       options_from_reference)
from tinyopt_tpu_torch.manifolds import SE3, SO3
from tinyopt_tpu_torch.models import bundle_adjustment as tba
from tinyopt_tpu_torch.ops import schur_obs as tso
from tinyopt_tpu_torch.ops.schur import _damp_blocks
from tinyopt_tpu_torch.ops.linalg import inv_cov

torch.set_num_threads(1)

F64 = torch.float64
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def jpair(pose, point, obs):
    return jba.project(pose, point[None, :])[0] - obs


def tpair(pose, point, obs):
    return tba.project(pose, point[None, :])[0] - obs


ANCHOR = 0.01


def janchored(pose, point, d):
    """``jpair`` on ``d["xy"]`` with weak priors toward the start pose and
    point the slot carries (``d["q"]``, ``d["t"]``, ``d["p"]``): they fix
    BA's 7-dim gauge, so Gauss-Newton's reduced system is definite (plain
    BA's is singular and both packages stop SOLVER_FAILED at once)."""
    a = (JSE3(JSO3(d["q"]), d["t"]).inverse() @ pose).log()
    return jnp.concatenate([jpair(pose, point, d["xy"]), ANCHOR * a,
                            ANCHOR * (point - d["p"])])


def tanchored(pose, point, d):
    a = (SE3(SO3(d["q"]), d["t"]).inverse() @ pose).log()
    return torch.cat([tpair(pose, point, d["xy"]), ANCHOR * a,
                      ANCHOR * (point - d["p"])])


def _anchored_obs(obs, ci, jx):
    """The observation pytree of ``janchored``: each slot's observation and
    the start values of its camera and point (numpy, sorted keys)."""
    ci = np.asarray(ci)
    K = ci.shape[1]
    return {"p": np.repeat(np.asarray(jx[1])[:, None], K, axis=1),
            "q": np.asarray(jx[0].rotation.wxyz)[ci],
            "t": np.asarray(jx[0].translation)[ci],
            "xy": np.asarray(obs)}


def _sparse_ba(n_cams, n_pts, k_obs, seed=3, drop=0.0):
    """The JAX package's corridor rig and the same numbers in the port's
    types; ``drop`` masks that share of the slots past the first two."""
    (obs, ci, mk), x0, _ = jba.make_ba_problem_sparse(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=1e-3, seed=seed)
    mk = np.asarray(mk).copy()
    if drop:
        rng = np.random.default_rng(seed + 1)
        mk[:, 2:] *= rng.uniform(size=mk[:, 2:].shape) >= drop
    (tobs, tci, tmk), tx0 = ba_problem_from_numpy(
        (np.asarray(obs), np.asarray(ci), mk),
        np.asarray(x0["poses"].rotation.wxyz),
        np.asarray(x0["poses"].translation), np.asarray(x0["points"]),
        device="cpu", dtype=F64)
    jx = (x0["poses"], x0["points"])
    tx = (tx0["poses"], tx0["points"])
    return (obs, ci, jnp.asarray(mk)), jx, (tobs, tci, tmk), tx


def _close(jtree, ttree, rtol, atol=0.0):
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    pytree.tree_leaves(ttree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)


def assert_parity(ref, got, rtol=1e-5, atol=1e-9, iter_slack=1):
    """tests/test_fused.py:51's parity: x and cost to rtol, iterations
    within ``iter_slack``, the same success and convergence class."""
    (xr, outr), (xg, outg) = ref, got
    _close(xr, xg, rtol, atol)
    assert bool(outg.succeeded()) == bool(outr.succeeded())
    assert bool(outg.converged()) == bool(outr.converged())
    assert abs(int(outg.num_iters) - int(outr.num_iters)) <= iter_slack
    np.testing.assert_allclose(float(outg.final_cost.cost),
                               float(outr.final_cost.cost), rtol=rtol,
                               atol=atol)


# --------------------------------------------------------- building blocks

def _system_inputs(problem, chunk):
    """The JAX system's undamped blocks at x0, padded to the chunk, with a
    random g_b: the inputs both reduces see, and the JAX reduce of them
    LM-damped (λ = 1e-3) with a random g_a: the inputs both reduced solves
    see."""
    (obs, ci, mk), jx, _, _ = problem
    spec = jmf.tangent_spec(jx)
    acc, *_ = jso.schur_obs_system(jpair, jx[0], jx[1], obs, ci, mk, spec,
                                   chunk=chunk)
    H, _, _ = jax.jit(acc)(jx)
    n_b, K = np.asarray(ci).shape
    n_p = -(-n_b // chunk) * chunk
    pad = n_p - n_b

    def padded(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    rng = np.random.default_rng(0)
    E_p, C_p, cam_p, mk_p = (padded(H.E), padded(H.C), padded(ci),
                             padded(mk))
    g_b = padded(rng.normal(size=(n_b, 3)))
    n_a, da = np.asarray(H.Ba).shape[:2]
    lam = 1e-3
    Bd = jso._damp_flat(jnp.asarray(H.Ba).reshape(n_a, da * da), da, lam)
    Cd = jso._damp_flat(jnp.asarray(C_p), 3, lam)
    S_f, rhs, _ = jax.jit(jso.make_reduce_pass(
        n_a, K, da, 3, jnp.float64, chunk))(
            jnp.asarray(E_p), Cd, jnp.asarray(cam_p), jnp.asarray(g_b))
    damped = (S_f, rhs, Bd.reshape(n_a, da, da),
              jnp.asarray(rng.normal(size=(n_a, da))))
    return H, E_p, C_p, cam_p, mk_p, g_b, K, damped


@pytest.fixture(scope="module")
def corridor():
    """32 cameras x 200 points, K = 4, a quarter of the late slots masked:
    bandwidth 3, 11 groups of 3 cameras (the banded route)."""
    return _sparse_ba(32, 200, 4, drop=0.25)


@pytest.fixture(scope="module")
def inputs(corridor):
    return _system_inputs(corridor, 64)


class TestBuildingBlocks:
    def test_obs_linearize_matches_reference(self, corridor):
        """r, Ja, Jb of every slot against the JAX package's jacfwd at
        1e-12; masked slots give exact zeros."""
        (obs, ci, mk), jx, (tobs, tci, tmk), tx = corridor
        spec_a = jmf.tangent_spec(jax.tree_util.tree_map(lambda l: l[0],
                                                         jx[0]))
        spec_b = jmf.tangent_spec(jx[1][0])
        r, Ja, Jb = jax.jit(lambda a, b: jso.obs_linearize(
            jpair, a, b, obs, ci, mk, spec_a, spec_b, jnp.float64))(*jx)
        ta = pytree.tree_map(lambda l: l[None], tx[0])
        tr, tJa, tJb = tso.obs_linearize(
            tpair, ta, tx[1][None], tobs[None], tci, tmk,
            mf.tangent_spec(pytree.tree_map(lambda l: l[0], tx[0])),
            mf.tangent_spec(tx[1][0]), F64)
        for a, b in ((r, tr), (Ja, tJa), (Jb, tJb)):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a),
                                       rtol=1e-12, atol=1e-12)
        off = tmk == 0
        assert bool(off.any())
        assert torch.all(tJa[0][off] == 0) and torch.all(tJb[0][off] == 0)
        assert torch.all(tr[0][off] == 0)

    @pytest.mark.parametrize("slab_elems", [None, 4096])
    def test_reduce_pass_matches_reference(self, inputs, monkeypatch,
                                           slab_elems):
        """S (X + Xᵀ + diag from the strict-lower pairs), E C⁻¹ g_b and C⁻¹
        against the JAX package's scatter reduce at 1e-10 relative, on
        one slab and (``_SLAB_ELEMS`` cut) on many; the zero C block of a
        padded point becomes the identity."""
        H, E_p, C_p, cam_p, mk_p, g_b, K, _ = inputs
        if slab_elems:
            monkeypatch.setattr(tso, "_SLAB_ELEMS", slab_elems)
        n_a, da = 32, 6
        ref = jax.jit(jso.make_reduce_pass(n_a, K, da, 3, jnp.float64, 64))(
            jnp.asarray(E_p), jnp.asarray(C_p), jnp.asarray(cam_p),
            jnp.asarray(g_b))
        red = tso.make_reduce_pass(n_a, K, da, 3, F64, 64, cam_p, mk_p)
        if slab_elems:
            assert len(tso._slabs(E_p.shape[0], 64, (6 + K) * 36)) == 4
        got = red(_t(E_p)[None], _t(C_p)[None], torch.as_tensor(cam_p),
                  _t(g_b)[None])
        for a, b in zip(ref, got):
            a = np.asarray(a)
            scale = np.abs(a).max()
            np.testing.assert_allclose(b[0].numpy(), a, rtol=0,
                                       atol=1e-10 * scale)
        # the padded points' C⁻¹ is the identity
        Cinv = got[2][0, -1].reshape(3, 3)
        assert torch.equal(Cinv, torch.eye(3, dtype=F64))

    @pytest.mark.parametrize("route", ["dense", "refine", "pcg", "banded",
                                       "banded_refine"])
    def test_assemble_reduced_matches_reference(self, inputs, route):
        """The reduced solve on each route against the JAX package's on
        the same (LM-damped) reduce: dense Cholesky, two refinement
        rounds, 12 block-Jacobi PCG iterations, cyclic reduction over
        groups of 3 cameras, and cyclic reduction with two refinement
        rounds (the banded S·x product of ``_tridiag_cr_refine``); the
        route counters say which ran."""
        S_f, rhs, Bd, g_a = inputs[-1]
        kw = dict(refine=2 if route in ("refine", "banded_refine") else 0,
                  cg_iters=12 if route == "pcg" else 0,
                  band_group=3 if route.startswith("banded") else None)
        dx_ref, ok_ref = jax.jit(lambda *a: jso.assemble_reduced(*a, **kw))(
            S_f, rhs, Bd, g_a)
        before = dict(tso.SOLVES)
        dx, ok = tso.assemble_reduced(_t(S_f)[None], _t(rhs)[None],
                                      _t(Bd)[None], _t(g_a)[None], **kw)
        name = {"refine": "dense", "banded_refine": "banded"}.get(route,
                                                                  route)
        assert tso.SOLVES[name] == before[name] + 1
        assert bool(ok[0]) and bool(ok_ref)
        scale = np.abs(np.asarray(dx_ref)).max()
        np.testing.assert_allclose(dx[0].numpy(), np.asarray(dx_ref),
                                   rtol=0, atol=1e-10 * scale)

    def test_propose_stages_compose_the_step(self, corridor):
        """The stages that ``propose.stages`` exposes (reduce_inputs,
        reduce, the reduced solve at its band group, backsub) give the LM
        step of ``propose`` exactly."""
        _, _, (tobs, tci, tmk), tx = corridor
        spec = mf.tangent_spec(tx)
        acc, _, _, prop = tso.schur_obs_system(
            tpair, tx[0], tx[1], tobs[None], tci, tmk, spec, chunk=64)
        H, g, _ = acc(mf.flatten_batch(
            pytree.tree_map(lambda l: l[None], tx), spec))
        lam = torch.tensor([1e-3], dtype=F64)
        o = to.Options(hessian=to.HessianOptions(schur_refine=2))
        dx, ok = prop(H, g, lam, o)
        st = prop.stages
        assert st.band_group == 3
        g_a, g_b, E_p, Cd_p = st.reduce_inputs(
            H, tso._damp_flat(H.C, 3, lam), g)
        S_f, rhs, Cinv = st.reduce(E_p, Cd_p, g_b)
        dx_a, _ = tso.assemble_reduced(S_f, rhs, _damp_blocks(H.Ba, lam),
                                       g_a, refine=2,
                                       band_group=st.band_group)
        dx_b = st.backsub(E_p, Cinv, g_b, dx_a)
        assert bool(ok[0]) and H.em2gl is None
        assert torch.equal(dx, torch.cat([dx_a.flatten(-2),
                                          dx_b.flatten(-2)], dim=-1))

    def test_band_detection_matches_reference(self):
        """detect_camera_bandwidth and pick_band_group equal the JAX
        package's on random layouts with masked slots, and at the gates
        (at most 384 dims a block, at least 8 groups)."""
        rng = np.random.default_rng(5)
        for _ in range(20):
            cam = rng.integers(0, 50, size=(30, 5))
            mk = rng.uniform(size=(30, 5)) < 0.7
            bw = tso.detect_camera_bandwidth(cam, mk)
            assert bw == jso.detect_camera_bandwidth(cam, mk)
        for bw, n_a, da in ((7, 1000, 6), (64, 1000, 6), (65, 1000, 6),
                            (3, 24, 6), (3, 23, 6), (0, 10, 6), (7, 100, 9)):
            assert tso.pick_band_group(bw, n_a, da) == \
                jso.pick_band_group(bw, n_a, da)
        assert tso.pick_band_group(7, 1000, 6) == 7
        assert tso.pick_band_group(65, 1000, 6) is None

    def test_damp_flat_matches_reference(self):
        rng = np.random.default_rng(2)
        M = rng.normal(size=(10, 9))
        M[3, 4] = 0.0                         # an exactly-zero diagonal
        got = tso._damp_flat(_t(M)[None], 3, torch.tensor([0.3], dtype=F64))
        np.testing.assert_array_equal(
            got[0].numpy(), np.asarray(jso._damp_flat(jnp.asarray(M), 3,
                                                      0.3)))

    def test_system_matvec_and_dense_match_reference(self):
        """SchurObsSystem.matvec / to_dense / the gradient against the JAX
        package's on a multi-leaf camera pytree (the em <-> global tangent
        maps) with masked slots."""
        x, obs, ci, mk = _linear_instance()
        tx, tobs, tci, tmk = _linear_torch(x, obs, ci, mk)
        spec = jmf.tangent_spec(x)
        acc, *_ = jso.schur_obs_system(lin_pair, x[0], x[1], obs, ci, mk,
                                       spec, chunk=8)
        H, g, cost = jax.jit(acc)(x)
        tspec = mf.tangent_spec(tx)
        tacc, *_ = tso.schur_obs_system(
            tlin_pair, tx[0], tx[1], pytree.tree_map(lambda l: l[None],
                                                     tobs),
            tci, tmk, tspec, chunk=8)
        tH, tg, tcost = tacc(mf.flatten_batch(
            pytree.tree_map(lambda l: l[None], tx), tspec))
        assert tH.em2gl is not None
        np.testing.assert_allclose(tg[0].numpy(), np.asarray(g), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(tcost.cost.numpy()[0], float(cost.cost),
                                   rtol=1e-12)
        np.testing.assert_allclose(tH.to_dense()[0].numpy(),
                                   np.asarray(jax.jit(H.to_dense)()),
                                   rtol=1e-12,
                                   atol=1e-12)
        v = np.random.default_rng(4).normal(size=(spec.dims,))
        np.testing.assert_allclose(tH.matvec(_t(v)[None])[0].numpy(),
                                   np.asarray(H.matvec(jnp.asarray(v))),
                                   rtol=1e-12, atol=1e-12)

    def test_no_atomic_sums_on_the_path(self):
        """Every camera and camera-pair sum is a SegmentSum: the modules of
        the path hold no index_add_, scatter_add or accumulating
        index_put_."""
        for rel in ("ops/schur_obs.py", "ops/sparse_sym.py",
                    "ops/tridiag.py", "sparse.py", "models/bal.py"):
            src = (REPO / "tinyopt_tpu_torch" / rel).read_text()
            for bad in (r"\.index_add_?\(", r"\.scatter_add_?\(",
                        r"\.scatter_reduce_?\(", r"accumulate\s*=\s*True"):
                assert re.search(bad, src) is None, (rel, bad)


# ------------------------------------------------- a well-posed instance

N_A, N_B, K_LIN, M_LIN = 5, 24, 3, 4      # da = 3 (2 + 1), db = 2


def lin_pair(a, b, d):
    av = jnp.concatenate([a["u"], a["v"]])
    return d["A"] @ av + d["B"] @ b - d["y"]


def tlin_pair(a, b, d):
    av = torch.cat([a["u"], a["v"]])
    return d["A"] @ av + d["B"] @ b - d["y"]


def _linear_instance(seed=3, dead=False):
    """tests/test_cov_scale.py's generic instance: random linear
    observation maps (H definite), a multi-leaf camera pytree, masked
    slots; ``dead`` masks every slot of landmark 5."""
    rng = np.random.default_rng(seed)
    a = {"u": jnp.asarray(rng.normal(size=(N_A, 2))),
         "v": jnp.asarray(rng.normal(size=(N_A, 1)))}
    b = jnp.asarray(rng.normal(size=(N_B, 2)))
    obs = {"A": jnp.asarray(rng.normal(size=(N_B, K_LIN, M_LIN, 3))),
           "B": jnp.asarray(rng.normal(size=(N_B, K_LIN, M_LIN, 2))),
           "y": jnp.asarray(rng.normal(size=(N_B, K_LIN, M_LIN)))}
    ci = rng.integers(0, N_A, size=(N_B, K_LIN)).astype(np.int32)
    mk = (rng.random((N_B, K_LIN)) < 0.8).astype(np.float64)
    mk[:, 0] = 1.0
    if dead:
        mk[5] = 0.0
    return (a, b), obs, jnp.asarray(ci), jnp.asarray(mk)


def _linear_torch(x, obs, ci, mk):
    tx = ({k: _t(v) for k, v in sorted(x[0].items())}, _t(x[1]))
    tobs = {k: _t(v) for k, v in sorted(obs.items())}
    return tx, tobs, torch.as_tensor(np.asarray(ci)), _t(mk)


class TestCovariance:
    @pytest.mark.parametrize("rescaled", [False, True])
    def test_matches_reference(self, rescaled):
        """schur_sparse_covariance, plain and rescaled, against the JAX
        package's at 1e-10 relative (landmark 5's slots all masked: NaN on
        both sides), and the camera marginals against the dense inverse."""
        x, obs, ci, mk = _linear_instance(dead=True)
        ca, cb = jto.schur_sparse_covariance(x, lin_pair, obs, ci, mk,
                                             rescaled=rescaled, chunk=8)
        tx, tobs, tci, tmk = _linear_torch(x, obs, ci, mk)
        ta, tb = to.schur_sparse_covariance(tx, tlin_pair, tobs, tci, tmk,
                                            rescaled=rescaled, chunk=8)
        assert ta.shape == (N_A, 3, 3) and tb.shape == (N_B, 2, 2)
        assert torch.isnan(tb[5]).all() and np.isnan(np.asarray(cb)[5]).all()
        assert torch.isfinite(tb[torch.arange(N_B) != 5]).all()
        for a, b in ((ca, ta), (cb, tb)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-10 * np.nanmax(np.abs(a)))
            np.testing.assert_array_equal(np.isnan(b.numpy()), np.isnan(a))

    def test_marginals_match_dense_inverse(self):
        """obs_marginals equal the diagonal blocks of the dense H⁻¹ (element-
        major), and Output.covariance() of a saved system equals inv_cov of
        its dense H."""
        x, obs, ci, mk = _linear_instance()
        tx, tobs, tci, tmk = _linear_torch(x, obs, ci, mk)
        o = to.Options(max_iters=8, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=True))
        xs, out = to.schur_sparse_optimize(tx, tlin_pair, tobs, tci, tmk, o)
        assert bool(out.succeeded())
        H = out.final_hessian
        cov_gl = inv_cov(H.to_dense())
        torch.testing.assert_close(out.covariance(), cov_gl, rtol=1e-10,
                                   atol=1e-12)
        g2e = H.gl2em.numpy()
        cov_em = cov_gl.numpy()[np.ix_(g2e, g2e)]
        cov_a, cov_b = H.marginals(chunk=8)
        for i in range(N_A):
            np.testing.assert_allclose(
                cov_a[i].numpy(), cov_em[3 * i:3 * i + 3, 3 * i:3 * i + 3],
                rtol=1e-8, atol=1e-11)
        off = 3 * N_A
        for j in range(N_B):
            np.testing.assert_allclose(
                cov_b[j].numpy(),
                cov_em[off + 2 * j:off + 2 * j + 2,
                       off + 2 * j:off + 2 * j + 2], rtol=1e-8, atol=1e-11)

    def test_single_slot_layout(self):
        """K = 1: no strict-lower pair at all (an empty pair sum); the
        solve succeeds and the covariance is finite."""
        rng = np.random.default_rng(0)
        n_a, n_b = 4, 24
        a = {"u": _t(rng.normal(size=(n_a, 2))),
             "v": _t(rng.normal(size=(n_a, 1)))}
        b = _t(rng.normal(size=(n_b, 2)))
        obs = {"A": _t(rng.normal(size=(n_b, 1, M_LIN, 3))),
               "B": _t(rng.normal(size=(n_b, 1, M_LIN, 2))),
               "y": _t(rng.normal(size=(n_b, 1, M_LIN)))}
        ci = torch.as_tensor(rng.integers(0, n_a, size=(n_b, 1)),
                             dtype=torch.int32)
        mk = torch.ones((n_b, 1), dtype=F64)
        x, out = to.schur_sparse_optimize(
            (a, b), tlin_pair, obs, ci, mk,
            to.Options(max_iters=8, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False)))
        assert bool(out.succeeded())
        cov_a, cov_b = to.schur_sparse_covariance(x, tlin_pair, obs, ci, mk)
        assert torch.isfinite(cov_a).all() and torch.isfinite(cov_b).all()


# ------------------------------------------------------------------ solves

SOLVE_CASES = {
    # (cameras, points, K): 6 x 60 takes the dense reduced solve; 32 x 200
    # has bandwidth 3, so groups of 3 cameras, 11 groups: cyclic reduction
    "dense": (6, 60, 4),
    "banded": (32, 200, 4),
}
SOLVERS = {"lm": "LevenbergMarquardt", "gn": "GaussNewton",
           "dogleg": "DogLeg"}


@pytest.fixture(scope="module")
def solves():
    """Each (problem, solver) solved by both packages once.  Gauss-Newton
    takes the anchored pair (``janchored``), whose observation pytree is a
    dict of four leaves."""
    out = {}
    for case, (nc, npt, K) in SOLVE_CASES.items():
        (obs, ci, mk), jx, (tobs, tci, tmk), tx = _sparse_ba(nc, npt, K)
        for name, st in SOLVERS.items():
            jfn, tfn, jd, td = jpair, tpair, obs, tobs
            if name == "gn":
                d = _anchored_obs(obs, ci, jx)
                jfn, tfn = janchored, tanchored
                jd = {k: jnp.asarray(v) for k, v in d.items()}
                td = {k: _t(v) for k, v in d.items()}
            o = jto.Options(max_iters=15, max_consec_failures=0,
                            solver_type=getattr(jto, st),
                            hessian=jto.HessianOptions(save_last=False))
            ref = jto.schur_sparse_optimize(jx, jfn, jd, ci, mk, o)
            before = dict(tso.SOLVES)
            got = to.schur_sparse_optimize(tx, tfn, td, tci, tmk,
                                           options_from_reference(o))
            routes = {k: tso.SOLVES[k] - before[k] for k in before}
            band = (jso.pick_band_group(jso.detect_camera_bandwidth(
                        np.asarray(ci), np.asarray(mk)), nc, 6),
                    tso.pick_band_group(tso.detect_camera_bandwidth(
                        tci, tmk), nc, 6))
            out[case, name] = (ref, got, routes, band, (tobs, tci, tmk))
        if case == "banded":
            # bench_ba_sparse's reduced solve: two refinement rounds
            # through cyclic reduction
            o = jto.Options(max_iters=15, max_consec_failures=0,
                            hessian=jto.HessianOptions(save_last=False,
                                                       schur_refine=2))
            ref = jto.schur_sparse_optimize(jx, jpair, obs, ci, mk, o)
            before = dict(tso.SOLVES)
            got = to.schur_sparse_optimize(tx, tpair, tobs, tci, tmk,
                                           options_from_reference(o))
            routes = {k: tso.SOLVES[k] - before[k] for k in before}
            out[case, "lm_refine"] = (ref, got, routes, None,
                                      (tobs, tci, tmk))
            # the block-Jacobi PCG reduced solve (hessian.schur_cg_iters)
            o = jto.Options(max_iters=15, max_consec_failures=0,
                            hessian=jto.HessianOptions(save_last=False,
                                                       schur_cg_iters=24))
            ref = jto.schur_sparse_optimize(jx, jpair, obs, ci, mk, o)
            before = dict(tso.SOLVES)
            got = to.schur_sparse_optimize(tx, tpair, tobs, tci, tmk,
                                           options_from_reference(o))
            routes = {k: tso.SOLVES[k] - before[k] for k in before}
            out[case, "lm_cg"] = (ref, got, routes, None, (tobs, tci, tmk))
    return out


class TestSchurSparseOptimize:
    @pytest.mark.parametrize("solver", list(SOLVERS))
    @pytest.mark.parametrize("case", list(SOLVE_CASES))
    def test_matches_reference(self, solves, case, solver):
        """x, cost, iterations and the stop class against the JAX package;
        the banded route is taken exactly where the JAX package's
        detection takes it (group 3 at 32 cameras, none at 6)."""
        ref, got, routes, band, (tobs, tci, tmk) = solves[case, solver]
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        assert int(got[1].stop_reason) == int(ref[1].stop_reason)
        assert band[0] == band[1] == (3 if case == "banded" else None)
        if case == "banded":
            assert routes["banded"] > 0 and routes["dense"] == 0
        else:
            assert routes["dense"] > 0 and routes["banded"] == 0
        rmse = float(tba.reprojection_rmse_sparse(
            {"points": got[0][1], "poses": got[0][0]}, tobs, tci, tmk))
        assert rmse < 1.5e-3, rmse

    def test_banded_refine_matches_reference(self, solves):
        """LM with ``schur_refine=2`` on the banded rig (bench_ba_sparse's
        reduced solve: cyclic reduction with two refinement rounds)
        against the JAX package's."""
        ref, got, routes, _, _ = solves["banded", "lm_refine"]
        assert_parity(ref, got)
        assert bool(got[1].succeeded())
        assert int(got[1].stop_reason) == int(ref[1].stop_reason)
        assert routes["banded"] > 0 and routes["dense"] == 0

    def test_cg_iters_matches_reference(self, solves):
        """LM with ``schur_cg_iters=24`` (24 block-Jacobi PCG iterations for
        each reduced solve, an inexact step) on the banded rig: the whole
        solve against the JAX package's, x, cost, iterations and stop."""
        ref, got, routes, _, _ = solves["banded", "lm_cg"]
        assert_parity(ref, got)
        assert int(got[1].num_iters) == int(ref[1].num_iters)
        assert int(got[1].stop_reason) == int(ref[1].stop_reason)
        assert bool(got[1].succeeded())
        assert routes["pcg"] > 0 and routes["banded"] == 0

    def test_reduced_solve_options_converge(self):
        """schur_banded="off" (the dense route on the banded rig),
        schur_refine and schur_cg_iters reach bench_ba_sparse's criterion
        (RMSE <= 1.2 x the noise) on the port alone."""
        _, _, (tobs, tci, tmk), tx = _sparse_ba(32, 200, 4)
        for hs, route in ((dict(schur_banded="off"), "dense"),
                          (dict(schur_refine=2), "banded"),
                          (dict(schur_cg_iters=24), "pcg")):
            o = to.Options(max_iters=20, max_consec_failures=0,
                           hessian=to.HessianOptions(save_last=False, **hs))
            before = tso.SOLVES[route]
            x, out = to.schur_sparse_optimize(tx, tpair, tobs, tci, tmk, o)
            assert tso.SOLVES[route] > before, hs
            rmse = float(tba.reprojection_rmse_sparse(
                {"points": x[1], "poses": x[0]}, tobs, tci, tmk))
            assert bool(out.succeeded()) and rmse <= 1.2e-3, (hs, rmse)

    def test_validation(self):
        _, _, (tobs, tci, tmk), tx = _sparse_ba(6, 20, 3)
        with pytest.raises(ValueError, match="Gauss-Newton/LM"):
            to.schur_sparse_optimize(tx, tpair, tobs, tci, tmk,
                                     to.Options(solver_type=to.Adam))
        with pytest.raises(ValueError, match="x0 = \\(a0, b0\\)"):
            to.schur_sparse_optimize([tx[0], tx[1]], tpair, tobs, tci, tmk)
        with pytest.raises(ValueError, match="x = \\(a, b\\)"):
            to.schur_sparse_covariance(tx[1], tpair, tobs, tci, tmk)
        assert to.sparse.schur_sparse_optimize is to.schur_sparse_optimize
        assert to.sparse.schur_sparse_covariance is \
            to.schur_sparse_covariance


class TestGridToObs:
    def test_matches_reference_and_grid_solve(self):
        """grid_to_obs equals the JAX package's conversion, and the
        sparse-observation solve of the converted grid follows
        schur_optimize's on the grid."""
        data, x0, _ = jba.make_ba_problem(n_cams=5, n_pts=24,
                                          visibility=0.8, noise=1e-4,
                                          seed=3)
        jobs, jci, jmk = jso.grid_to_obs(data.observations, data.mask)
        tdata, tx0 = ba_problem_from_numpy(
            (np.asarray(data.observations), np.asarray(data.mask)),
            np.asarray(x0["poses"].rotation.wxyz),
            np.asarray(x0["poses"].translation), np.asarray(x0["points"]),
            device="cpu", dtype=F64)
        tobs, tci, tmk = tso.grid_to_obs(tdata.observations, tdata.mask)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(tci.numpy(), np.asarray(jci))
        np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
        assert tci.dtype == torch.int32 and tmk.dtype == F64
        with pytest.raises(ValueError, match="densest"):
            tso.grid_to_obs(tdata.observations, tdata.mask, K=1)
        o = to.Options(max_iters=15, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False))
        tx = (tx0["poses"], tx0["points"])
        xs, outs = to.schur_sparse_optimize(tx, tpair, tobs, tci, tmk, o)
        xg, outg = to.schur_optimize(tx, tpair, tdata.observations,
                                     tdata.mask, o)
        for a, b in zip(pytree.tree_leaves(xs), pytree.tree_leaves(xg)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-9)
        assert int(outs.num_iters) == int(outg.num_iters)
        assert int(outs.stop_reason) == int(outg.stop_reason)
