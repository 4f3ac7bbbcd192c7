"""The K-bucketed sparse-observation BA of tinyopt_tpu_torch —
``ops/schur_obs.py``'s ``bucket_caps``, ``bucket_obs``,
``schur_obs_bucket_system`` / ``SchurObsBuckets`` and
``obs_marginals_buckets``, ``sparse.schur_sparse_optimize_buckets`` /
``schur_sparse_covariance_buckets`` and ``models/bal.load_bal(layout=
"bucketed")`` — against the JAX package on the same numpy inputs, in
float64 on the CPU (tests/test_bal.py's bucketed tests): the bucketing
exactly equal, the solves within tests/test_fused.py:51's parity (rtol 1e-5
on x and cost, iterations within 1, the same success and convergence
class) and against the port's own padded solve at the JAX test's rtol
1e-6, the covariances within 1e-9 relative.  Also the robust-BAL recipe
(benchmarks/run_benchmarks.py's ``bench_bal_robust``: a Geman-McClure
``gnc_anneal`` through ``schur_sparse_optimize``) at a cut, each stage's
iterations within 1."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu import losses as jl
from tinyopt_tpu.models import bal as jbal
from tinyopt_tpu.ops import schur_obs as jso

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import losses as tl
from tinyopt_tpu_torch.interop import (bal_cameras_from_numpy,
                                       options_from_reference)
from tinyopt_tpu_torch.models import bal as tbal
from tinyopt_tpu_torch.ops import schur_obs as tso

torch.set_num_threads(1)

F64 = torch.float64
FIXTURE = str(pathlib.Path(__file__).parent / "data" / "bal_excerpt.txt")


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(jtree, ttree, rtol=0.0, atol=0.0):
    jl_, tl_ = jax.tree_util.tree_leaves(jtree), pytree.tree_leaves(ttree)
    assert len(jl_) == len(tl_)
    for a, b in zip(jl_, tl_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)


def _equal_slabs(jslabs, tslabs):
    """bucket_obs / load_bal slabs: ids, cam_idx, mask and obs equal, in the
    same dtypes."""
    assert len(tslabs) == len(jslabs)
    for (jo, jc, jm, ji), (to_, tc, tm, ti) in zip(jslabs, tslabs):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        for a, b in ((jc, tc), (jm, tm)):
            assert b.numpy().dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jax.tree_util.tree_leaves(jo),
                        pytree.tree_leaves(to_)):
            assert b.numpy().dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _torch_slabs(jslabs):
    """The JAX package's slabs in the port's types (the same numbers)."""
    return [(pytree.tree_map(_t, jax.tree_util.tree_map(np.asarray, o)),
             _t(c), _t(m), np.asarray(i)) for o, c, m, i in jslabs]


def _torch_x(jx):
    """A JAX BAL ``(cameras, points)`` pair carried across."""
    cams, pts = jx
    return (bal_cameras_from_numpy(
        np.asarray(cams["pose"].rotation.wxyz),
        np.asarray(cams["pose"].translation), np.asarray(cams["intr"]),
        device="cpu", dtype=F64), _t(pts))


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


# ---------------------------------------------------------------- instances

def _heavy_tail(seed=4):
    """tests/test_bal.py::TestBucketedLayout's instance: 10 cameras x 90
    landmarks, K = 8, 70 landmarks thinned to 2-3 observations."""
    (obs, ci, mk), x0, _, _ = jbal.make_bal_problem(
        n_cams=10, n_pts=90, k_obs=8, noise=0.3, seed=seed)
    rng = np.random.default_rng(seed)
    m = np.array(mk)
    for j in range(70):
        m[j, rng.integers(2, 4):] = 0.0
    return (obs, jnp.asarray(np.where(m > 0, np.asarray(ci), 0)),
            jnp.asarray(m)), x0


def _fuzz(seed):
    """tests/test_bal.py::TestBucketFuzz's instance of ``seed`` and its
    min_bucket."""
    rng = np.random.default_rng(seed)
    (obs, ci, mk), x0, _, _ = jbal.make_bal_problem(
        n_cams=8, n_pts=70, k_obs=8, noise=0.3, seed=seed)
    m = np.array(mk)
    for j in range(70):
        m[j, int(np.clip(rng.zipf(1.8), 1, 8)):] = 0.0
    ci = jnp.asarray(np.where(m > 0, np.asarray(ci), 0))
    return (obs, ci, jnp.asarray(m)), x0, int(rng.integers(2, 12))


def _in_torch(data):
    obs, ci, mk = data
    return _t(obs), _t(ci), _t(mk)


# ----------------------------------------------------------------- bucketing

def _cascade_counts():
    """tests/test_bal.py::test_merge_cascade_staging_bounded's counts: 8,000
    one-row segments and one of 4,500 rows."""
    ids = np.concatenate([np.arange(1, 8001), np.zeros(4500, np.int64)])
    counts = np.bincount(ids)
    return counts[counts > 0]


@pytest.mark.parametrize("case", ["heavy_tail", "small_largest", "cascade"])
def test_bucket_caps_match_reference(case):
    """cap_of and the used caps equal the JAX package's: Trafalgar-like
    heavy-tailed counts (clip(zipf(2.15), 2, 128)), a largest bucket under
    min_bucket that pulls the next class up, and the merge cascade that
    the staging budget bounds."""
    rng = np.random.default_rng(3)
    if case == "heavy_tail":
        counts, kw = np.clip(rng.zipf(2.15, 20_000), 2, 128), {}
    elif case == "small_largest":
        counts = np.concatenate([rng.integers(1, 5, 600), [40, 41, 90]])
        kw = dict(min_bucket=16)
    else:
        counts, kw = _cascade_counts(), dict(growth=1.35, min_bucket=8)
    cap_ref, used_ref = jso.bucket_caps(counts, **kw)
    cap_of, used = tso.bucket_caps(counts, **kw)
    np.testing.assert_array_equal(cap_of, cap_ref)
    assert cap_of.dtype == np.asarray(cap_ref).dtype
    assert list(used) == list(used_ref) and len(used) >= 2
    assert np.all(cap_of >= np.maximum(counts, 1))


@pytest.mark.parametrize("seed", [None, 11, 12, 13])
def test_bucket_obs_matches_reference(seed):
    """bucket_obs on TestBucketedLayout's instance (min_bucket 8) and on the
    three TestBucketFuzz seeds (their min_bucket draws): ids, cam_idx,
    mask and obs equal; the buckets partition the landmarks and keep every
    observation."""
    if seed is None:
        data, _ = _heavy_tail()
        mb = 8
    else:
        data, _, mb = _fuzz(seed)
    jslabs = jso.bucket_obs(*data, min_bucket=mb)
    tslabs = tso.bucket_obs(*_in_torch(data), min_bucket=mb)
    _equal_slabs(jslabs, tslabs)
    ids = np.concatenate([s[3] for s in tslabs])
    assert sorted(ids.tolist()) == list(range(data[1].shape[0]))
    assert sum(float(s[2].sum()) for s in tslabs) == float(np.sum(data[2]))
    assert tslabs[0][1].dtype == torch.int32


# -------------------------------------------------------------------- solves

SOLVERS = {"lm": "LevenbergMarquardt", "dogleg": "DogLeg"}


@pytest.fixture(scope="module")
def solves():
    """TestBucketedLayout's instance bucketed (min_bucket 8), LM and DogLeg:
    the JAX package's bucketed solve, the port's bucketed and padded
    solves, and the route counts of the port's bucketed solve."""
    data, jx = _heavy_tail()
    jslabs = jso.bucket_obs(*data, min_bucket=8)
    tslabs = _torch_slabs(jslabs)
    tx = _torch_x(jx)
    out = {}
    for name, st in SOLVERS.items():
        o = jto.Options(max_iters=15, max_consec_failures=0,
                        solver_type=getattr(jto, st),
                        hessian=jto.HessianOptions(save_last=False))
        ref = jto.schur_sparse_optimize_buckets(jx, jbal.bal_residual,
                                                jslabs, o)
        before = dict(tso.SOLVES)
        got = to.schur_sparse_optimize_buckets(
            tx, tbal.bal_residual, tslabs, options_from_reference(o))
        routes = {k: tso.SOLVES[k] - before[k] for k in before}
        padded = to.schur_sparse_optimize(tx, tbal.bal_residual,
                                          *_in_torch(data),
                                          options_from_reference(o))
        out[name] = (ref, got, padded, routes, tslabs)
    return out, _in_torch(data)


class TestBucketedSolve:
    @pytest.mark.parametrize("solver", list(SOLVERS))
    def test_matches_reference(self, solves, solver):
        """x, cost, iterations and the stop class against the JAX package's
        bucketed solve; a success to the noise floor (0.3 px)."""
        (ref, got, _, routes, _), data = solves[0][solver], solves[1]
        assert len(solves[0][solver][4]) >= 2
        assert_parity(ref, got)
        assert int(got[1].stop_reason) == int(ref[1].stop_reason)
        assert bool(got[1].succeeded())
        assert routes["dense"] > 0
        assert float(tbal.bal_rmse(*got[0], *data)) < 0.45

    @pytest.mark.parametrize("solver", list(SOLVERS))
    def test_matches_padded_layout(self, solves, solver):
        """The bucketed solve follows the port's single-slab solve of the
        same problem (tests/test_bal.py's rtol 1e-6, atol 1e-8), with the
        same iterations and residual count."""
        _, got, padded, _, _ = solves[0][solver]
        for a, b in zip(pytree.tree_leaves(got[0]),
                        pytree.tree_leaves(padded[0])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-8)
        assert int(got[1].num_iters) == int(padded[1].num_iters)
        assert int(got[1].final_cost.num_residuals) == int(
            padded[1].final_cost.num_residuals)

    def test_ids_must_partition(self, solves):
        """A bucket list that misses a landmark or holds one twice raises
        the JAX package's ValueError."""
        tslabs = solves[0]["lm"][4]
        data, jx = _heavy_tail()
        tx = _torch_x(jx)
        o = to.Options(max_iters=2)
        dup = list(tslabs)
        o0, c0, m0, i0 = dup[0]
        dup[0] = (o0, c0, m0, np.concatenate([i0[:-1], i0[:1]]))
        for bad in (tslabs[1:], dup):
            with pytest.raises(ValueError, match="partition the landmark"):
                to.schur_sparse_optimize_buckets(tx, tbal.bal_residual, bad,
                                                 o)
        with pytest.raises(ValueError, match="Gauss-Newton/LM"):
            to.schur_sparse_optimize_buckets(
                tx, tbal.bal_residual, tslabs, to.Options(solver_type=to.Adam))
        with pytest.raises(ValueError, match="x0 = \\(a0, b0\\)"):
            to.schur_sparse_optimize_buckets(list(tx), tbal.bal_residual,
                                             tslabs)
        assert to.sparse.schur_sparse_optimize_buckets is \
            to.schur_sparse_optimize_buckets
        assert to.sparse.schur_sparse_covariance_buckets is \
            to.schur_sparse_covariance_buckets


# ---------------------------------------------------------------- covariance

N_A, N_B, K_LIN, M_LIN = 5, 24, 3, 4      # da = 3 (2 + 1), db = 2


def lin_pair(a, b, d):
    av = jnp.concatenate([a["u"], a["v"]])
    return d["A"] @ av + d["B"] @ b - d["y"]


def tlin_pair(a, b, d):
    av = torch.cat([a["u"], a["v"]])
    return d["A"] @ av + d["B"] @ b - d["y"]


def _linear_instance(seed=3):
    """tests/test_cov_scale.py's generic instance (H definite; a
    multi-leaf camera pytree, so the tangent maps are not the identity)
    with 1-3 real slots a landmark and every slot of landmark 5 masked."""
    rng = np.random.default_rng(seed)
    a = {"u": jnp.asarray(rng.normal(size=(N_A, 2))),
         "v": jnp.asarray(rng.normal(size=(N_A, 1)))}
    b = jnp.asarray(rng.normal(size=(N_B, 2)))
    obs = {"A": jnp.asarray(rng.normal(size=(N_B, K_LIN, M_LIN, 3))),
           "B": jnp.asarray(rng.normal(size=(N_B, K_LIN, M_LIN, 2))),
           "y": jnp.asarray(rng.normal(size=(N_B, K_LIN, M_LIN)))}
    ci = rng.integers(0, N_A, size=(N_B, K_LIN)).astype(np.int32)
    mk = (rng.random((N_B, K_LIN)) < 0.6).astype(np.float64)
    mk[:, 0] = 1.0
    mk[5] = 0.0
    return (a, b), obs, jnp.asarray(ci), jnp.asarray(mk)


@pytest.mark.parametrize("rescaled", [False, True])
def test_covariance_matches_reference(rescaled):
    """schur_sparse_covariance_buckets, plain and rescaled, against the JAX
    package's at 1e-9 relative (landmark 5 has no real slot: NaN on both
    sides), and against the port's padded schur_sparse_covariance."""
    x, obs, ci, mk = _linear_instance()
    jslabs = jso.bucket_obs(obs, ci, mk, min_bucket=4)
    assert len(jslabs) >= 2
    ca, cb = jto.schur_sparse_covariance_buckets(x, lin_pair, jslabs,
                                                 rescaled=rescaled, chunk=8)
    tx = ({k: _t(v) for k, v in sorted(x[0].items())}, _t(x[1]))
    tslabs = tso.bucket_obs({k: _t(v) for k, v in obs.items()}, _t(ci),
                            _t(mk), min_bucket=4)
    _equal_slabs(jslabs, tslabs)
    ta, tb = to.schur_sparse_covariance_buckets(tx, tlin_pair, tslabs,
                                                rescaled=rescaled, chunk=8)
    assert ta.shape == (N_A, 3, 3) and tb.shape == (N_B, 2, 2)
    assert torch.isnan(tb[5]).all() and np.isnan(np.asarray(cb)[5]).all()
    assert torch.isfinite(tb[torch.arange(N_B) != 5]).all()
    pa, pb = to.schur_sparse_covariance(
        tx, tlin_pair, {k: _t(v) for k, v in obs.items()}, _t(ci), _t(mk),
        rescaled=rescaled, chunk=8)
    for a, b in ((ca, ta), (cb, tb), (pa.numpy(), ta), (pb.numpy(), tb)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-9 * np.nanmax(np.abs(a)))
        np.testing.assert_array_equal(np.isnan(b.numpy()), np.isnan(a))


# -------------------------------------------------------------- BAL loader

def test_load_bal_bucketed_matches_reference():
    """load_bal(layout="bucketed") of the committed excerpt at min_bucket 32
    and at the default equals the JAX package's (built from the triplets);
    the bucketed solve from tests/test_bal.py's perturbation follows the
    JAX package's to the noise floor (0.5 px)."""
    for kw in (dict(min_bucket=32), {}):
        jslabs, jx = jbal.load_bal(FIXTURE, layout="bucketed", **kw)
        tslabs, tx = tbal.load_bal(FIXTURE, layout="bucketed", device="cpu",
                                   **kw)
        _equal_slabs(jslabs, tslabs)
        _close(jx, tx)
    jslabs, jx = jbal.load_bal(FIXTURE, layout="bucketed", min_bucket=32)
    tslabs, _ = tbal.load_bal(FIXTURE, layout="bucketed", min_bucket=32,
                              device="cpu")
    assert len(tslabs) >= 2
    rng = np.random.default_rng(0)
    dp = rng.normal(0.0, 5e-3, np.shape(jx[1]))
    jx = (jx[0], jx[1] + jnp.asarray(dp))
    tx = _torch_x(jx)
    o = jto.Options(max_iters=20, max_consec_failures=0,
                    hessian=jto.HessianOptions(save_last=False))
    ref = jto.schur_sparse_optimize_buckets(jx, jbal.bal_residual, jslabs, o)
    got = to.schur_sparse_optimize_buckets(tx, tbal.bal_residual, tslabs,
                                           options_from_reference(o))
    assert_parity(ref, got)
    (po, pc, pm), _ = tbal.load_bal(FIXTURE, device="cpu")
    assert bool(got[1].succeeded())
    assert float(tbal.bal_rmse(*got[0], po, pc, pm)) < 0.55


# ------------------------------------------------------------ robust BAL

def test_robust_bal_recipe_matches_reference():
    """bench_bal_robust's recipe at a cut (12 cameras x 300 landmarks, K = 6,
    0.5 px noise, 10 % outliers, seed 5; three Geman-McClure stages from 50
    to 2 px, each through schur_sparse_optimize with schur_refine=2): the
    final x and cost within rtol 1e-5 of the JAX package's, each stage's
    iterations within 1."""
    kw = dict(n_cams=12, n_pts=300, k_obs=6, noise=0.5, outlier_frac=0.1,
              seed=5)
    (obs, ci, mk), jx, _, bad = jbal.make_bal_problem(**kw)
    o = jto.Options(max_iters=15, max_consec_failures=0, min_error=0.0,
                    hessian=jto.HessianOptions(save_last=False,
                                               schur_refine=2))
    sched = jl.gnc_schedule(50.0, 2.0, steps=3)
    assert tl.gnc_schedule(50.0, 2.0, steps=3) == sched
    j_iters, t_iters = [], []

    def jstage(x, th2, rp):
        x, out = jto.schur_sparse_optimize(x, rp, obs, ci, mk, o)
        j_iters.append(int(out.num_iters))
        return x, out

    tobs, tci, tmk = _in_torch((obs, ci, mk))
    to_o = options_from_reference(o)

    def tstage(x, th2, rp):
        x, out = to.schur_sparse_optimize(x, rp, tobs, tci, tmk, to_o)
        t_iters.append(int(out.num_iters))
        return x, out

    ref = jl.gnc_anneal(jstage, jx, sched, residual_fn=jbal.bal_residual,
                        robust_fn=jl.geman_mcclure)
    got = tl.gnc_anneal(tstage, _torch_x(jx), sched,
                        residual_fn=tbal.bal_residual,
                        robust_fn=tl.geman_mcclure)
    assert len(t_iters) == len(j_iters) == 3
    assert all(abs(a - b) <= 1 for a, b in zip(t_iters, j_iters)), \
        (t_iters, j_iters)
    assert_parity(ref, got)
    # the anneal recovers the clean geometry (the bench's clean-slot RMSE)
    clean = (~np.asarray(bad)) & ((6 - np.asarray(bad).sum(1)) >= 2)[:, None]
    (oc, _, _), _, _, _ = tbal.make_bal_problem(**{**kw, "outlier_frac": 0.0},
                                                device="cpu")
    r = float(tbal.bal_rmse(*got[0], oc, tci, tmk * _t(clean, F64)))
    assert r <= 1.3 * 0.5, r
