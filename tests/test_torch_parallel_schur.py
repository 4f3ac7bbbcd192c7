"""Landmark-sharded Schur solving of tinyopt_tpu_torch (``parallel.schur``
and ``parallel.schur_obs``: the dense-grid and the sparse-observation BA,
the K-buckets and the covariance) against the JAX package on the CPU.

The port runs in 2 and 4 gloo ranks (``tests/torch_parallel_worker.py``,
each rank count spawned once); the JAX package on 2 and 4 of the 8 virtual
CPU devices (``tests/conftest.py``), in float64, on the same seed-made
numpy inputs (the JAX package's problem makers).  Two ranks run every
case, four the sparse-observation ones.  Solves are held to
``tests/test_fused.py:51``'s tolerances (rtol 1e-5, iterations within 1,
the same success and convergence class), the covariance to 1e-9
relative; every rank's results equal rank 0's bit for bit; the sharded
port equals the unsharded port to the same tolerances (with the padded
landmarks, the smaller problem's solve)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tinyopt_tpu as jto
from tinyopt_tpu.models import bundle_adjustment as jba
from tinyopt_tpu.ops import schur_obs as jso
from tinyopt_tpu.parallel import (sharded_schur_optimize as j_schur,
                                  sharded_schur_sparse_covariance as j_cov,
                                  sharded_schur_sparse_optimize as j_obs,
                                  sharded_schur_sparse_optimize_buckets
                                  as j_buckets)

import torch_parallel_worker as W

torch.set_num_threads(1)

SPAWN_S = 240                  # each spawn's time limit
TWO = ["schur_lm", "schur_dl", "schur_gn", "schur_pad", "schur_se3",
       "obs_lm", "obs_dl", "obs_refine", "obs_pad", "obs_se3", "bk_lm",
       "bk_dl"]
FOUR = ["obs_lm", "obs_dl", "obs_refine", "obs_se3", "bk_lm"]


def toy_pair(a_i, b_j, d_ij):
    return jnp.stack([a_i[0] + b_j[0] - d_ij, 0.3 * a_i[0], 0.3 * b_j[0]])


def ba_pair(pose, point, obs):
    return jba.project(pose, point[None, :])[0] - obs


def syn_pair(cam, pt, d):
    return d["A"] @ cam + d["B"] @ pt - d["y"]


def _grid(n_b: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(5, n_b))
    return d, (rng.uniform(size=(5, n_b)) > 0.3).astype(float)


def _ba(inp: dict, prefix: str, x0) -> None:
    inp[f"{prefix}/wxyz"] = np.array(x0["poses"].rotation.wxyz)
    inp[f"{prefix}/t"] = np.array(x0["poses"].translation)
    inp[f"{prefix}/points"] = np.array(x0["points"])


def schur_inputs(cases: list) -> dict:
    d, mask = _grid(16)
    mask13 = mask.copy()
    mask13[:, 13:] = 0.0
    obs, ci, mk = jso.grid_to_obs(jnp.asarray(d), jnp.asarray(mask))
    inp = {"cases": np.asarray(cases), "grid/d": d, "grid/mask": mask,
           "grid/mask13": mask13, "grid/a0": np.zeros((5, 1)),
           "grid/b0": np.zeros((16, 1)), "obs/obs": np.array(obs),
           "obs/ci": np.array(ci), "obs/mk": np.array(mk)}
    # 13 landmarks padded to 16 with mask-0 points (camera 0, zero obs)
    po, pc, pm = (np.array(a) for a in jso.grid_to_obs(
        *(jnp.asarray(a) for a in _grid(13))))
    inp.update({"pad/obs": np.concatenate([po, np.zeros((3,) + po.shape[1:])]),
                "pad/ci": np.concatenate([pc, np.zeros((3,) + pc.shape[1:],
                                                       pc.dtype)]),
                "pad/mk": np.concatenate([pm, np.zeros((3,) + pm.shape[1:])]),
                "pad/a0": np.zeros((5, 1)),
                "pad/b0": np.concatenate([np.zeros((13, 1)),
                                          np.full((3, 1), 0.7)])})
    data, x0, _ = jba.make_ba_problem(n_cams=4, n_pts=16, noise=1e-4, seed=5,
                                      dtype=jnp.float64)
    inp["se3/obs"], inp["se3/mask"] = (np.array(data.observations),
                                       np.array(data.mask))
    _ba(inp, "se3", x0)
    (co, cc, cm), x0, _ = jba.make_ba_problem_sparse(
        n_cams=10, n_pts=48, k_obs=4, noise=1e-4, seed=3)
    inp.update({"cor/obs": np.array(co), "cor/ci": np.array(cc),
                "cor/mk": np.array(cm)})
    _ba(inp, "cor", x0)
    # heavy-tailed visibility: most landmarks keep 2 rays, a few 4
    (bo, bc, bm), x0, _ = jba.make_ba_problem_sparse(
        n_cams=6, n_pts=16, k_obs=4, noise=1e-4, seed=9)
    bm = np.array(bm)
    bm[:12, 2:] = 0.0
    bc = np.where(bm > 0, np.asarray(bc), 0)
    slabs = jso.bucket_obs(bo, jnp.asarray(bc), jnp.asarray(bm), min_bucket=2)
    assert len(slabs) >= 2
    inp["bk/n"] = np.asarray(len(slabs))
    for g, (o, c, m, ids) in enumerate(slabs):
        inp.update({f"bk/obs{g}": np.array(o), f"bk/ci{g}": np.array(c),
                    f"bk/mk{g}": np.array(m), f"bk/ids{g}": np.array(ids)})
    _ba(inp, "bk", x0)
    rng = np.random.default_rng(17)
    inp.update({"cov/a": rng.normal(size=(4, 3)),
                "cov/b": rng.normal(size=(16, 2)),
                "cov/A": rng.normal(size=(16, 3, 4, 3)),
                "cov/B": rng.normal(size=(16, 3, 4, 2)),
                "cov/y": rng.normal(size=(16, 3, 4)),
                "cov/ci": rng.integers(0, 4, size=(16, 3))})
    cmk = (rng.random((16, 3)) < 0.8).astype(float)
    cmk[:8, 2:] = 0.0
    cmk[:, 0] = 1.0
    inp["cov/mk"] = cmk
    return inp


def _se3(inp: dict, prefix: str):
    from tinyopt_tpu.manifolds import SE3, SO3
    return (SE3(SO3(jnp.asarray(inp[f"{prefix}/wxyz"])),
                jnp.asarray(inp[f"{prefix}/t"])),
            jnp.asarray(inp[f"{prefix}/points"]))


def _opts(st: str, **hessian):
    return jto.Options(max_iters=15, max_consec_failures=0,
                       solver_type={"lm": jto.LevenbergMarquardt,
                                    "dl": jto.DogLeg,
                                    "gn": jto.GaussNewton}[st],
                       hessian=jto.HessianOptions(**hessian))


def jax_schur(inp: dict, n: int, cases: list) -> dict:
    """The JAX package's counterpart of every case on ``n`` devices."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("block",))
    a = {k: jnp.asarray(v) for k, v in inp.items() if v.dtype.kind != "U"}
    x0 = (a["grid/a0"], a["grid/b0"])
    se3_opts = jto.Options(max_iters=8, max_consec_failures=0,
                           hessian=jto.HessianOptions(save_last=False))
    runs = {
        "schur_pad": lambda: j_schur(x0, toy_pair, a["grid/d"],
                                     a["grid/mask13"], jto.Options(
                                         max_iters=15), mesh=mesh),
        "schur_se3": lambda: j_schur(_se3(inp, "se3"), ba_pair, a["se3/obs"],
                                     a["se3/mask"], se3_opts, mesh=mesh),
        "obs_refine": lambda: j_obs(x0, toy_pair, a["obs/obs"], a["obs/ci"],
                                    a["obs/mk"], _opts("lm", schur_refine=2),
                                    mesh=mesh),
        "obs_pad": lambda: j_obs((a["pad/a0"], a["pad/b0"]), toy_pair,
                                 a["pad/obs"], a["pad/ci"], a["pad/mk"],
                                 _opts("lm"), mesh=mesh),
        "obs_se3": lambda: j_obs(_se3(inp, "cor"), ba_pair, a["cor/obs"],
                                 a["cor/ci"], a["cor/mk"], jto.Options(
                                     max_iters=10, max_consec_failures=0,
                                     hessian=jto.HessianOptions(
                                         save_last=False)), mesh=mesh)}
    for st in ("lm", "dl", "gn"):
        runs[f"schur_{st}"] = (lambda st=st: j_schur(
            x0, toy_pair, a["grid/d"], a["grid/mask"], _opts(st),
            mesh=mesh))
        runs[f"obs_{st}"] = (lambda st=st: j_obs(
            x0, toy_pair, a["obs/obs"], a["obs/ci"], a["obs/mk"], _opts(st),
            mesh=mesh))
    slabs = [(a[f"bk/obs{g}"], a[f"bk/ci{g}"], a[f"bk/mk{g}"],
              inp[f"bk/ids{g}"]) for g in range(int(inp["bk/n"]))]
    for st in ("lm", "dl"):
        runs[f"bk_{st}"] = (lambda st=st: j_buckets(
            _se3(inp, "bk"), ba_pair, slabs, jto.Options(
                max_iters=8, max_consec_failures=0,
                solver_type=(jto.DogLeg if st == "dl"
                             else jto.LevenbergMarquardt),
                hessian=jto.HessianOptions(save_last=False)), mesh=mesh))
    ref = {}
    for key in cases:
        x, out = runs[key]()
        W.record(ref, key, jax.tree_util.tree_leaves(x), out)
    cobs = {k: a[f"cov/{k}"] for k in ("A", "B", "y")}
    for rescaled in (False, True):
        key = f"cov_{'rescaled' if rescaled else 'plain'}"
        ref[f"{key}/a"], ref[f"{key}/b"] = (np.asarray(c) for c in j_cov(
            (a["cov/a"], a["cov/b"]), syn_pair, cobs, a["cov/ci"],
            a["cov/mk"], mesh=mesh, rescaled=rescaled))
    for key, fn in (("schur", lambda: j_schur(
            (x0[0], x0[1][:15]), toy_pair, a["grid/d"][:, :15],
            a["grid/mask"][:, :15], jto.Options(), mesh=mesh)),
                    ("obs", lambda: j_obs(
            (x0[0], x0[1][:15]), toy_pair, a["obs/obs"][:15],
            a["obs/ci"][:15], a["obs/mk"][:15], jto.Options(), mesh=mesh))):
        with pytest.raises(ValueError) as e:
            fn()
        ref[f"err/{key}"] = str(e.value)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``get(n)``: the port's ``n`` ranks spawned once (they run while the
    JAX package computes its references), then both results."""
    got = {}

    def get(n: int):
        if n not in got:
            cases = TWO if n == 2 else FOUR
            inp = schur_inputs(cases + ["cov"])
            procs = W.spawn("schur", n,
                            tmp_path_factory.mktemp(f"schur{n}"), inp)
            deadline = time.monotonic() + SPAWN_S
            try:
                ref = jax_schur(inp, n, cases)
            except BaseException:
                W.kill(procs)
                raise
            got[n] = (ref, W.collect(procs, deadline))
        return got[n]

    return get


PAIRS = [(2, c) for c in TWO] + [(4, c) for c in FOUR]


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_agree_bit_for_bit(runs, n):
    W.same_on_every_rank(runs(n)[1])


@pytest.mark.parametrize("n,case", PAIRS)
def test_matches_reference(runs, n, case):
    ref, ranks = runs(n)
    W.parity(ref, case, ranks[0], case)


@pytest.mark.parametrize("n,case", PAIRS)
def test_matches_unsharded_port(runs, n, case):
    """The sharded port against the port's unsharded solve (for the padded
    cases: of the 13-landmark problem, the padded landmarks left out)."""
    _, ranks = runs(n)
    res = ranks[0]
    if case.endswith("_pad"):
        res = dict(res)                    # 5 cameras, 13 of 16 landmarks
        res[f"{case}/x1"] = res[f"{case}/x1"][:13]
        res[f"{case}/final_grad"] = res[f"{case}/final_grad"][:18]
    W.parity(ranks[0], f"plain/{case}", res, case)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "rescaled"])
def test_covariance_matches_reference(runs, n, kind):
    ref, ranks = runs(n)
    for part in ("a", "b"):
        for want in (ref[f"cov_{kind}/{part}"],
                     ranks[0][f"plain/cov_{kind}/{part}"]):
            got = ranks[0][f"cov_{kind}/{part}"]
            gap = np.max(np.abs(got - want)) / np.max(np.abs(want))
            assert gap <= 1e-9, (part, gap)


def test_padded_landmarks_stay_put(runs):
    """mask-0 landmarks get a zero gradient and a zero step."""
    _, ranks = runs(2)
    np.testing.assert_array_equal(ranks[0]["obs_pad/x1"][13:],
                                  np.full((3, 1), 0.7))


@pytest.mark.parametrize("n", [2, 4])
def test_indivisible_landmarks_raise(runs, n):
    ref, ranks = runs(n)
    for key in ("schur", "obs"):
        assert str(ranks[0][f"err/{key}"]) == ref[f"err/{key}"]
