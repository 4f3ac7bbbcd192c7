"""One gloo rank of the multi-rank CPU tests of ``tinyopt_tpu_torch.parallel``
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_schur.py``).

    python tests/torch_parallel_worker.py SUITE RANK WORLD STORE INPUTS OUT

Joins a ``file://`` store, runs every case of SUITE ("dp" or "schur") on
the inputs of the ``.npz`` INPUTS (numpy arrays the test module made from
seeds) with the port's sharded entry points, and writes each case's
results to the ``.npz`` OUT.  Rank 0 also writes the port's unsharded
solve of each case (``plain/...``).  :func:`spawn` starts the ranks of a
suite and :func:`collect` waits for them, each run under its own time
limit.  The JAX package is never imported here.  pytest does not collect
this file.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def record(res: dict, key: str, leaves, out) -> None:
    """A solve's x ``leaves`` and the Output fields the tests compare (a
    port's or the JAX package's ``Output``)."""
    for i, a in enumerate(leaves):
        res[f"{key}/x{i}"] = _np(a)
    for f in ("num_iters", "num_failures", "stop_reason", "final_grad"):
        res[f"{key}/{f}"] = _np(getattr(out, f))
    res[f"{key}/cost"] = _np(out.final_cost.cost)
    res[f"{key}/num_residuals"] = _np(out.final_cost.num_residuals)
    res[f"{key}/succeeded"] = _np(out.succeeded())
    res[f"{key}/converged"] = _np(out.converged())


def _record(res: dict, key: str, x, out) -> None:
    from torch.utils import _pytree as pytree
    record(res, key, pytree.tree_leaves(x), out)


def _flat(x) -> list:
    from torch.utils import _pytree as pytree
    return [_np(a) for a in pytree.tree_leaves(x)]


def parity(ref: dict, rkey: str, got: dict, gkey: str, rtol=1e-5, atol=1e-6,
           iter_slack=1, fail_slack=0, grad_rtol=1e-4) -> None:
    """``tests/test_fused.py:51``'s ``_assert_parity`` on two recorded
    solves: every x leaf and the cost within rtol / atol, the same success
    and convergence class, iterations within ``iter_slack``, failures
    within ``fail_slack``, the final gradient within ``grad_rtol``."""
    n = sum(k.startswith(f"{rkey}/x") for k in ref)
    assert n and n == sum(k.startswith(f"{gkey}/x") for k in got), (n, gkey)
    for i in range(n):
        np.testing.assert_allclose(got[f"{gkey}/x{i}"], ref[f"{rkey}/x{i}"],
                                   rtol=rtol, atol=atol)
    for f in ("succeeded", "converged", "num_residuals"):
        np.testing.assert_array_equal(got[f"{gkey}/{f}"], ref[f"{rkey}/{f}"])
    assert np.max(np.abs(got[f"{gkey}/num_iters"].astype(int)
                         - ref[f"{rkey}/num_iters"])) <= iter_slack
    assert np.max(np.abs(got[f"{gkey}/num_failures"].astype(int)
                         - ref[f"{rkey}/num_failures"])) <= fail_slack
    np.testing.assert_allclose(got[f"{gkey}/cost"], ref[f"{rkey}/cost"],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(got[f"{gkey}/final_grad"],
                               ref[f"{rkey}/final_grad"], rtol=grad_rtol,
                               atol=1e-5)


def same_on_every_rank(ranks: list) -> None:
    """Every rank's results equal rank 0's bit for bit (rank 0 alone keeps
    the unsharded ``plain/`` solves)."""
    first = {k: v for k, v in ranks[0].items() if not k.startswith("plain/")}
    for r, res in enumerate(ranks[1:], 1):
        assert res.keys() == first.keys(), r
        for k, v in first.items():
            eq = (np.array_equal(res[k], v, equal_nan=True)
                  if v.dtype.kind == "f" else np.array_equal(res[k], v))
            assert eq, f"rank {r} differs from rank 0 at {k}"


def _error(res: dict, key: str, fn) -> None:
    """The message of the ValueError ``fn()`` raises ("" if none)."""
    try:
        fn()
        res[key] = np.asarray("")
    except ValueError as e:
        res[key] = np.asarray(str(e))


def toy_pair(a_i, b_j, d_ij):
    return torch.stack([a_i[0] + b_j[0] - d_ij, 0.3 * a_i[0],
                        0.3 * b_j[0]])


def ba_pair(pose, point, obs):
    from tinyopt_tpu_torch.models.bundle_adjustment import project
    return project(pose, point[None, :])[0] - obs


def syn_pair(cam, pt, d):
    return d["A"] @ cam + d["B"] @ pt - d["y"]


def dp_suite(inp, world: int, rank: int) -> dict:
    """dp batched_optimize (LM / DogLeg, fused / cg; one case on the
    flattened (batch, block) mesh), sharded_optimize (cholesky / cg), the
    indivisible-axis errors."""
    import tinyopt_tpu_torch as to
    from tinyopt_tpu_torch.models.problems import PriorProblem, prior_residual
    from tinyopt_tpu_torch.parallel import (batched_optimize, local_mesh,
                                            make_mesh, sharded_optimize)
    t = torch.as_tensor
    res = {}
    data = PriorProblem(t(inp["dp/y"]), t(inp["dp/inv_std"]))
    x0 = t(inp["dp/x0"])
    batch = local_mesh("batch", device="cpu")
    grid = make_mesh(batch=max(world // 2, 1), block=min(world, 2),
                     device="cpu")
    for st in ("lm", "dl"):
        for solver in ("fused", "cg"):
            key = f"dp_{st}_{solver}"
            opts = to.Options(
                max_iters=10, save_history=False,
                solver_type=(to.DogLeg if st == "dl"
                             else to.LevenbergMarquardt),
                hessian=to.HessianOptions(solver=solver, cg_iters=5,
                                          carry_system=False,
                                          save_last=False))
            mesh, axis = ((grid, ("batch", "block")) if key == "dp_lm_fused"
                          else (batch, "batch"))
            _record(res, key, *batched_optimize(
                x0, prior_residual, opts, data_batch=data, mesh=mesh,
                axis=axis))
            if rank == 0:
                _record(res, f"plain/{key}", *batched_optimize(
                    x0, prior_residual, opts, data_batch=data))
    bdata = PriorProblem(t(inp["block/y"]), t(inp["block/inv_std"]))
    bx0 = t(inp["block/x0"])
    blocks = local_mesh("block", device="cpu")
    for solver in ("cholesky", "cg"):
        key = f"block_{solver}"
        opts = to.Options(max_iters=10,
                          hessian=to.HessianOptions(solver=solver))
        _record(res, key, *sharded_optimize(bx0, prior_residual, bdata, opts,
                                            mesh=blocks, axis="block"))
        if rank == 0:
            _record(res, f"plain/{key}", *to.optimize(
                bx0, lambda x: prior_residual(x, bdata).reshape(-1), opts))
    n = world + 1                       # divisible by no world above 1
    _error(res, "err/batched", lambda: batched_optimize(
        x0[:n], prior_residual, to.Options(),
        data_batch=PriorProblem(data.y[:n], data.inv_std[:n]), mesh=batch))
    _error(res, "err/block", lambda: sharded_optimize(
        bx0, prior_residual, PriorProblem(bdata.y[:n], bdata.inv_std[:n]),
        mesh=blocks))
    return res


def _toy_options(to, st: str, **hessian):
    return to.Options(max_iters=15, max_consec_failures=0,
                      solver_type={"lm": to.LevenbergMarquardt,
                                   "dl": to.DogLeg,
                                   "gn": to.GaussNewton}[st],
                      hessian=to.HessianOptions(**hessian))


def _ba_x0(inp, prefix: str):
    from tinyopt_tpu_torch.interop import se3_from_numpy
    return (se3_from_numpy(inp[f"{prefix}/wxyz"], inp[f"{prefix}/t"],
                           device="cpu", dtype=torch.float64),
            torch.as_tensor(inp[f"{prefix}/points"]))


def schur_suite(inp, world: int, rank: int) -> dict:
    """sharded_schur_optimize (LM / GN / DogLeg, mask padding, SE3 BA),
    sharded_schur_sparse_optimize (LM / DogLeg, the SE3 corridor,
    schur_refine, mask padding), the K-buckets, the covariance, the
    indivisible-axis errors; the cases listed in ``inputs["cases"]``."""
    import tinyopt_tpu_torch as to
    from tinyopt_tpu_torch.parallel import (
        local_mesh, sharded_schur_optimize, sharded_schur_sparse_covariance,
        sharded_schur_sparse_optimize, sharded_schur_sparse_optimize_buckets)
    t = torch.as_tensor
    mesh = local_mesh("block", device="cpu")
    cases = set(str(c) for c in inp["cases"])
    res = {}

    def run(key, sharded, plain):
        if key in cases:
            _record(res, key, *sharded())
            if rank == 0:
                _record(res, f"plain/{key}", *plain())

    d, mask = t(inp["grid/d"]), t(inp["grid/mask"])
    x0 = (t(inp["grid/a0"]), t(inp["grid/b0"]))
    for st in ("lm", "dl", "gn"):
        o = _toy_options(to, st)
        run(f"schur_{st}",
            lambda: sharded_schur_optimize(x0, toy_pair, d, mask, o,
                                           mesh=mesh),
            lambda: to.schur_optimize(x0, toy_pair, d, mask, o))
    m13 = t(inp["grid/mask13"])
    o = to.Options(max_iters=15)
    run("schur_pad",
        lambda: sharded_schur_optimize(x0, toy_pair, d, m13, o, mesh=mesh),
        lambda: to.schur_optimize((x0[0], x0[1][:13]), toy_pair, d[:, :13],
                                  m13[:, :13], o))
    if "schur_se3" in cases:
        from tinyopt_tpu_torch.models.bundle_adjustment import BAData
        bd = BAData(t(inp["se3/obs"]), t(inp["se3/mask"]))
        xt = _ba_x0(inp, "se3")
        o = to.Options(max_iters=8, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False))
        run("schur_se3",
            lambda: sharded_schur_optimize(xt, ba_pair, bd.observations,
                                           bd.mask, o, mesh=mesh),
            lambda: to.schur_optimize(xt, ba_pair, bd.observations, bd.mask,
                                      o))

    obs, ci, mk = (t(inp["obs/obs"]), t(inp["obs/ci"]), t(inp["obs/mk"]))
    for st in ("lm", "dl"):
        o = _toy_options(to, st)
        run(f"obs_{st}",
            lambda: sharded_schur_sparse_optimize(x0, toy_pair, obs, ci, mk,
                                                  o, mesh=mesh),
            lambda: to.schur_sparse_optimize(x0, toy_pair, obs, ci, mk, o))
    o = _toy_options(to, "lm", schur_refine=2)
    run("obs_refine",
        lambda: sharded_schur_sparse_optimize(x0, toy_pair, obs, ci, mk, o,
                                              mesh=mesh),
        lambda: to.schur_sparse_optimize(x0, toy_pair, obs, ci, mk, o))
    if "obs_pad" in cases:
        po, pc, pm = (t(inp["pad/obs"]), t(inp["pad/ci"]), t(inp["pad/mk"]))
        px0 = (t(inp["pad/a0"]), t(inp["pad/b0"]))
        o = _toy_options(to, "lm")
        run("obs_pad",
            lambda: sharded_schur_sparse_optimize(px0, toy_pair, po, pc, pm,
                                                  o, mesh=mesh),
            lambda: to.schur_sparse_optimize(
                (px0[0], px0[1][:13]), toy_pair, po[:13], pc[:13], pm[:13],
                o))
    if "obs_se3" in cases:
        so, sc, sm = (t(inp["cor/obs"]), t(inp["cor/ci"]), t(inp["cor/mk"]))
        xt = _ba_x0(inp, "cor")
        o = to.Options(max_iters=10, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False))
        run("obs_se3",
            lambda: sharded_schur_sparse_optimize(xt, ba_pair, so, sc, sm, o,
                                                  mesh=mesh),
            lambda: to.schur_sparse_optimize(xt, ba_pair, so, sc, sm, o))
    slabs = [(t(inp[f"bk/obs{g}"]), t(inp[f"bk/ci{g}"]), t(inp[f"bk/mk{g}"]),
              inp[f"bk/ids{g}"]) for g in range(int(inp["bk/n"]))]
    bxt = _ba_x0(inp, "bk")
    for st in ("lm", "dl"):
        o = to.Options(max_iters=8, max_consec_failures=0,
                       solver_type=(to.DogLeg if st == "dl"
                                    else to.LevenbergMarquardt),
                       hessian=to.HessianOptions(save_last=False))
        run(f"bk_{st}",
            lambda: sharded_schur_sparse_optimize_buckets(
                bxt, ba_pair, slabs, o, mesh=mesh),
            lambda: to.schur_sparse_optimize_buckets(bxt, ba_pair, slabs, o))
    if "cov" in cases:
        cx = (t(inp["cov/a"]), t(inp["cov/b"]))
        cobs = {k: t(inp[f"cov/{k}"]) for k in ("A", "B", "y")}
        cci, cmk = t(inp["cov/ci"]), t(inp["cov/mk"])
        for rescaled in (False, True):
            key = f"cov_{'rescaled' if rescaled else 'plain'}"
            got = sharded_schur_sparse_covariance(
                cx, syn_pair, cobs, cci, cmk, mesh=mesh, rescaled=rescaled)
            res[f"{key}/a"], res[f"{key}/b"] = _flat(got)
            if rank == 0:
                res[f"plain/{key}/a"], res[f"plain/{key}/b"] = _flat(
                    to.schur_sparse_covariance(cx, syn_pair, cobs, cci, cmk,
                                               rescaled=rescaled))
    n = 15                              # divisible by neither 2 nor 4
    _error(res, "err/schur", lambda: sharded_schur_optimize(
        (x0[0], x0[1][:n]), toy_pair, d[:, :n], mask[:, :n], to.Options(),
        mesh=mesh))
    _error(res, "err/obs", lambda: sharded_schur_sparse_optimize(
        (x0[0], x0[1][:n]), toy_pair, obs[:n], ci[:n], mk[:n],
        to.Options(), mesh=mesh))
    return res


SUITES = {"dp": dp_suite, "schur": schur_suite}


def spawn(suite: str, world: int, tmp, inputs: dict) -> list:
    """Write ``inputs`` and start the ``world`` ranks of ``suite`` in the
    directory ``tmp``: ``[(process, out path)]``."""
    import subprocess
    tmp = str(tmp)
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"rank{r}.npz")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r),
             str(world), os.path.join(tmp, "store"), path, out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env), out))
    return procs


def kill(procs: list) -> None:
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def collect(procs: list, deadline: float) -> list:
    """Each rank's results, in rank order; every rank is killed if one
    fails or the wall clock passes ``deadline`` (``time.monotonic()``)."""
    import subprocess
    import time
    try:
        for p, _ in procs:
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError("a rank ran past its time limit")
            if p.returncode:
                raise RuntimeError(f"a rank exited {p.returncode}: "
                                   f"{err.decode()[-3000:]}")
    finally:
        kill(procs)
    return [dict(np.load(out)) for _, out in procs]


def main() -> int:
    suite, rank, world, store, inputs, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from tinyopt_tpu_torch.parallel import init_distributed
    init_distributed(device="cpu", init_method=f"file://{store}",
                     rank=rank, world_size=world)
    try:
        res = SUITES[suite](np.load(inputs), world, rank)
    finally:
        dist.destroy_process_group()
    np.savez(out, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
