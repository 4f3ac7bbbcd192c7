"""Multi-rank dry run: the six scale-out axes of the JAX package's
``dryrun_multichip``, each held against the unsharded solve.

    python -m tinyopt_tpu_torch.parallel.dryrun N [--device cpu|cuda]

spawns N ranks of ``torch.distributed`` (a ``file://`` store in a
temporary directory, no network); each rank runs every axis and prints its
``[dryrun]`` lines, and the command exits non-zero if any rank fails or the
time limit (``--timeout`` seconds) passes; then every rank is killed.  On
"cuda" the ranks share the cards round-robin; NCCL takes one rank a card,
so where there are more ranks than cards the backend is gloo.  The axes,
at the JAX package's sizes:

* dp — 4·N SE(3) refinements (8 points) over the flattened (batch, block)
  mesh, a full converged solve, against the same batch unsharded;
* block — 8·N prior blocks of 16 dims, the normal equations summed over
  the axis, against the dense solve of the stacked residual;
* schur — landmark-sharded dense-grid BA (4 cameras, 4·N landmarks);
* schur_obs — landmark-sharded point-major BA (6 cameras, 8·N landmarks);
* bucketed — a heavy-tailed point-major BA in K-buckets, and the sharded
  marginal covariance against the bucketed one on a well-posed pair;
* chain — a dp-sharded batch of 2·N pose graphs (12 nodes + a loop).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _close(got, want, rtol, atol, what):
    got = torch.as_tensor(got).detach().cpu().double()
    want = torch.as_tensor(want).detach().cpu().double()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        gap = (got - want).abs().max().item()
        raise AssertionError(f"{what}: max gap {gap:.3e} (rtol {rtol}, "
                             f"atol {atol})")


def run_axes(n: int, device: str, rank: int) -> None:
    """Every axis on this rank (the process group is up)."""
    import tinyopt_tpu_torch as to
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.chain import chain_system
    from tinyopt_tpu_torch.models.bundle_adjustment import (
        make_ba_problem, make_ba_problem_sparse, project)
    from tinyopt_tpu_torch.models.problems import (make_prior_batch,
                                                   prior_residual)
    from tinyopt_tpu_torch.models.se3_refinement import (make_se3_refinement,
                                                         se3_residual)
    from tinyopt_tpu_torch.ops.schur_obs import bucket_obs
    from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc
    from tinyopt_tpu_torch.parallel import (
        batched_optimize, local_mesh, make_mesh, sharded_optimize,
        sharded_schur_optimize, sharded_schur_sparse_covariance,
        sharded_schur_sparse_optimize, sharded_schur_sparse_optimize_buckets)
    from tinyopt_tpu_torch.parallel.batched import shard_instances

    f32 = torch.float32
    tag = f"[rank {rank}]"

    def say(line):
        sys.stdout.write(f"[dryrun] {line} {tag}\n")    # one write a line
        sys.stdout.flush()

    block = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(batch=n // block, block=block, device=device)
    dp = ("batch", "block")
    flat_mesh = local_mesh("block", device=device)

    # --- dp: instances over the whole mesh, a full converged solve ---
    bsz = 4 * n
    data, x0, _ = make_se3_refinement(bsz, n_points=8, dtype=f32,
                                      device=device)
    opts = to.Options(max_iters=10,
                      hessian=to.HessianOptions(save_last=False))
    x_opt, out = batched_optimize(x0, se3_residual, opts, data_batch=data,
                                  mode="residuals", mesh=mesh, axis=dp)
    assert int(out.num_iters.sum()) >= bsz, "dp step did not run"
    assert bool(out.succeeded().all()), f"dp stops {out.stop_reason}"
    assert bool(out.converged().all()), f"dp stops {out.stop_reason}"
    x_ref, out_ref = batched_optimize(x0, se3_residual, opts,
                                      data_batch=data, mode="residuals")
    _close(out.final_cost.cost, out_ref.final_cost.cost, 1e-5, 1e-7,
           "dp cost")
    _close(x_opt.translation, x_ref.translation, 1e-4, 1e-5,
           "dp translation")
    assert torch.equal(out.stop_reason, out_ref.stop_reason), "dp stops"
    say(f"dp: {bsz} instances over {n} devices converged (mean cost "
        f"{out.final_cost.cost.mean().item():.3e}, parity with "
        f"single-device solve ok)")

    # --- block: one problem, its residual blocks summed over the axis ---
    pdata, px0 = make_prior_batch(8 * n, 16, f32, device=device)
    x2, out2 = sharded_optimize(px0[0], prior_residual, pdata,
                                to.Options(max_iters=10), mesh=flat_mesh,
                                axis="block")
    assert bool(out2.succeeded()), int(out2.stop_reason)
    assert bool(out2.converged()), int(out2.stop_reason)

    def dense_fn(x):
        return torch.cat([prior_residual(x, type(pdata)(*(a[i] for a in
                                                          pdata)))
                          for i in range(8 * n)])

    x_d, out_d = to.optimize(px0[0], dense_fn, to.Options(max_iters=10))
    # float32: the order of the sums can move the stop by an iteration
    _close(x2, x_d, 0.0, 5e-4, "block x")
    _close(out2.final_cost.cost, out_d.final_cost.cost, 1e-3, 1e-6,
           "block cost")
    say(f"block: {8 * n} residual blocks psum-reduced over {n} devices "
        f"converged (cost {out2.final_cost.cost.item():.3e} == dense solve)")

    # --- schur: landmark-sharded dense-grid BA ---
    bad, bax0, _ = make_ba_problem(n_cams=4, n_pts=4 * n, noise=1e-4, seed=5,
                                   dtype=f32, device=device)

    def pair_fn(pose, point, obs):
        return project(pose, point[None, :])[0] - obs

    ba_opts = to.Options(max_iters=8, max_consec_failures=0,
                         hessian=to.HessianOptions(save_last=False)
                         ).for_dtype(f32)
    xt = (bax0["poses"], bax0["points"])
    x_sh, out_sh = sharded_schur_optimize(xt, pair_fn, bad.observations,
                                          bad.mask, ba_opts, mesh=flat_mesh,
                                          axis="block")
    assert bool(out_sh.succeeded()), int(out_sh.stop_reason)
    x_s1, out_s1 = to.schur_optimize(xt, pair_fn, bad.observations,
                                     bad.mask, ba_opts)
    # float32 + BA's gauge freedom: parity on the solution's quality
    _close(out_sh.final_cost.cost, out_s1.final_cost.cost, 1e-2, 1e-8,
           "schur cost")
    _close(x_sh[1], x_s1[1], 5e-2, 1e-3, "schur points")
    say(f"schur: {4 * n} landmarks sharded over {n} devices, BA converged "
        f"(cost {out_sh.final_cost.cost.item():.3e} == single-device)")

    # --- schur_obs: landmark-sharded point-major BA ---
    n_pts = 8 * n
    (sobs, cam_idx, smask), sx0, _ = make_ba_problem_sparse(
        n_cams=6, n_pts=n_pts, k_obs=3, noise=1e-4, seed=3, dtype=f32,
        device=device)
    sxt = (sx0["poses"], sx0["points"])
    x_so, out_so = sharded_schur_sparse_optimize(
        sxt, pair_fn, sobs, cam_idx, smask, ba_opts, mesh=flat_mesh,
        axis="block")
    assert bool(out_so.succeeded()), int(out_so.stop_reason)
    x_o1, out_o1 = to.schur_sparse_optimize(sxt, pair_fn, sobs, cam_idx,
                                            smask, ba_opts)
    _close(out_so.final_cost.cost, out_o1.final_cost.cost, 1e-2, 1e-8,
           "schur_obs cost")
    _close(x_so[1], x_o1[1], 5e-2, 1e-3, "schur_obs points")
    say(f"schur_obs: {n_pts} point-major landmarks sharded over {n} "
        f"devices, sparse-obs BA converged (cost "
        f"{out_so.final_cost.cost.item():.3e} == single-device)")

    # --- bucketed: heavy-tailed K-buckets over the mesh, and the sharded
    # covariance against the bucketed one on a well-posed pair ---
    n_bp = 8 * n
    (bobs, bci, bmk), bx0, _ = make_ba_problem_sparse(
        n_cams=6, n_pts=n_bp, k_obs=4, noise=1e-4, seed=9, dtype=f32,
        device=device)
    bmk = bmk.clone()
    bmk[: (3 * n_bp) // 4, 2:] = 0.0        # most keep 2 rays, a few 4
    bci = torch.where(bmk > 0, bci, torch.zeros_like(bci))
    slabs = bucket_obs(bobs, bci, bmk, min_bucket=max(2, n // 2))
    assert len(slabs) >= 2, "bucketing degenerated to one slab"
    bxt = (bx0["poses"], bx0["points"])
    x_bk, out_bk = sharded_schur_sparse_optimize_buckets(
        bxt, pair_fn, slabs, ba_opts, mesh=flat_mesh, axis="block")
    assert bool(out_bk.succeeded()), int(out_bk.stop_reason)
    x_b1, out_b1 = to.schur_sparse_optimize_buckets(bxt, pair_fn, slabs,
                                                    ba_opts)
    _close(out_bk.final_cost.cost, out_b1.final_cost.cost, 1e-2, 1e-8,
           "bucketed cost")
    _close(x_bk[1], x_b1[1], 5e-2, 1e-3, "bucketed points")
    rng = np.random.default_rng(17)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=device)

    ca, cb = t(rng.normal(size=(4, 3))), t(rng.normal(size=(n_bp, 2)))
    cobs = {"A": t(rng.normal(size=(n_bp, 3, 4, 3))),
            "B": t(rng.normal(size=(n_bp, 3, 4, 2))),
            "y": t(rng.normal(size=(n_bp, 3, 4)))}
    cci = torch.as_tensor(rng.integers(0, 4, size=(n_bp, 3)), device=device)
    cmk = np.asarray(rng.random((n_bp, 3)) < 0.8, np.float32)
    cmk[: n_bp // 2, 2:] = 0.0              # heavy tail: >= 2 buckets
    cmk[:, 0] = 1.0
    cmk = t(cmk)

    def syn_pair(cam, pt, d):
        return d["A"] @ cam + d["B"] @ pt - d["y"]

    cslabs = bucket_obs(cobs, cci, cmk, min_bucket=max(2, n // 2))
    assert len(cslabs) >= 2
    cov_bk = to.schur_sparse_covariance_buckets((ca, cb), syn_pair, cslabs)
    cov_sh = sharded_schur_sparse_covariance((ca, cb), syn_pair, cobs, cci,
                                             cmk, mesh=flat_mesh,
                                             axis="block")
    for a, b, w in zip(cov_sh, cov_bk, ("cov_a", "cov_b")):
        _close(a, b, 5e-3, 1e-6, f"bucketed {w}")
    say(f"bucketed: {n_bp} heavy-tail landmarks in {len(slabs)} buckets "
        f"sharded over {n} devices, BA converged (cost "
        f"{out_bk.final_cost.cost.item():.3e} == single-device bucketed; "
        f"bucketed marginals == sharded covariance)")

    # --- chain: a dp-sharded batch of pose graphs ---
    nn_, bc = 12, 2 * n
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(bc, nn_, 3)).astype(np.float32), axis=1)
    edges = np.stack([np.arange(nn_ - 1), np.arange(1, nn_)], 1)
    edges = np.concatenate([edges, [[2, nn_ - 2]]])
    meas = np.concatenate(
        [gt[:, 1:] - gt[:, :-1], (gt[:, nn_ - 2] - gt[:, 2])[:, None]],
        axis=1) + 1e-3 * rng.normal(size=(bc, nn_, 3)).astype(np.float32)
    xc0 = t(gt + 0.05 * rng.normal(size=gt.shape).astype(np.float32))
    anchors = t(gt[:, :1])
    spec_c = mf.tangent_spec(xc0[0])
    chain_opts = to.Options(max_iters=8,
                            hessian=to.HessianOptions(save_last=False)
                            ).for_dtype(f32)

    def chain_solve(xc, md, an):
        acc, ev, _, prop = chain_system(
            xc[0], lambda a, b, d: (b - a) - d, edges, md,
            lambda a, d: a - d, [0], an, spec_c)
        return optimize_from_acc(xc.reshape(xc.shape[0], -1), acc, ev,
                                 chain_opts, spec_c, propose=prop)

    x_c, out_c = shard_instances(chain_solve, (xc0, t(meas), anchors), mesh,
                                 dp)
    assert bool(out_c.succeeded().all()), out_c.stop_reason
    x_c1, out_c1 = chain_solve(xc0, t(meas), anchors)
    _close(out_c.final_cost.cost, out_c1.final_cost.cost, 1e-5, 1e-7,
           "chain cost")
    _close(x_c, x_c1, 1e-4, 1e-5, "chain x")
    say(f"chain: {bc} pose graphs (N={nn_} + loop closure, direct "
        f"block-tridiag solves) dp-sharded over {n} devices (mean cost "
        f"{out_c.final_cost.cost.mean().item():.3e}, parity with unsharded "
        f"batch ok)")
    say("ok")


def _rank_main(args) -> int:
    from tinyopt_tpu_torch.parallel import init_distributed
    import torch.distributed as dist

    torch.set_num_threads(1)
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if args.n <= cards else "gloo"
        local_rank = args.rank % max(cards, 1)
    else:
        backend, local_rank = "gloo", None
    init_distributed(device=args.device, backend=backend,
                     local_rank=local_rank,
                     init_method=f"file://{args.store}", rank=args.rank,
                     world_size=args.n)
    try:
        run_axes(args.n, args.device, args.rank)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("dryrun: --device cuda without a CUDA device",
                  file=sys.stderr)
            return 2
        from tinyopt_tpu_torch import _build
        _build.load()            # once, before the ranks look for it
        cards = torch.cuda.device_count()
        print(f"[dryrun] {args.n} ranks on {cards} card(s), backend "
              f"{'nccl' if args.n <= cards else 'gloo'}", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tinyopt_tpu_torch.parallel.dryrun",
             str(args.n), "--device", args.device, "--rank", str(r),
             "--store", os.path.join(tmp, "store")], env=env)
            for r in range(args.n)]
        rc = 0
        try:
            while any(q.poll() is None for q in procs):
                failed = [q.returncode for q in procs
                          if q.returncode not in (None, 0)]
                if failed:
                    rc = failed[0]
                    break
                if time.perf_counter() - t0 > args.timeout:
                    print(f"dryrun: ranks still running after "
                          f"{args.timeout:.0f} s", file=sys.stderr)
                    rc = 124
                    break
                time.sleep(0.1)
            else:
                rc = next((q.returncode for q in procs if q.returncode), 0)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
    print(f"[dryrun] {args.n} ranks on {args.device}: "
          f"{'ok' if rc == 0 else f'FAILED (exit {rc})'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
