"""How near K2's SE3 kernel in float32 lands to the float64 solve, seed by seed.

For each seed, the SE3 instances of ``tests/test_torch_se3.py::
test_k2_se3_on_gpu`` (B = 257, K points, float32, ``bench_se3``'s options,
LM, the dogleg and Gauss-Newton; that test's seed is 20 + B + K) go
through this tree's K2, optionally an earlier tree's K2 (``--parent``),
and this tree's plain twin in float32 and in float64, all on the card.
For each kernel and seed it prints:

* ``miss``: the test's float32 criterion fails (``_se3_kernel_parity``: x
  within rtol 1e-4 and max(1e-5, twice the float32 twin's own gap to the
  float64 twin) of the float32 twin, and the same success);
* ``d64``: max |x - x_f64| over the batch;
* ``path``: the share of instances whose iteration and failure counts equal
  the float64 solve's.  Where they differ, the float32 solve accepted or
  rejected a late step on rounding, and its pose lies elsewhere along the
  cost's flat directions (few points pin a pose loosely).

The float32 twin's own ``d64`` and ``path`` stand beside them.

    python3 se3_accuracy.py [--parent DIR] [--k 3] [--solvers lm,dogleg,gn]
                            [--seeds 40] [--first SEED]

``--parent DIR``: the root of a tree holding an earlier
``tinyopt_tpu_torch/`` package, as for ``k2_bench.py``.  ``--first``: the
first seed (default: the test's, 20 + 257 + K).  Output: one line a seed
and solver, a summary a kernel and solver, the card's name and power
limit, and the record in ``chiprun_out/se3_accuracy.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.utils import _pytree as pytree

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import se3_options  # noqa: E402
from k2_bench import parent_package  # noqa: E402

B = 257


def solve_kernel(pkg, solver, K, seed, dev):
    """One tree's K2 and its plain twin (float32 and float64) on the
    instances of one seed: (x, Output) each."""
    cs = pkg.ops.cuda_solver
    se3 = pkg.models.se3_refinement
    kw = {"lm": {}, "dogleg": {"solver_type": pkg.DogLeg},
          "gn": {"solver_type": pkg.GaussNewton}}[solver]
    opts = se3_options(pkg, **kw)
    data, xb, _ = se3.make_se3_refinement(B, K, dtype=torch.float32,
                                          seed=seed, device=dev)
    x_ex = pytree.tree_map(lambda a: a[0], xb)
    plan = cs.fused_plan(opts, "residuals", x_ex,
                         residual_fn=se3.se3_residual,
                         data_example=type(data)(*(a[0] for a in data)))
    assert plan is not None
    x0 = pkg.manifold.flatten_batch(xb, plan.spec)
    got = cs.fused_solve(se3.se3_residual, opts, x0, data, plan)
    twin = lambda x, d: cs.fused_solve_plain(  # noqa: E731
        se3.se3_residual, opts, x, d, plan)
    return got, (lambda: twin(x0, data)), (
        lambda: twin(x0.double(), type(data)(*(a.double() for a in data))))


def judge(got, t32, t64):
    """miss, d64 and path of one solve (see the module's docstring)."""
    (x, out), (xr, outr), (x64, out64) = got, t32, t64
    gap = float((xr.double() - x64).nan_to_num().abs().max())
    lim = 1e-4 * xr.abs() + max(1e-5, 2 * gap)
    fin = torch.isfinite(x) & torch.isfinite(xr)
    miss = bool(((x - xr).abs() > lim)[fin].any()) or not torch.equal(
        out.succeeded(), outr.succeeded())
    d64 = float((x.double() - x64).nan_to_num().abs().max())
    same = ((out.num_iters == out64.num_iters)
            & (out.num_failures == out64.num_failures))
    return {"miss": miss, "d64": d64, "path": float(same.float().mean()),
            "twin_gap": gap}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--k", default="3")
    ap.add_argument("--solvers", default="lm,dogleg,gn")
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--first", type=int)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("se3_accuracy: no CUDA device", file=sys.stderr)
        return 2
    import tinyopt_tpu_torch as new_pkg
    import tinyopt_tpu_torch.ops.cuda_solver  # noqa: F401
    import tinyopt_tpu_torch.models.se3_refinement  # noqa: F401
    pkgs = {"new": new_pkg}
    if args.parent:
        pkgs["old"] = parent_package(os.path.abspath(args.parent))
        import k2_parent.models.se3_refinement  # noqa: F401
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    rec = {"nvidia_smi": smi, "B": B, "cells": {}}
    for K in (int(k) for k in args.k.split(",")):
        first = args.first if args.first is not None else 20 + B + K
        for solver in args.solvers.split(","):
            rows = {w: [] for w in (*pkgs, "twin")}
            for seed in range(first, first + args.seeds):
                res = {w: solve_kernel(p, solver, K, seed, dev)
                       for w, p in pkgs.items()}
                t32, t64 = res["new"][1](), res["new"][2]()
                line = []
                for w in pkgs:
                    rows[w].append(judge(res[w][0], t32, t64))
                    r = rows[w][-1]
                    line.append(f"{w}: miss {int(r['miss'])} d64 "
                                f"{r['d64']:.3e} path {r['path']:.3f}")
                rows["twin"].append(judge(t32, t32, t64))
                print(f"[seed] K={K} {solver} {seed}: twin gap "
                      f"{rows['twin'][-1]['twin_gap']:.3e} path "
                      f"{rows['twin'][-1]['path']:.3f}; " + "; ".join(line),
                      flush=True)
            cell = rec["cells"][f"K{K}_{solver}"] = {}
            for w, rs in rows.items():
                d = sorted(r["d64"] for r in rs)
                cell[w] = {
                    "misses": sum(r["miss"] for r in rs), "seeds": len(rs),
                    "d64_median": d[len(d) // 2], "d64_max": d[-1],
                    "d64_mean": sum(d) / len(d),
                    "path_mean": sum(r["path"] for r in rs) / len(rs),
                    "first_seed": first}
                print(f"[summary] K={K} {solver} {w}: {cell[w]}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "se3_accuracy.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
