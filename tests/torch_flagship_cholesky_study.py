"""The flagship's "cholesky" cell of ``chip_smoke.py`` (phase 6: batched
SE(3) pose refinement, 10,000 poses x 16 points, float32, bench_se3's
options through ``hessian.solver="cholesky"``) timed for this tree and an
earlier one in turns: earlier, this, this, earlier, each turn a process of
its own that imports its tree's ``tinyopt_tpu_torch`` (a study, not
collected by pytest).

Each turn builds the solver once, makes one untimed warm-up call, then
times ``REPS`` calls on fresh instances (seeds 1000 + rep) with CUDA events
around each call, as phase 6 does, and reports solves/s, every call's ms,
conv and the mean iterations.  The card's name and power limit lead the
output; the record goes to ``chiprun_out/flagship_cholesky_ab.json``.

    git archive <parent> tinyopt_tpu_torch chip_smoke.py | tar -x -C DIR
    python3 tests/torch_flagship_cholesky_study.py --parent DIR
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, statistics, sys
sys.path.insert(0, {root!r})
import torch
from torch.utils import _pytree as pytree
import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.models.se3_refinement import (make_se3_refinement,
                                                     se3_residual)
from chip_smoke import se3_options
assert to.__file__.startswith({root!r}), to.__file__
torch.backends.cuda.matmul.allow_tf32 = False
B, K, REPS = 10_000, 16, {reps}
data, x0, _ = make_se3_refinement(B, K, dtype=torch.float32, seed=3,
                                  device="cuda")
opts = se3_options(to, "cholesky")
solve = to.batched_solver(se3_residual, opts, "residuals",
                          pytree.tree_map(lambda a: a[0], x0),
                          type(data)(*(a[0] for a in data)))
solve(x0, data)
ms, conv, iters = [], [], []
for rep in range(REPS):
    d, x, _ = make_se3_refinement(B, K, dtype=torch.float32, seed=1000 + rep,
                                  device="cuda")
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    _, out = solve(x, d)
    e1.record()
    torch.cuda.synchronize()
    ms.append(e0.elapsed_time(e1))
    conv.append(out.converged().float().mean().item())
    iters.append(out.num_iters.float().mean().item())
print(json.dumps({{"ms": ms, "median_ms": statistics.median(ms),
                  "solves_per_s": REPS * B / (sum(ms) / 1e3),
                  "conv": sum(conv) / REPS,
                  "mean_iters": sum(iters) / REPS}}))
"""


def turn(root: str, reps: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", TURN.format(root=os.path.abspath(root),
                                           reps=reps)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the earlier tree (tinyopt_tpu_torch and "
                         "chip_smoke.py)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[cholesky a/b] {smi}", flush=True)
    turns = []
    for name in ("parent", "this", "this", "parent"):
        r = turn(args.parent if name == "parent" else HERE, args.reps)
        turns.append({"tree": name, **r})
        print(f"[cholesky a/b] {name}: {r['solves_per_s']:.1f} solves/s, "
              f"median call {r['median_ms']:.2f} ms, ms {r['ms']}, conv "
              f"{r['conv']:.4f}, mean iterations {r['mean_iters']:.3f} | "
              f"{smi}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "flagship_cholesky_ab.json"),
              "w") as f:
        json.dump({"card": smi, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
