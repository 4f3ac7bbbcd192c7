"""Two CPU studies behind the chain solver's float32 gate and its Jacobian
mode (a study, not collected by pytest; ~1 min on the CPU).

1. Where a float32 pose-graph solve stops.  The JAX package's and the
   port's ``pose_graph_optimize`` on the JAX package's float32 graph of 500
   poses + 30 loop closures (σ = 1e-3, seed 4), with bench_pose_graph's
   options (``benchmarks/run_benchmarks.py:394-420``), by the scan and by
   cyclic reduction: stop reason, iterations, failures and cost of each.
   At the χ² floor the float32 step and relative-decrease floors rarely
   fire, so a solve may end MAX_CONSEC_NO_DECR (7), a success; the bench
   gates on ``succeeded()`` and the cost for that reason.

2. Why the chain takes its edge Jacobians in reverse mode.  How many calls
   into ``torch._refs`` (Python decompositions) one Jacobian of ``x + 1.0``,
   ``2.0 * x`` and ``x * x`` makes under ``torch.func.jacfwd`` and under
   ``jacrev``: forward mode decomposes every operation that mixes a
   constant with a dual tensor.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_pose_graph_f32_study.py
"""

import cProfile
import pstats

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.models import pose_graph as jpg

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.interop import pose_graph_data_from_numpy, se3_from_numpy
from tinyopt_tpu_torch.models import pose_graph as tpg


def stops(n_poses=500, loops=30):
    jd, jx0, _ = jpg.make_pose_graph(n_poses, loops, noise=1e-3,
                                     init_noise=0.05, seed=4,
                                     dtype=jnp.float32)
    jopts = jto.Options(hessian=jto.HessianOptions(save_last=False)
                        ).for_dtype(jnp.float32)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jd)]
    td = pose_graph_data_from_numpy(*leaves, device="cpu",
                                    dtype=torch.float32)
    tx0 = se3_from_numpy(*[np.asarray(a) for a in
                           jax.tree_util.tree_leaves(jx0)], device="cpu",
                         dtype=torch.float32)
    topts = to.Options(hessian=to.HessianOptions(save_last=False)
                       ).for_dtype(torch.float32)
    for method in ("scan", "cr"):
        _, o = jpg.pose_graph_optimize(jx0, jd, jopts, method=method)
        print(f"JAX  {method:4s}: stop {int(o.stop_reason)}, "
              f"{int(o.num_iters)} iterations, {int(o.num_failures)} "
              f"failures, cost {float(o.final_cost.cost):.6e}", flush=True)
        _, o = tpg.pose_graph_optimize(tx0, td, topts, method=method)
        print(f"port {method:4s}: stop {int(o.stop_reason)}, "
              f"{int(o.num_iters)} iterations, {int(o.num_failures)} "
              f"failures, cost {float(o.final_cost.cost):.6e}", flush=True)


def refs_calls(fn, x) -> int:
    pr = cProfile.Profile()
    pr.enable()
    fn(x)
    pr.disable()
    return sum(v[0] for k, v in pstats.Stats(pr).stats.items()
               if "torch/_refs" in k[0])


def decompositions():
    x = torch.randn(3)
    for name, f in (("x + 1.0", lambda v: v + 1.0),
                    ("2.0 * x", lambda v: 2.0 * v),
                    ("x * x", lambda v: v * v)):
        print(f"{name}: torch._refs calls, jacfwd "
              f"{refs_calls(torch.func.jacfwd(f), x)}, jacrev "
              f"{refs_calls(torch.func.jacrev(f), x)}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    stops()
    decompositions()
