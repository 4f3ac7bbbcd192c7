"""Where the time goes on tinyopt_tpu_torch's main path, on one CUDA GPU.

Solves the bench problem (``prior_residual``, 50 dims, 10,000 instances,
float32, the options of ``bench.py``) with ``batched_solver`` twice —
``solver="fused"`` (K2) and ``solver="cg"`` (the batch-native loop with
K1) — and the flagship (``models/se3_refinement``, 10,000 poses of 16
points, float32, ``bench_se3``'s options) through "fused", "cg" and
"cholesky", and reports for each, per ``solve`` call on fresh inputs:

* ``wall_ms``: host wall time of the call and a ``torch.cuda.synchronize``,
  profiler off;
* ``device_ms``: under ``torch.profiler``, the union of the intervals of
  every kernel, memcpy and memset on the device during the call (each
  interval counted once; user annotations excluded);
* ``busy_on``: ``device_ms`` over the call's wall time in the same traced
  run (the profiler slows the host, so this understates the share);
  ``busy_off``: ``device_ms`` over the profiler-off ``wall_ms``;
* device time by kernel name, largest first.

    python3 profile_main.py [--calls 3] [--top 12]

Without a CUDA device it exits non-zero.  The record is also written to
``chiprun_out/profile_main.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, DIMS = 10_000, 50


def union_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_solver(to, model, solver, calls, top, dev):
    from chip_smoke import SE3_K, bench_options, se3_options
    from tinyopt_tpu_torch.models.problems import (make_prior_batch,
                                                   prior_residual)
    from tinyopt_tpu_torch.models.se3_refinement import (make_se3_refinement,
                                                         se3_residual)
    from tinyopt_tpu_torch.ops import cuda_cg, cuda_solver
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils import _pytree as pytree

    def inputs(seed):
        if model == "se3":
            data, x0, _ = make_se3_refinement(
                BATCH, SE3_K, dtype=torch.float32, seed=seed, device=dev)
            return data, x0
        g = torch.Generator(device=dev).manual_seed(seed)
        return make_prior_batch(BATCH, DIMS, torch.float32, generator=g,
                                device=dev)

    fn, opts = ((se3_residual, se3_options(to, solver)) if model == "se3"
                else (prior_residual, bench_options(to, solver)))
    data, x0 = inputs(0)
    solve = to.batched_solver(fn, opts, "residuals",
                              pytree.tree_map(lambda a: a[0], x0),
                              type(data)(*(a[0] for a in data)))
    solve(x0, data)                                   # warm-up, untimed
    torch.cuda.synchronize()

    wall = []
    for i in range(calls):
        d_i, x_i = inputs(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(x_i, d_i)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    fresh = [inputs(200 + i) for i in range(calls)]
    torch.cuda.synchronize()
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for d_i, x_i in fresh:
            with record_function("solve_call"):
                solve(x_i, d_i)
                torch.cuda.synchronize()
    launches = {"K1": cuda_cg.cg_solve.launches,
                "K2": cuda_solver.fused_solve.launches}

    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "solve_call"
                     and e.device_type == torch.autograd.DeviceType.CPU)
    dev_ev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name != "solve_call"]
    assert len(windows) == calls, f"found {len(windows)} traced calls"
    assert dev_ev, "the trace holds no device events"

    device_ms, wall_on = [], []
    for s, e in windows:
        inside = [(v.time_range.start, v.time_range.end) for v in dev_ev
                  if s <= v.time_range.start < e]
        device_ms.append(union_us(inside) / 1e3)
        wall_on.append((e - s) / 1e3)
    by_name = {}
    for v in dev_ev:
        by_name.setdefault(v.name, [0.0, 0])
        by_name[v.name][0] += (v.time_range.end - v.time_range.start) / 1e3
        by_name[v.name][1] += 1
    total = sum(t for t, _ in by_name.values())
    kernels = [{"name": n, "ms_per_call": t / calls, "count_per_call":
                c / calls, "share": t / total}
               for n, (t, c) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])][:top]

    dev_mean = statistics.fmean(device_ms)
    rec = {"model": model, "solver": solver, "calls": calls, "wall_ms": wall,
           "wall_ms_profiled": wall_on, "device_ms": device_ms,
           "device_ms_mean": dev_mean,
           "busy_on": dev_mean / statistics.fmean(wall_on),
           "busy_off": dev_mean / statistics.fmean(wall),
           "launches_profiled": launches, "kernels": kernels}
    print(f"[{model} {solver}] wall ms (profiler off) {wall}; wall ms (on) "
          f"{wall_on}; device ms {device_ms}; busy share "
          f"{rec['busy_on']:.4f} (on), {rec['busy_off']:.4f} (vs off wall); "
          f"launches {launches}", flush=True)
    for k in kernels:
        print(f"  {k['ms_per_call']:9.4f} ms  {100 * k['share']:6.2f} %  "
              f"x{k['count_per_call']:g}  {k['name'][:90]}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    import tinyopt_tpu_torch as to

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    record = {"nvidia_smi": smi, "torch": torch.__version__,
              "batch": BATCH, "dims": DIMS,
              "paths": [profile_solver(to, m, s, args.calls, args.top, dev)
                        for m, s in (("prior", "fused"), ("prior", "cg"),
                                     ("se3", "fused"), ("se3", "cg"),
                                     ("se3", "cholesky"))]}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_main.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
