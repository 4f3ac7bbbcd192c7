"""Attribute K2's multi-color time on the card (Powell's and Wood's families).

Copies of two trees are patched under ``tinyopt_tpu_torch/_build/attr/``
(ignored by git; the package itself is never changed):

* ``s248``: the earlier tree (``--parent``, K2 at S = 2 for these families)
  with their register kernels built at S = 2, 4 and 8 and its plan's S
  for them read from ``K2_ATTR_S``;
* ``stamp_parent`` and ``stamp_this``: the earlier tree and this one with
  ``clock64()`` stamps, summed per instance around the linearization
  (with the color sweep), the proposal (the retry loop) and each solve,
  and over the whole loop pass; written into outputs these cells do not
  read (``nres``: the passes, ``nhist``: the solves, ``inlier``: the
  linearization, ``duration``: the proposal, all in cycles).

Then at 10,000 x 4 (``max_iters=200``, no failure budget, the coloring
"auto", ``save_history`` at its default), LM and the dogleg, float32 and
float64: every layout held bit for bit to this tree's K2 (x, iterations,
stop reasons, failures), timed in turns (S = 2, 4, 8, 1, 1, 8, 4, 2; S = 1
is this tree), the stamps' split of an iteration in cycles (the mean over
instances and the slowest instance), and ptxas registers, stack frame and
spills of each instance of these families.

    python3 k2_attribution.py --parent DIR

``DIR``: the root of a tree holding the earlier ``tinyopt_tpu_torch/``
(``git archive <commit> tinyopt_tpu_torch | tar -x -C DIR``).  Output: one
line per cell, the card's name and power limit, and the record in
``chiprun_out/k2_attribution.json``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import MC_STARTS, gpu_ms  # noqa: E402
from k2_bench import ptxas_report  # noqa: E402

B = 10_000
ATTR = os.path.join(HERE, "tinyopt_tpu_torch", "_build", "attr")


def log(*a):
    print(*a, flush=True)


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"k2_attribution: patch point not found once: {old!r}")
    return src.replace(old, new)


def copy_tree(root: str, name: str) -> str:
    dst = os.path.join(ATTR, name, "tinyopt_tpu_torch")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    shutil.copytree(os.path.join(root, "tinyopt_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst


def patch(pkg: str, rel: str, edits) -> None:
    path = os.path.join(pkg, rel)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        src = replace_once(src, old, new)
    with open(path, "w") as f:
        f.write(src)


# clock64 stamps in solver_seg.cuh: (point, text inserted) pairs
STAMPS = [
    ("  int nhist = 0;\n",
     "  int nhist = 0;\n  long long cl_lin = 0, cl_prop = 0, cl_tot = 0, cl_solve = 0;\n"),
    ("    stop = kNone;\n  };",
     "    stop = kNone;\n    cl_lin = cl_prop = cl_tot = cl_solve = 0;\n  };"),
    ("  auto solve = [&](bool damped, T lam_eff, T (&dxn)[E]) -> bool {\n",
     "  auto solve = [&](bool damped, T lam_eff, T (&dxn)[E]) -> bool {\n"
     "    const long long ts_ = clock64();\n"),
    ("    for (int k = 0; k < E; ++k) f = f && (!vt[k] || isfinite(dxn[k]));\n"
     "    return seg_all",
     "    for (int k = 0; k < E; ++k) f = f && (!vt[k] || isfinite(dxn[k]));\n"
     "    cl_solve += clock64() - ts_;\n    return seg_all"),
    ("    const bool act = b < B && it < p.max_iters_total;\n",
     "    const bool act = b < B && it < p.max_iters_total;\n"
     "    const long long t0_ = clock64();\n"),
    ("    // ---- propose, retry with lambda escalation",
     "    const long long t1_ = clock64();\n    cl_lin += t1_ - t0_;\n"
     "    // ---- propose, retry with lambda escalation"),
    ("    // ---- err, dx'dx, g'g in one butterfly",
     "    cl_prop += clock64() - t1_;\n    // ---- err, dx'dx, g'g in one butterfly"),
    ("    // ---- a stopped instance is written out",
     "    cl_tot += clock64() - t0_;\n    // ---- a stopped instance is written out"),
    ("static_cast<int*>(io.nres)[b] = best_nres;",
     "static_cast<int*>(io.nres)[b] = (int)cl_tot;"),
    ("static_cast<int*>(io.nhist)[b] = kHist ? nhist : 0;",
     "static_cast<int*>(io.nhist)[b] = (int)cl_solve;"),
    ("static_cast<float*>(io.inlier)[b] = 1.0f;",
     "static_cast<float*>(io.inlier)[b] = (float)cl_lin;"),
    ("static_cast<float*>(io.duration)[b] = 0.0f;",
     "static_cast<float*>(io.duration)[b] = (float)cl_prop;"),
]


def make_trees(parent: str) -> dict:
    """The three patched copies; returns {name: tree root}."""
    pkg = copy_tree(parent, "s248")
    patch(pkg, "csrc/solver_seg.cuh", [(
        "  if constexpr (s == 2 || (s / 2) * Fam::kSegE < Fam::kMaxM) {",
        "  if constexpr (s <= 8 || (s / 2) * Fam::kSegE < Fam::kMaxM) {")])
    patch(pkg, "ops/cuda_solver.py", [(
        "        while S * E < m:\n            S *= 2\n",
        "        while S * E < m:\n            S *= 2\n"
        "        if family in (3, 4):\n"
        "            S = int(__import__('os').environ['K2_ATTR_S'])\n")])
    patch(copy_tree(parent, "stamp_parent"), "csrc/solver_seg.cuh", STAMPS)
    patch(copy_tree(HERE, "stamp_this"), "csrc/solver_seg.cuh", STAMPS)
    return {n: os.path.join(ATTR, n) for n in ("s248", "stamp_parent",
                                               "stamp_this")}


def load(name: str, root: str):
    """The package under ``root`` imported as ``name``, with its own
    kernels and residual families."""
    pkg = os.path.join(root, "tinyopt_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("ops.cuda_solver", "models.problems", "_build"):
        importlib.import_module(f"{name}.{sub}")
    return mod


def runner(p, name, solver, x0, S=None):
    """K2 of package ``p`` on ``x0``, plan, parameters and tables built
    once (``S``: the layout of the ``s248`` copy)."""
    cs = p.ops.cuda_solver
    fn = {"powell": p.models.problems.powell_singular_residuals,
          "wood": p.models.problems.wood_residuals}[name]
    opts = p.Options(max_iters=200, max_consec_failures=0,
                     solver_type=getattr(p, solver),
                     hessian=p.HessianOptions(solver="fused", save_last=False,
                                              carry_system=False,
                                              diag_coloring="auto"))
    plan = cs.fused_plan(opts, "residuals", x0[0], residual_fn=fn)
    params = cs.k2_params(cs.FAMILIES[fn].id, opts, plan)
    tables = cs.color_tables(plan.coloring, x0.dtype, x0.device)

    def run():
        if S is not None:
            os.environ["K2_ATTR_S"] = str(S)
            cs.k2_launch_plan.cache_clear()
        return cs.fused_solve(fn, opts, x0, None, plan, params, tables)
    return run


def same(a, b) -> bool:
    return (torch.equal(torch.nan_to_num(a[0], 7.0),
                        torch.nan_to_num(b[0], 7.0))
            and all(torch.equal(getattr(a[1], f), getattr(b[1], f))
                    for f in ("num_iters", "stop_reason", "num_failures")))


def split(out) -> dict:
    """The stamps' cycles an iteration: the mean over instances and the
    slowest instance's (by its whole time)."""
    it = out.num_iters.double().clamp(min=1)
    parts = {"pass": out.final_cost.num_residuals.double(),
             "solves": out.num_hist.double(),
             "linearize": out.final_cost.inlier_ratio.double(),
             "propose": out.duration_ms.double()}
    parts["accept_rest"] = parts["pass"] - parts["linearize"] - parts["propose"]
    slow = int(torch.argmax(parts["pass"]))
    return {"mean": {k: (v / it).mean().item() for k, v in parts.items()},
            "slowest": {k: (v[slow] / it[slow]).item()
                        for k, v in parts.items()},
            "slowest_iters": int(out.num_iters[slow])}


def kernel_lines(lines) -> list[str]:
    return [ln for ln in lines if "Powell" in ln or "Wood" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_attribution: no CUDA device", file=sys.stderr)
        return 2
    import tinyopt_tpu_torch as this
    import tinyopt_tpu_torch.ops.cuda_solver  # noqa: F401
    import tinyopt_tpu_torch.models.problems  # noqa: F401
    from tinyopt_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    pk = {"this": this}
    for name, root in make_trees(os.path.abspath(args.parent)).items():
        pk[name] = load(f"attr_{name}", root)
    builds = {n: (_build if n == "this" else sys.modules[f"attr_{n}._build"])
              for n in pk}
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda b: b.load(), builds.values()))
    rec = {"nvidia_smi": smi, "shape": [B, 4],
           "ptxas": {n: kernel_lines(ptxas_report(builds[n]))
                     for n in ("this", "s248")},
           "cells": {}}
    for n, lines in rec["ptxas"].items():
        for ln in lines:
            log(f"[ptxas {n}] {ln}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        for name in ("powell", "wood"):
            for solver in ("LevenbergMarquardt", "DogLeg"):
                key = f"{name} {solver} {str(dtype).split('.')[-1]}"
                x0 = (torch.tensor(MC_STARTS[name], dtype=dtype, device=dev)
                      + 0.1 * torch.randn((B, 4), generator=gen, dtype=dtype,
                                          device=dev))
                lay = {"S1": runner(this, name, solver, x0)}
                for S in (2, 4, 8):
                    lay[f"S{S}"] = runner(pk["s248"], name, solver, x0, S)
                ref = lay["S1"]()
                r = rec["cells"][key] = {
                    "equal_to_S1": {k: same(f(), ref) for k, f in lay.items()
                                    if k != "S1"},
                    "iters_mean_max": [
                        ref[1].num_iters.float().mean().item(),
                        ref[1].num_iters.max().item()]}
                r["turns_ms"] = [[k, gpu_ms(lay[k], n=3)] for k in (
                    "S2", "S4", "S8", "S1", "S1", "S8", "S4", "S2")]
                for sn in ("stamp_parent", "stamp_this"):
                    _, out = runner(pk[sn], name, solver, x0)()
                    torch.cuda.synchronize()
                    r[sn] = split(out)
                assert all(r["equal_to_S1"].values()), key
                log(f"[cell] {key}: {json.dumps(r)}")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k2_attribution.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
