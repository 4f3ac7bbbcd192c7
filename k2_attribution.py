"""Attribute K2's time on the card: the multi-color branch (Powell's and
Wood's families, ``--family mc``) or the SE3 family (``--family se3``).

Copies of two trees are patched under ``tinyopt_tpu_torch/_build/attr/``
(ignored by git; the package itself is never changed).  ``--family mc``:

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

``--family se3``: ``se3_stamp_parent`` and ``se3_stamp_this``, the
earlier tree (its SE3 instances of the generic register kernel) and this
one (``solver_se3_kernel``) with ``clock64()`` stamps summed per instance
around the linearization with g, diag(H) (the earlier tree's per-dimension
sweeps; this tree's H from the points, built once an instance), the
proposal (the retry loop), each PCG solve and the retraction, and over the
whole loop pass (written into ``nres``: the passes, ``nhist``: the solves,
``inlier``: the linearization, ``duration``: diag(H), ``rerr``: the
retraction, ``lam``: the proposal, all in cycles); and ``se3_geoms``, this
tree built for more geometries — (S, points a lane) = (16, 1), (8, 2),
(4, 4), (2, 8) — its plan's points a lane and warps a block read from
``K2_ATTR_NP`` and ``K2_ATTR_W``; ``se3_geoms_regs`` the same with each
lane's points held in registers from the instance's start (the package
reads them through the read-only cache at each pass).  Then at 10,000 poses x 16 points
(``bench_se3``'s options, ``save_history`` at its default), LM and the
dogleg, float32 and float64, and LM at ``max_iters=0``: every layout held
to this tree's twin (``chip_smoke.se3_check``), timed in turns (the
earlier tree, then each geometry, then back), the stamps' split of an
iteration, and ptxas registers, stack frame and spills of the SE3
instances.  ``--split-only``: the earlier tree's stamps, and ptxas of
both trees, alone.

    python3 k2_attribution.py --parent DIR [--family mc|se3] [--split-only]

``DIR``: the root of a tree holding the earlier ``tinyopt_tpu_torch/``
(``git archive <commit> tinyopt_tpu_torch | tar -x -C DIR``).  Output: one
line per cell, the card's name and power limit, and the record in
``chiprun_out/k2_attribution.json`` (``k2_attribution_se3.json``).
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
from torch.utils import _pytree as pytree

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import MC_STARTS, gpu_ms, se3_check, se3_options  # noqa: E402
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


# this tree's solver_se3_kernel keeps the instance's book (InstanceBook)
# and writes its scalars by book.write: the counters are the kernel's,
# written after it
THIS_DECL = [
    ("  InstanceBook<T, kDogLeg, kHist> book;\n",
     "  InstanceBook<T, kDogLeg, kHist> book;\n  long long cl_lin = 0, "
     "cl_diag = 0, cl_prop = 0, cl_tot = 0, cl_solve = 0, cl_ret = 0;\n"),
    ("    book.start(p);\n  };",
     "    book.start(p);\n    cl_lin = cl_diag = cl_prop = cl_tot = cl_solve = "
     "cl_ret = 0;\n  };"),
]


def this_writes(fields) -> list:
    """After the kernel's book.write, lane 0 writes the counters into
    ``fields`` ({output: counter})."""
    body = "".join(f"        {k} = {v};\n" for k, v in fields.items())
    return [("      book.write(io, b, sl);\n",
             "      book.write(io, b, sl);\n      if (sl == 0) {\n" + body
             + "      }\n")]


# clock64 stamps of the SE3 split, the earlier tree's generic register
# kernel (solver_seg.cuh): (point, text inserted) pairs
SE3_DECL = [
    ("  int nhist = 0;\n",
     "  int nhist = 0;\n  long long cl_lin = 0, cl_diag = 0, cl_prop = 0, "
     "cl_tot = 0, cl_solve = 0, cl_ret = 0;\n"),
    ("    stop = kNone;\n  };",
     "    stop = kNone;\n    cl_lin = cl_diag = cl_prop = cl_tot = cl_solve = "
     "cl_ret = 0;\n  };"),
]
SE3_WRITES = [
    ("static_cast<T*>(io.rerr)[b] = final_rerr;",
     "static_cast<T*>(io.rerr)[b] = (T)cl_ret;"),
    ("static_cast<T*>(io.lam)[b] = lam;", "static_cast<T*>(io.lam)[b] = (T)cl_prop;"),
    ("static_cast<int*>(io.nres)[b] = best_nres;",
     "static_cast<int*>(io.nres)[b] = (int)cl_tot;"),
    ("static_cast<int*>(io.nhist)[b] = kHist ? nhist : 0;",
     "static_cast<int*>(io.nhist)[b] = (int)cl_solve;"),
    ("static_cast<float*>(io.inlier)[b] = 1.0f;",
     "static_cast<float*>(io.inlier)[b] = (float)cl_lin;"),
    ("static_cast<float*>(io.duration)[b] = 0.0f;",
     "static_cast<float*>(io.duration)[b] = (float)cl_diag;"),
]
SE3_STAMPS_PARENT = SE3_DECL + [
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
    ("    if constexpr (kColor == kColorIdentity) {\n      T ones[E], jp[E];",
     "    const long long ta_ = clock64();\n    cl_lin += ta_ - t0_;\n"
     "    if constexpr (kColor == kColorIdentity) {\n      T ones[E], jp[E];"),
    ("    if (p.grad_clipping > 0) {",
     "    cl_diag += clock64() - ta_;\n    if (p.grad_clipping > 0) {"),
    ("    // ---- propose, retry with lambda escalation",
     "    const long long t1_ = clock64();\n"
     "    // ---- propose, retry with lambda escalation"),
    ("    // ---- err, dx'dx, g'g in one butterfly",
     "    cl_prop += clock64() - t1_;\n    // ---- err, dx'dx, g'g in one butterfly"),
    ("    if constexpr (Fam::kManifold) {\n      // x (+) dx from the rollback",
     "    const long long tr_ = clock64();\n"
     "    if constexpr (Fam::kManifold) {\n      // x (+) dx from the rollback"),
    ("    // ---- a stopped instance is written out",
     "    cl_ret += clock64() - tr_;\n    cl_tot += clock64() - t0_;\n"
     "    // ---- a stopped instance is written out"),
] + SE3_WRITES
# the same split in this tree's solver_se3_kernel (solver_se3.cuh); diag(H)
# is a new instance's H from its points (two passes and their butterflies)
SE3_STAMPS_THIS = THIS_DECL + [
    ("  auto solve = [&](bool damped, T lam_eff, T (&dxn)[D]) -> bool {\n",
     "  auto solve = [&](bool damped, T lam_eff, T (&dxn)[D]) -> bool {\n"
     "    const long long ts_ = clock64();\n"),
    ("    return finite6(dxn);\n  };\n\n  // The Powell dogleg",
     "    cl_solve += clock64() - ts_;\n    return finite6(dxn);\n  };\n\n"
     "  // The Powell dogleg"),
    ("  while (warp_any<S>(b < B)) {\n",
     "  while (warp_any<S>(b < B)) {\n    const long long t0_ = clock64();\n"),
    ("    const bool act = b < B && book.it < p.max_iters_total;\n",
     "    const long long ta_ = clock64();\n    cl_diag += ta_ - t0_;\n"
     "    const bool act = b < B && book.it < p.max_iters_total;\n"),
    ("    if (p.grad_clipping > 0) {",
     "    cl_lin += clock64() - ta_;\n    if (p.grad_clipping > 0) {"),
    ("    // ---- propose, retry with lambda escalation; judge",
     "    const long long t1_ = clock64();\n"
     "    // ---- propose, retry with lambda escalation; judge"),
    ("    if (act) {\n      const auto m = book.judge(",
     "    cl_prop += clock64() - t1_;\n"
     "    if (act) {\n      const auto m = book.judge("),
    ("      T xn[P];\n", "      const long long tr_ = clock64();\n      T xn[P];\n"),
    ("        x[i] = xn[i];\n      }\n    }\n",
     "        x[i] = xn[i];\n      }\n      cl_ret += clock64() - tr_;\n    }\n"),
    ("    // ---- a stopped instance is written out",
     "    cl_tot += clock64() - t0_;\n    // ---- a stopped instance is written out"),
] + this_writes({
    "static_cast<T*>(io.rerr)[b]": "(T)cl_ret",
    "static_cast<T*>(io.lam)[b]": "(T)cl_prop",
    "static_cast<int*>(io.nres)[b]": "(int)cl_tot",
    "static_cast<int*>(io.nhist)[b]": "(int)cl_solve",
    "static_cast<float*>(io.inlier)[b]": "(float)cl_lin",
    "static_cast<float*>(io.duration)[b]": "(float)cl_diag"})
# this tree at more geometries, the plan's from the environment
SE3_GEOMS = [(16, 1), (8, 2), (4, 4), (2, 8)]


def make_se3_trees(parent: str, split_only: bool) -> dict:
    """The SE3 copies (``split_only``: the earlier tree's stamps alone);
    returns {name: tree root}."""
    patch(copy_tree(parent, "se3_stamp_parent"), "csrc/solver_seg.cuh",
          SE3_STAMPS_PARENT)
    names = ["se3_stamp_parent"]
    if not split_only:
        patch(copy_tree(HERE, "se3_stamp_this"), "csrc/solver_se3.cuh",
              SE3_STAMPS_THIS)
        make_geoms_tree("se3_geoms", [])
        make_geoms_tree("se3_geoms_regs", SE3_POINTS_IN_REGISTERS)
        names += ["se3_stamp_this", "se3_geoms", "se3_geoms_regs"]
    return {n: os.path.join(ATTR, n) for n in names}


# the lane's points held in registers from the instance's start, where the
# kernel reads them through the read-only cache at each pass
SE3_POINTS_IN_REGISTERS = [
    ("  auto point = [&](int j, T (&v)[6]) {\n    const int i = sl + j * S;",
     "  T pts_[NP][6];\n  auto point = [&](int j, T (&v)[6]) {\n"
     "    for (int c = 0; c < 6; ++c) v[c] = pts_[j][c];\n  };\n"
     "  auto load_point = [&](int j, T (&v)[6]) {\n"
     "    const int i = sl + j * S;"),
    ("    bl = b < B ? b : B - 1;\n",
     "    bl = b < B ? b : B - 1;\n"
     "    for (int j = 0; j < NP; ++j) load_point(j, pts_[j]);\n"),
]


def make_geoms_tree(name: str, edits) -> None:
    """This tree built for ``SE3_GEOMS`` with ``edits`` to its SE3 kernel,
    its plan's points a lane and warps a block from the environment."""
    pkg = copy_tree(HERE, name)
    patch(pkg, "csrc/solver_se3.cuh", [
        ("#define K2_SE3_GEOMETRIES(X, np) X(1, np) X(2, np) X(4, np) X(8, np)",
         "#define K2_SE3_GEOMETRIES(X, np) "
         + " ".join(f"X({s}, {n})" for s, n in SE3_GEOMS))] + edits)
    patch(pkg, "ops/cuda_solver.py", [
        ("            E, S, m = SE3_POINTS[itemsize], 1, n_res // 3   "
         "# E points a lane\n",
         "            E, S, m = SE3_POINTS[itemsize], 1, n_res // 3   "
         "# E points a lane\n"
         "            E = int(__import__('os').environ['K2_ATTR_NP'])\n"),
        ("        warps = max(1, min(1 if S == 1 else SEG_WARPS, "
         "-(-B // per_warp)))",
         "        warps = max(1, min(int(__import__('os').environ.get("
         "'K2_ATTR_W', 1 if S == 1 else SEG_WARPS)), -(-B // per_warp)))")])


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
    for sub in ("ops.cuda_solver", "models.problems", "models.se3_refinement",
                "_build"):
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


SE3_K = 16


def se3_runner(p, opts_kw, dtype, dev, env=None):
    """(run, twin) of package ``p``'s K2 on the flagship's 10,000 x 16 poses
    of seed 11 (``env``: the environment of the ``se3_geoms`` plan)."""
    cs = p.ops.cuda_solver
    se3 = p.models.se3_refinement
    opts = se3_options(p, **opts_kw(p))
    data, xb, _ = se3.make_se3_refinement(B, SE3_K, dtype=dtype, seed=11,
                                          device=dev)
    x_ex = pytree.tree_map(lambda a: a[0], xb)
    plan = cs.fused_plan(opts, "residuals", x_ex,
                         residual_fn=se3.se3_residual,
                         data_example=type(data)(*(a[0] for a in data)))
    x0 = p.manifold.flatten_batch(xb, plan.spec)
    params = cs.k2_params(2, opts, plan)

    def run():
        if env is not None:
            os.environ.update(env)
            cs.k2_launch_plan.cache_clear()
        return cs.fused_solve(se3.se3_residual, opts, x0, data, plan, params)
    return run, lambda: cs.fused_solve_plain(se3.se3_residual, opts, x0,
                                             data, plan)


def se3_split(out) -> dict:
    """The SE3 stamps' cycles an iteration: the mean over instances and
    the slowest instance's (by its whole time)."""
    it = out.num_iters.double().clamp(min=1)
    parts = {"pass": out.final_cost.num_residuals.double(),
             "solves": out.num_hist.double(),
             "linearize_g": out.final_cost.inlier_ratio.double(),
             "diag_H": out.duration_ms.double(),
             "propose": out.final_lambda.double(),
             "retract": out.final_rerr_dec.double()}
    parts["propose_not_solves"] = parts["propose"] - parts["solves"]
    parts["accept_stop_rest"] = (parts["pass"] - parts["linearize_g"]
                                 - parts["diag_H"] - parts["propose"]
                                 - parts["retract"])
    slow = int(torch.argmax(parts["pass"]))
    return {"mean": {k: (v / it).mean().item() for k, v in parts.items()},
            "slowest": {k: (v[slow] / it[slow]).item()
                        for k, v in parts.items()},
            "slowest_iters": int(out.num_iters[slow]),
            "mean_iters": out.num_iters.double().mean().item()}


def se3_kernel_lines(lines) -> list[str]:
    return [ln for ln in lines if "SE3" in ln or "se3" in ln]


def main_se3(args, smi) -> int:
    import tinyopt_tpu_torch as this
    import tinyopt_tpu_torch.models.se3_refinement  # noqa: F401
    import tinyopt_tpu_torch.ops.cuda_solver  # noqa: F401
    from tinyopt_tpu_torch import _build

    roots = make_se3_trees(os.path.abspath(args.parent), args.split_only)
    pk = {"this": this}
    for name, root in roots.items():
        pk[name] = load(f"attr_{name}", root)
    builds = {n: (_build if n == "this" else sys.modules[f"attr_{n}._build"])
              for n in pk}
    if args.split_only:
        del pk["this"], builds["this"]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda b: b.load(), builds.values()))
    parent = importlib.import_module("k2_bench").parent_package(
        os.path.abspath(args.parent))
    parent_build = importlib.import_module("k2_parent._build")
    rec = {"nvidia_smi": smi, "shape": [B, SE3_K],
           "ptxas": {"parent": se3_kernel_lines(ptxas_report(parent_build)),
                     "this": se3_kernel_lines(ptxas_report(_build))},
           "cells": {}}
    if not args.split_only:
        for n in ("se3_geoms", "se3_geoms_regs"):
            rec["ptxas"][n] = se3_kernel_lines(ptxas_report(builds[n]))
    for n, lines in rec["ptxas"].items():
        for ln in lines:
            log(f"[ptxas {n}] {ln}")

    dev = torch.device("cuda", 0)
    cells = {"LM": lambda p: {}, "DogLeg": lambda p: {"solver_type": p.DogLeg},
             "LM_max_iters_0": lambda p: {"max_iters": 0}}
    for dtype in (torch.float32, torch.float64):
        for cname, kw in cells.items():
            key = f"{cname} {str(dtype).split('.')[-1]}"
            r = rec["cells"][key] = {}
            stamped = ["se3_stamp_parent"] + (
                [] if args.split_only else ["se3_stamp_this"])
            for sn in stamped:
                run, _ = se3_runner(pk[sn], kw, dtype, dev)
                _, out = run()
                torch.cuda.synchronize()
                r[sn] = se3_split(out)
            if not args.split_only:
                lay = {"parent": se3_runner(parent, kw, dtype, dev)[0]}
                for S, n in SE3_GEOMS:
                    lay[f"S{S}xNP{n}"] = se3_runner(
                        pk["se3_geoms"], kw, dtype, dev,
                        {"K2_ATTR_NP": str(n), "K2_ATTR_W": "4"})[0]
                lay["S4xNP4_w1"] = se3_runner(
                    pk["se3_geoms"], kw, dtype, dev,
                    {"K2_ATTR_NP": "4", "K2_ATTR_W": "1"})[0]
                # the points held in registers
                for S, n in ((4, 4), (2, 8)):
                    lay[f"S{S}xNP{n}_regs"] = se3_runner(
                        pk["se3_geoms_regs"], kw, dtype, dev,
                        {"K2_ATTR_NP": str(n), "K2_ATTR_W": "4"})[0]
                lay["this"] = se3_runner(this, kw, dtype, dev)[0]
                ref = se3_runner(this, kw, dtype, dev)[1]()
                r["max_err"] = {k: se3_check(ref, f(), dtype, f"{key} {k}")[0]
                                for k, f in lay.items()}
                order = list(lay)
                r["turns_ms"] = [[k, gpu_ms(lay[k], n=5)]
                                 for k in order + order[::-1]]
            log(f"[cell] SE3 {B}x{SE3_K} {key}: {json.dumps(r)}")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k2_attribution_se3.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--family", choices=("mc", "se3"), default="mc")
    ap.add_argument("--split-only", action="store_true")
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
    if args.family == "se3":
        return main_se3(args, smi)
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
