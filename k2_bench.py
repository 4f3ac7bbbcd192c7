"""Time K2 (``tinyopt_tpu_torch/csrc/solver*.cu``) against an earlier tree's K2.

At the fused path's shape — the 50-dim Gaussian prior, 10,000 instances,
the options of ``bench.py``, float32 and float64 — this tree's K2 and the
earlier tree's are timed in turns (old, new, new, old) in one process,
each checked against this tree's plain twin first; both again at
``max_iters=0`` (one outer iteration: the loads, one linearization and
step, and the stores), with the dogleg and with the history;
Jennrich-Sampson at 4096 x 2 (20 iterations, rejections and PCG); the SE3
family at 10,000 poses x 16 points (``bench_se3``'s options), LM, the
dogleg and LM at ``max_iters=0``; and the
multi-color cells, Powell's singular function and Wood's at 10,000 x 4
(``max_iters=200``, no failure budget), LM and the dogleg, coloring
"auto" and "off", each held bit for bit to this tree's twin of "auto";
float32 and float64, in turns.  First, the generated families of
``chip_smoke.py`` phase 21 (the curve fits and the JAX suite's
residuals, 10,000 instances), each tree's library bit for bit against
this tree's twin, in turns.  Then K2's warp kernel (``solver_kernel``,
csrc/solver_warp.cuh) on the hand-written families — the prior at d = 100
(``bench.py``'s options) and the SE3 family at K = 24 (``bench_se3``'s),
10,000 instances — in turns; and phase 23's cells (generated families
past max(P, D, n_res) = 64 on the warp kernel: ICP's 128 points with and
without Huber, the banded residual at d = 128, the Huber curve fit at 256
samples), this tree's "fused" against the earlier tree's "cg" (its fused
path has no warp form), in turns.

    python3 k2_bench.py --parent DIR [--ptxas] [--part warp]

``--parent DIR``: the root of a tree holding an earlier
``tinyopt_tpu_torch/`` package, unpacked for instance with
``git archive <commit> tinyopt_tpu_torch | tar -x -C
tinyopt_tpu_torch/_build/parent``.  That package is imported beside this
one under another name, so its ``ops.cuda_solver.fused_solve`` builds and
calls its own kernels with its own entry points.  ``--ptxas``: print
nvcc's registers, stack frame and spills for every kernel of this tree's
K2 sources (the SE3 family's instances once more as ``[ptxas se3]``), as
``[ptxas diff]`` the kernels whose registers or stack frame differ from
the earlier tree's or that it lacks (as ``[ptxas new]`` the warp kernel's
multi-color instances, new since that branch was ported), and as ``[ptxas generated]`` the kernels of the curve
fits' generated families (``ops/residual_codegen``; float32, LM with the
history).  ``--part warp``: the ptxas report and the warp kernel's cells
alone.

Device times are milliseconds per call, from CUDA events around
launches queued behind a device sleep (``chip_smoke.gpu_ms``).  Host
times are microseconds per call of a solver built by ``batched_solver``
(what a user calls: flatten, the wrapper, the launch, the outputs), from
the host clock around 200 calls at 64 instances that do not wait for the
device, in turns (old, new, new, old).  Output: one line per measurement, the card's name and power
limit, and the record in ``chiprun_out/k2_bench.json``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch.utils import _pytree as pytree

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import (MC_STARTS, MF_TH, WIDE_CELLS,  # noqa: E402
                        bench_options, curve_options, gpu_ms, se3_check,
                        se3_options, suite_options, suite_residuals, timed,
                        wide_residuals)

B, D, N_LAUNCH = 10_000, 50, 20
JS_B = 4096
SE3_K = 16
#: the warp kernel's hand-written cells: the prior's d and the SE3 family's
#: points past the register kernels
WARP_D, WARP_K = 100, 24


def log(*a):
    print(*a, flush=True)


def ptxas_report(build) -> list[str]:
    """nvcc -Xptxas -v over K2's sources, one process each: one line per
    kernel, its name demangled where cu++filt is found."""
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    srcs = [s for s in build.sources()
            if os.path.basename(s).startswith("solver") and s.endswith(".cu")]
    with tempfile.TemporaryDirectory() as tmp:
        def one(src):
            cmd = [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-I",
                   build.CSRC, "-o", os.path.join(tmp, os.path.basename(src)
                                                  + ".o"), src]
            return subprocess.run(cmd, capture_output=True, text=True,
                                  check=True).stderr
        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
            errs = list(ex.map(one, srcs))
    return ptxas_lines("\n".join(errs), build)


def ptxas_lines(text: str, build) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` output ``text``: its
    registers, stack frame and spills, its name demangled where cu++filt
    is found."""
    filt = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(build._nvcc()), "cu++filt")
    lines, name = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip()
            name = name.replace("tinyopt::", "")
        elif name and ("registers" in ln or "spill" in ln):
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return lines


def ptxas_generated(build, libraries) -> list[str]:
    """ptxas's report of generated families' libraries (``_build.
    build_generated`` keeps it beside each), one line per kernel."""
    out = []
    for path in libraries:
        with open(path + ".ptxas.txt") as f:
            out += [f"{os.path.basename(path)} {ln}"
                    for ln in ptxas_lines(f.read(), build)]
    return out


def _kernel_key(name: str) -> str:
    """A kernel's name without its parameter list; the warp kernel's
    instance without the multi-color branch (``solver_kernel<T, Fam,
    false>``) under the name it had before that branch was a template
    argument (``solver_kernel<T, Fam>``)."""
    base = re.sub(r"\(bool\)0", "false", re.sub(r"\(bool\)1", "true", name))
    base = base.split("(", 1)[0].strip()
    return re.sub(r"(solver_kernel<.*), false>$", r"\1>", base)


def ptxas_diff(old: list[str], new: list[str]) -> list[str]:
    """The kernels whose ptxas registers or stack frame differ between two
    reports, and those in one report only."""
    def regs(lines):
        got: dict = {}
        for ln in lines:
            if "registers" in ln or "stack frame" in ln:
                name, text = ln.rsplit(": ", 1)
                key = _kernel_key(name) + (" [stack]" if "stack frame" in ln
                                           else "")
                got[key] = got.get(key, ()) + (text,)
        return got
    o, n = regs(old), regs(new)
    return ([f"{k}: {o[k]} -> {n[k]}" for k in sorted(o.keys() & n.keys())
             if o[k] != n[k]]
            + [f"parent only: {k}" for k in sorted(o.keys() - n.keys())]
            + [f"this tree only: {k}" for k in sorted(n.keys() - o.keys())])


def ptxas_se3(lines: list[str], keep=None) -> list[str]:
    """One line per SE3 instance of a report (per kernel whose name
    ``keep`` takes, when given): registers, stack frame and spills (the
    largest of the kernel's lines: a double kernel's trig slow path prints
    a frame of its own after the kernel's)."""
    got: dict = {}
    for ln in lines:
        name, text = ln.rsplit(": ", 1)
        if keep is not None:
            if not keep(name):
                continue
        elif "SE3" not in name and "se3" not in name:
            continue
        m = re.search(r"Used (\d+) registers", text)
        if m:
            got.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", text)
        if m:
            k = got.setdefault(name, {})
            for f, v in zip(("stack", "spill_stores", "spill_loads"),
                            m.groups()):
                k[f] = max(k.get(f, 0), int(v))
    return [f"{k}: {v}" for k, v in sorted(got.items())]


def curve_fit_libraries(pkg) -> list[str]:
    """The libraries of the curve fits' generated families (float32, LM
    with the history, coloring None), built together."""
    cf = importlib.import_module(f"{pkg.__name__}.models.curve_fit")
    cs = importlib.import_module(f"{pkg.__name__}.ops.cuda_solver")
    rc = importlib.import_module(f"{pkg.__name__}.ops.residual_codegen")
    build = importlib.import_module(f"{pkg.__name__}._build")
    data, x0 = cf.make_curve_batch(1, dtype=torch.float32, device="cpu")
    d_ex = cf.CurveData(data.t[0], data.y[0])
    fams = []
    for fn in (cf.exp_residuals, cf.huber_residuals,
               cf.geman_mcclure_residuals):
        fam, why = rc.generated_family(fn, x0[0], d_ex)
        assert fam is not None, why
        fams.append((fam, build.GenInstance("float", False, True,
                                            cs.COLORING_CODES[None])))
    return build.build_generated(fams)


def parent_package(root: str):
    """The ``tinyopt_tpu_torch`` package under ``root``, imported as
    ``k2_parent``: its modules import each other relatively, so its
    wrapper reaches its own library, entry points and residual families."""
    pkg = os.path.join(root, "tinyopt_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "k2_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["k2_parent"] = mod
    spec.loader.exec_module(mod)
    for sub in ("ops.cuda_solver", "models.problems", "manifold", "_build"):
        importlib.import_module(f"k2_parent.{sub}")
    return mod


def host_us(fn, n=200):
    """Host microseconds per call of ``fn`` over ``n`` calls that are not
    waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


class Side:
    """One tree's K2 on one problem: the plan and a solver built once;
    ``run`` launches K2, ``twin`` runs its plain twin, ``solve`` calls the
    solver a user builds with ``batched_solver``.  ``problem``: "prior"
    (``x0`` and ``y``, ``inv_std``), "js", "powell", "wood" (``x0``; with
    ``coloring``) or "se3" (the package's own flagship data, 10,000 x
    ``SE3_K``, seed 11, of type ``dtype`` on ``device``)."""

    def __init__(self, pkg, problem, opts_kw, x0=None, y=None, inv_std=None,
                 coloring="auto", dtype=None, device=None, k=SE3_K):
        cs = pkg.ops.cuda_solver
        probs = pkg.models.problems
        opts = bench_options(pkg)
        data, d_ex = None, None
        if problem == "prior":
            fn = probs.prior_residual
            data = probs.PriorProblem(y, inv_std)
            d_ex = probs.PriorProblem(y[0], inv_std[0])
        elif problem == "js":
            fn = probs.jennrich_sampson_residuals
        elif problem in ("powell", "wood"):
            fn = {"powell": probs.powell_singular_residuals,
                  "wood": probs.wood_residuals}[problem]
            opts = pkg.Options(
                max_iters=200, max_consec_failures=0,
                hessian=pkg.HessianOptions(solver="fused", save_last=False,
                                           carry_system=False,
                                           diag_coloring=coloring))
        else:
            se3 = pkg.models.se3_refinement
            fn = se3.se3_residual
            opts = se3_options(pkg)
            data, xb, _ = se3.make_se3_refinement(B, k, dtype=dtype,
                                                  seed=11, device=device)
            d_ex = type(data)(*(a[0] for a in data))
        if opts_kw:
            opts = dataclasses.replace(opts, **opts_kw)
        if problem == "se3":
            x_ex = pytree.tree_map(lambda a: a[0], xb)
            plan = cs.fused_plan(opts, "residuals", x_ex, residual_fn=fn,
                                 data_example=d_ex)
            x0 = pkg.manifold.flatten_batch(xb, plan.spec)
        else:
            plan = cs.fused_plan(opts, "residuals", x0[0], residual_fn=fn,
                                 data_example=d_ex)
        assert plan is not None
        # the solver's parameters and color tables built once, as
        # batched_solver builds them (a table upload a call is a pageable
        # copy that would put the host's time on the device's timeline)
        params = cs.k2_params(cs.FAMILIES[fn].id, opts, plan)
        tables = (None if plan.coloring is None or plan.coloring.identity
                  else cs.color_tables(plan.coloring, x0.dtype, x0.device))
        self.run = lambda: cs.fused_solve(  # noqa: E731
            fn, opts, x0, data, plan, params, tables)
        self.twin = lambda: cs.fused_solve_plain(fn, opts, x0, data, plan)  # noqa
        if problem == "prior":
            solver = pkg.batched_solver(fn, opts, "residuals", x0[0], d_ex)
            self.solve = lambda: solver(x0, data)  # noqa: E731


def check(side, ref, what):
    """Max |x - x_twin| of one side's K2, after checking its stop reasons
    and iterations against the twin's."""
    x, out = side.run()
    xr, outr = ref
    torch.cuda.synchronize()
    assert torch.equal(out.stop_reason, outr.stop_reason), what
    di = (out.num_iters - outr.num_iters).abs().max().item()
    assert di <= 1, f"{what}: iteration gap {di}"
    return (x - xr).abs().max().item()


def check_bits(side, ref, what):
    """One side's K2 bit for bit against the twin: x, g, cost, iterations,
    failure counts, stop reasons and the history rows (the multi-color
    cells)."""
    (x, out), (xr, outr) = side.run(), ref
    torch.cuda.synchronize()
    for a, b, f in ((x, xr, "x"), (out.final_grad, outr.final_grad, "g"),
                    (out.final_cost.cost, outr.final_cost.cost, "cost"),
                    (out.errs, outr.errs, "errs"),
                    (out.deltas2, outr.deltas2, "deltas2")):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: {f}")
    for f in ("stop_reason", "num_iters", "num_failures",
              "num_consec_failures", "num_hist", "successes"):
        assert torch.equal(getattr(out, f), getattr(outr, f)), f"{what}: {f}"
    return 0.0


def generated_cells(dev):
    """Phase 21's cells of chip_smoke.py (the Euclidean generated
    families): the three curve fits, 10,000 curves of 60 points, float32
    (Geman-McClure from the start), and the JAX suite's residuals at
    10,000 instances in float32 and float64; (label, residual, options
    kwargs maker, x0, data)."""
    from tinyopt_tpu_torch.models import curve_fit
    cdata, cx0 = curve_fit.make_curve_batch(B, seed=5, device=dev)
    cells = [(f"curve_{k}", fn, lambda p: curve_options(p, "fused"), cx0,
              cdata)
             for k, fn in (("ls", curve_fit.exp_residuals),
                           ("huber", curve_fit.huber_residuals),
                           ("gm", curve_fit.geman_mcclure_residuals))]
    gen = torch.Generator(device=dev).manual_seed(21)
    for name, (fn, kw, make) in suite_residuals().items():
        for dtype in (torch.float32, torch.float64):
            x0, data = make(B, dtype, gen, dev)
            cells.append((name + ("" if dtype == torch.float32 else "_f64"),
                          fn, lambda p, kw=kw: suite_options(p, **kw), x0,
                          data))
    return cells


class GenSide:
    """One tree's generated K2 on one of :func:`generated_cells`: the plan
    (the tree's own trace and emitter), parameters and tables built once;
    ``run`` launches the tree's library, ``twin`` runs its twin."""

    def __init__(self, pkg, fn, opts_of, x0, data):
        cs = pkg.ops.cuda_solver
        opts = opts_of(pkg)
        x_ex = pytree.tree_map(lambda a: a[0], x0)
        d_ex = None if data is None else pytree.tree_map(lambda a: a[0],
                                                         data)
        plan = cs.fused_plan(opts, "residuals", x_ex, residual_fn=fn,
                             data_example=d_ex)
        assert plan is not None and plan.generated is not None
        xf = pkg.manifold.flatten_batch(x0, plan.spec)
        params = cs.k2_params(cs.GENERATED, opts, plan)
        tables = (cs.color_tables(plan.coloring, xf.dtype, xf.device)
                  if cs.coloring_kind(plan.coloring) == "multi" else None)
        self.item = (plan.generated, pkg._build.GenInstance(
            "float" if xf.dtype == torch.float32 else "double",
            opts.solver_type.name == "DOGLEG", opts.save_history,
            cs.COLORING_CODES[cs.coloring_kind(plan.coloring)]))
        self.build = pkg._build
        self.run = lambda: cs.fused_solve(  # noqa: E731
            fn, opts, xf, data, plan, params, tables)
        self.twin = lambda: cs.fused_solve_plain(fn, opts, xf, data, plan)  # noqa


def generated_ab(old_pkg, new_pkg, dev, rec):
    """Phase 21's cells on both trees' generated K2, each bit for bit
    against this tree's twin (x, stop reasons, iterations), then timed in
    turns (old, new, new, old); each tree's libraries built together."""
    sides = {}
    for label, fn, opts_of, x0, data in generated_cells(dev):
        sides[label] = {w: GenSide(p, fn, opts_of, x0, data)
                        for w, p in (("old", old_pkg), ("new", new_pkg))}
    for w in ("old", "new"):
        t0 = time.perf_counter()
        ss = [s[w] for s in sides.values()]
        ss[0].build.build_generated([s.item for s in ss])
        log(f"[generated] {w} tree: {len(ss)} libraries built in "
            f"{time.perf_counter() - t0:.1f} s")
    r = rec["generated"] = {}
    for label, pair in sides.items():
        xr, outr = pair["new"].twin()
        for w, side in pair.items():
            x, out = side.run()
            torch.cuda.synchronize()
            assert torch.equal(x, xr), f"{label} {w}: x"
            assert torch.equal(out.stop_reason, outr.stop_reason), label
            assert torch.equal(out.num_iters, outr.num_iters), label
        t = [[w, gpu_ms(pair[w].run, n=5)] for w in ("old", "new", "new",
                                                     "old")]
        r[label] = {"turns_ms": t}
        log(f"[A/B generated] {label}: bit-equal to the twin both; turns {t} "
            "ms")


def warp_ab(old_pkg, new_pkg, dev, rec):
    """K2's warp kernel on the hand-written families, each tree against
    this tree's twin, then in turns (old, new, new, old): the prior at
    ``WARP_D`` dims and the SE3 family at ``WARP_K`` points, float32 and
    float64."""
    from tinyopt_tpu_torch.models.problems import make_prior_batch
    cs = new_pkg.ops.cuda_solver
    gen = torch.Generator(device=dev).manual_seed(1)
    r = rec["warp"] = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        data, x0 = make_prior_batch(B, WARP_D, dtype, generator=gen,
                                    device=dev)
        sides = {w: Side(p, "prior", {}, x0, data.y, data.inv_std)
                 for w, p in (("old", old_pkg), ("new", new_pkg))}
        ref = sides["new"].twin()
        errs = {w: check(s, ref, f"{w} prior {WARP_D} {name}")
                for w, s in sides.items()}
        kp = cs.k2_launch_plan(B, WARP_D, WARP_D, x0.element_size(), 0,
                               "identity")
        assert kp.path == "warp", kp
        t = turns(sides)
        r[f"prior_{WARP_D}_{name}"] = {"turns_ms": t, "max_err": errs,
                                       "plan": kp._asdict()}
        log(f"[A/B warp] prior {B}x{WARP_D} {name} (plan {tuple(kp)}): "
            f"turns {t} ms; max|x - x_twin| {errs}")
        sides = {w: Side(p, "se3", {}, dtype=dtype, device=dev, k=WARP_K)
                 for w, p in (("old", old_pkg), ("new", new_pkg))}
        ref = sides["new"].twin()
        errs = {w: se3_check(ref, side.run(), dtype, f"se3 {WARP_K} {w}")[0]
                for w, side in sides.items()}
        kp = cs.k2_launch_plan(B, 6, 3 * WARP_K, ref[0].element_size(), 2,
                               None, 1, 7)
        assert kp.path == "warp", kp
        t = turns(sides)
        r[f"se3_{WARP_K}_{name}"] = {"turns_ms": t, "max_err": errs,
                                     "plan": kp._asdict()}
        log(f"[A/B warp] SE3 {B}x{WARP_K} {name} (plan {tuple(kp)}): turns "
            f"{t} ms; max|x - x_twin| {errs}")


def wide_ab(old_pkg, new_pkg, dev, rec):
    """``chip_smoke.py`` phase 23's cells (``WIDE_CELLS``) through
    ``batched_solver``, one solver a side built once: this tree's "fused"
    (one K2 launch on the warp kernel) against the earlier tree's "cg" (the
    loop and K1), ms a call in turns (old, new, new, old), each call
    synchronized; this tree's result within rtol 1e-4 of the other's
    cost."""
    cases = wide_residuals()
    gen = torch.Generator(device=dev).manual_seed(23)
    r = rec["wide"] = {}
    for name, dtype, dogleg in WIDE_CELLS:
        fn, _, options, make = cases[name]
        x0, data = make(dtype, gen, dev)
        x_ex = pytree.tree_map(lambda a: a[0], x0)
        d_ex = pytree.tree_map(lambda a: a[0], data)
        kw = {"solver_type": new_pkg.DogLeg} if dogleg else {}
        new = new_pkg.batched_solver(fn, options(new_pkg, **kw), "auto",
                                     x_ex, d_ex)
        kw = {"solver_type": old_pkg.DogLeg} if dogleg else {}
        old_opts = se3_options(old_pkg, "cg", **kw)
        if name == "curve_huber":
            old_opts = curve_options(old_pkg, "cg")
        ofn, ox0 = fn, x0
        if name.startswith("icp"):
            # the earlier tree's own SE3 pose and ICP residual
            om = importlib.import_module("k2_parent.manifolds")
            oicp = importlib.import_module("k2_parent.models.icp")
            ox0 = om.SE3(om.SO3(x0.rotation.wxyz), x0.translation)
            th = MF_TH if name == "icp_huber" else None

            def ofn(T, d, th=th):
                return oicp.icp_residual(T, d.points, d.targets,
                                         robust_th=th)
        old = old_pkg.batched_solver(ofn, old_opts, "auto",
                                     pytree.tree_map(lambda a: a[0], ox0),
                                     d_ex)
        sides = {"old": lambda: old(ox0, data), "new": lambda: new(x0, data)}
        cs = new_pkg.ops.cuda_solver
        cs.fused_solve.warp_launches = 0
        outs = {w: sides[w]() for w in ("old", "new")}
        assert cs.fused_solve.warp_launches == 1, name
        key = (name + ("_dl" if dogleg else "")
               + ("" if dtype == torch.float32 else "_f64"))
        t = [[w, timed(sides[w])[1]] for w in ("old", "new", "new", "old")]
        cost = {w: o[1].final_cost.cost for w, o in outs.items()}
        gap = ((cost["new"] - cost["old"]).abs()
               / cost["old"].abs().clamp(min=1e-30)).median().item()
        r[key] = {"turns_ms": t, "median_cost_gap": gap}
        log(f"[A/B wide] {key}: this tree's fused against the earlier "
            f"tree's cg, turns {t} ms; median relative cost gap {gap:.3e}")


def turns(sides):
    """Device ms of each side's K2 in turns: old, new, new, old."""
    return [[w, gpu_ms(sides[w].run, n=N_LAUNCH)]
            for w in ("old", "new", "new", "old")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--part", choices=("all", "warp"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_bench: no CUDA device", file=sys.stderr)
        return 2
    import tinyopt_tpu_torch as new_pkg
    import tinyopt_tpu_torch.ops.cuda_solver  # noqa: F401
    from tinyopt_tpu_torch import _build
    from tinyopt_tpu_torch.models.problems import make_prior_batch
    old_pkg = parent_package(os.path.abspath(args.parent))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rec = {"nvidia_smi": smi, "shape": [B, D]}
    log(f"[device] {smi}")
    if args.ptxas:
        rec["ptxas"] = ptxas_report(_build)
        rec["ptxas_parent"] = ptxas_report(
            importlib.import_module("k2_parent._build"))
        for ln in rec["ptxas"]:
            log(f"[ptxas] {ln}")
        for ln in ptxas_se3(rec["ptxas"]):
            log(f"[ptxas se3] {ln}")
        for ln in ptxas_se3(rec["ptxas_parent"]):
            log(f"[ptxas se3 parent] {ln}")
        for ln in ptxas_diff(rec["ptxas_parent"], rec["ptxas"]):
            # the warp kernel's multi-color instances (kMulti = true) are
            # new in this tree; every other line is a kernel that changed
            new = ln.startswith("this tree only") and ", true>" in ln
            log(f"[ptxas {'new' if new else 'diff'}] {ln}")
        # the generated families of the curve fits (float32, LM with the
        # history, no coloring: what phase 21 of chip_smoke.py runs)
        rec["ptxas_generated"] = ptxas_generated(
            _build, curve_fit_libraries(new_pkg))
        for ln in ptxas_se3(rec["ptxas_generated"], keep=lambda n: True):
            log(f"[ptxas generated] {ln}")

    dev = torch.device("cuda", 0)
    warp_ab(old_pkg, new_pkg, dev, rec)
    wide_ab(old_pkg, new_pkg, dev, rec)
    gen = torch.Generator(device=dev).manual_seed(0)
    cs = new_pkg.ops.cuda_solver
    if args.part == "all":
        generated_ab(old_pkg, new_pkg, dev, rec)
    for dtype in (torch.float32, torch.float64) if args.part == "all" else ():
        name = str(dtype).split(".")[-1]
        r = rec[name] = {}
        data, x0 = make_prior_batch(B, D, dtype, generator=gen, device=dev)
        for label, kw in (("bench", lambda p: {}),
                          ("max_iters_0", lambda p: {"max_iters": 0}),
                          ("dogleg", lambda p: {"solver_type": p.DogLeg}),
                          ("history", lambda p: {"save_history": True})):
            sides = {w: Side(p, "prior", kw(p), x0, data.y, data.inv_std)
                     for w, p in (("old", old_pkg), ("new", new_pkg))}
            ref = sides["new"].twin()
            errs = {w: check(s, ref, f"{w} {name} {label}")
                    for w, s in sides.items()}
            t = turns(sides)
            r[label] = {"turns_ms": t, "max_err": errs}
            log(f"[A/B] prior {B}x{D} {name} {label}: turns {t} ms; "
                f"max|x - x_twin| {errs}")
        plan = cs.k2_launch_plan(B, D, D, x0.element_size(), 0, "identity")
        r["plan"] = plan._asdict()
        log(f"[plan] prior {B}x{D} {name}: {plan}")
        small = [t[:64].clone() for t in (x0, data.y, data.inv_std)]
        calls = {w: Side(p, "prior", {}, *small).solve
                 for w, p in (("old", old_pkg), ("new", new_pkg))}
        r["host_us_turns"] = [[w, host_us(calls[w])]
                              for w in ("old", "new", "new", "old")]
        log(f"[host] {name} 64x{D}: us per solve call, turns "
            f"{r['host_us_turns']}")

        js0 = (torch.rand((JS_B, 2), generator=gen, dtype=dtype, device=dev)
               * 0.35 + 0.1)
        kw = {"max_iters": 20, "max_consec_failures": 5}
        sides = {w: Side(p, "js", kw, js0) for w, p in
                 (("old", old_pkg), ("new", new_pkg))}
        ref = sides["new"].twin()
        errs = {}
        for w, s in sides.items():
            x, _ = s.run()
            torch.cuda.synchronize()
            errs[w] = (x - ref[0]).abs().max().item()
        t = turns(sides)
        r["jennrich_sampson"] = {"turns_ms": t, "max_err": errs}
        log(f"[A/B] Jennrich-Sampson {JS_B}x2 {name}: turns {t} ms; "
            f"max|x - x_twin| {errs}")

        # the SE3 family: each tree on its own flagship data of one seed
        # (the same values); not bit-equal to the twin (PERF.md), so held
        # to chip_smoke.py phase 4b's se3_check
        for label, kw in (("se3", lambda p: {}),
                          ("se3_dogleg", lambda p: {"solver_type": p.DogLeg}),
                          ("se3_max_iters_0", lambda p: {"max_iters": 0})):
            sides = {w: Side(p, "se3", kw(p), dtype=dtype, device=dev)
                     for w, p in (("old", old_pkg), ("new", new_pkg))}
            ref = sides["new"].twin()
            errs = {w: se3_check(ref, side.run(), dtype, f"{label} {w}")[0]
                    for w, side in sides.items()}
            kp = cs.k2_launch_plan(B, 6, 3 * SE3_K, ref[0].element_size(), 2,
                                   None, cs.SOLVER_CODES[
                                       kw(new_pkg).get("solver_type",
                                                       new_pkg.LevenbergMarquardt)],
                                   7)
            t = turns(sides)
            r[label] = {"turns_ms": t, "max_err": errs, "plan": kp._asdict(),
                        "mean_iters": ref[1].num_iters.float().mean().item()}
            log(f"[A/B] {label} {B}x{SE3_K} {name} (this tree's plan "
                f"{tuple(kp)}): turns {t} ms; max|x - x_twin| {errs}")

        # the multi-color cells: each tree's K2, "auto" and "off", bit for
        # bit against this tree's twin of "auto", then in turns
        for prob in ("powell", "wood"):
            x0m = (torch.tensor(MC_STARTS[prob], dtype=dtype, device=dev)
                   + 0.1 * torch.randn((B, 4), generator=gen, dtype=dtype,
                                       device=dev))
            for sname in ("LevenbergMarquardt", "DogLeg"):
                ref = None
                for col in ("auto", "off"):
                    sides = {w: Side(p, prob, {"solver_type":
                                               getattr(p, sname)},
                                     x0m, coloring=col)
                             for w, p in (("old", old_pkg), ("new", new_pkg))}
                    if ref is None:
                        ref = sides["new"].twin()
                    for w, side in sides.items():
                        check_bits(side, ref, f"{prob} {sname} {col} {w}")
                    kp = cs.k2_launch_plan(
                        B, 4, 4 if prob == "powell" else 6, x0m.element_size(),
                        3 if prob == "powell" else 4,
                        "multi" if col == "auto" else None)
                    t = turns(sides)
                    label = f"mc_{prob}_{sname}_{col}"
                    r[label] = {"turns_ms": t, "plan": kp._asdict(),
                                "mean_iters":
                                    ref[1].num_iters.float().mean().item(),
                                "max_iters": ref[1].num_iters.max().item()}
                    log(f"[A/B] {prob} {sname} {B}x4 {name} coloring {col} "
                        f"(this tree's plan {tuple(kp)}): bit-equal to the "
                        f"twin both; turns {t} ms")
        del data, x0
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k2_bench.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
