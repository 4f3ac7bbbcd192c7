"""Time K2 (``tinyopt_tpu_torch/csrc/solver*.cu``) against an earlier tree's K2.

At the fused path's shape — the 50-dim Gaussian prior, 10,000 instances,
the options of ``bench.py``, float32 and float64 — this tree's K2 and the
earlier tree's are timed in turns (old, new, new, old) in one process,
each checked against this tree's plain twin first; both again at
``max_iters=0`` (one outer iteration: the loads, one linearization and
step, and the stores); and Jennrich-Sampson at 4096 x 2 (20 iterations,
rejections and PCG), float32 and float64, in turns.

    python3 k2_bench.py --parent DIR [--ptxas]

``--parent DIR``: the root of a tree holding an earlier
``tinyopt_tpu_torch/`` package, unpacked for instance with
``git archive <commit> tinyopt_tpu_torch | tar -x -C
tinyopt_tpu_torch/_build/parent``.  That package is imported beside this
one under another name, so its ``ops.cuda_solver.fused_solve`` builds and
calls its own kernels with its own entry points.  ``--ptxas``: print
nvcc's registers and spills for every kernel of this tree's K2 sources.

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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import bench_options, gpu_ms  # noqa: E402

B, D, N_LAUNCH = 10_000, 50, 20
JS_B = 4096


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
    filt = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(build._nvcc()), "cu++filt")
    lines, name = [], None
    for ln in "\n".join(errs).splitlines():
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
    for sub in ("ops.cuda_solver", "models.problems"):
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
    solver a user builds with ``batched_solver``."""

    def __init__(self, pkg, problem, opts_kw, x0, y=None, inv_std=None):
        cs = pkg.ops.cuda_solver
        probs = pkg.models.problems
        opts = bench_options(pkg)
        if opts_kw:
            opts = dataclasses.replace(opts, **opts_kw)
        if problem == "prior":
            fn = probs.prior_residual
            data = probs.PriorProblem(y, inv_std)
            d_ex = probs.PriorProblem(y[0], inv_std[0])
        else:
            fn, data, d_ex = probs.jennrich_sampson_residuals, None, None
        plan = cs.fused_plan(opts, "residuals", x0[0], residual_fn=fn,
                             data_example=d_ex)
        assert plan is not None
        self.run = lambda: cs.fused_solve(fn, opts, x0, data, plan)  # noqa
        self.twin = lambda: cs.fused_solve_plain(fn, opts, x0, data, plan)  # noqa
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--ptxas", action="store_true")
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
        for ln in rec["ptxas"]:
            log(f"[ptxas] {ln}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cs = new_pkg.ops.cuda_solver
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        r = rec[name] = {}
        data, x0 = make_prior_batch(B, D, dtype, generator=gen, device=dev)
        for label, kw in (("bench", {}), ("max_iters_0", {"max_iters": 0})):
            sides = {w: Side(p, "prior", kw, x0, data.y, data.inv_std)
                     for w, p in (("old", old_pkg), ("new", new_pkg))}
            ref = sides["new"].twin()
            errs = {w: check(s, ref, f"{w} {name} {label}")
                    for w, s in sides.items()}
            turns = [[w, gpu_ms(sides[w].run, n=N_LAUNCH)]
                     for w in ("old", "new", "new", "old")]
            r[label] = {"turns_ms": turns, "max_err": errs}
            log(f"[A/B] prior {B}x{D} {name} {label}: turns {turns} ms; "
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
        turns = [[w, gpu_ms(sides[w].run, n=N_LAUNCH)]
                 for w in ("old", "new", "new", "old")]
        r["jennrich_sampson"] = {"turns_ms": turns, "max_err": errs}
        log(f"[A/B] Jennrich-Sampson {JS_B}x2 {name}: turns {turns} ms; "
            f"max|x - x_twin| {errs}")
        del data, x0
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k2_bench.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
