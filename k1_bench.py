"""Time K1 (``tinyopt_tpu_torch/csrc/cg.cu``) against an earlier tree's K1.

At each shape (B instances, d, iterations), float32 and float64, this
tree's K1 and the earlier tree's are timed in turns (old, new, new, old)
in one process, each checked against the plain twin first; both again at
0 iterations, where what is left is the copy of H and the work of each
instance; and, for context only, an exact solve by
``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve`` (another
function: the port never calls it).  The default shape is the cg path's,
10,000 instances at d = 50 with 8 iterations (the warp kernel); the
batched BA's (1000, 96, 96) runs the block kernel.
K1's time beside its bound is ``chip_smoke.py``'s (phases 3 and 16c).

    python3 k1_bench.py --parent DIR [--ptxas] [--shape B,d,iters ...]

``--parent DIR``: the root of a tree holding an earlier
``tinyopt_tpu_torch/`` package, unpacked for instance with
``git archive <commit> tinyopt_tpu_torch | tar -x -C
tinyopt_tpu_torch/_build/parent``.  That package is imported beside this
one under another name, so its ``ops.cuda_cg.cg_solve(H, b, iters)``
builds and calls its own kernels with its own entry points, whatever
their arguments.  ``--ptxas``: print nvcc's registers, shared memory and
spills for every kernel of this tree's ``csrc/cg.cu``.  ``--shape``
(repeatable): the shapes to time; past d = 1024 the block path runs
``cg_block_wide_kernel``.

Device times are milliseconds per call, from CUDA events around 20
launches queued behind a device sleep (``chip_smoke.gpu_ms``); at the
default shape H is 100 MB in float32, twice the L2, so each launch finds
it mostly in device memory.  Host times are microseconds per
``cg_solve`` call, from the host clock around 200 calls at 64 instances
that do not wait for the device.  Output: one line per measurement, the
card's name and power limit, and the record in
``chiprun_out/k1_bench.json``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import gpu_ms  # noqa: E402

DEFAULT_SHAPE, N_LAUNCH = (10_000, 50, 8), 20


def log(*a):
    print(*a, flush=True)


def ptxas_report(build) -> list[str]:
    """nvcc -Xptxas -v over csrc/cg.cu: one line per kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in build.NVCC_FLAGS if f not in ("-shared",)]
        cmd = [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-I", build.CSRC,
               "-o", os.path.join(tmp, "cg.o"),
               os.path.join(build.CSRC, "cg.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines, name = [], None
    for ln in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return lines


def parent_cg(root: str):
    """``ops.cuda_cg`` of the ``tinyopt_tpu_torch`` package under ``root``,
    imported as ``k1_parent``: the package's modules import each other
    relatively, so its wrapper reaches its own library and argtypes."""
    pkg = os.path.join(root, "tinyopt_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "k1_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["k1_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("k1_parent.ops.cuda_cg")


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


def spd(gen, B, d, dtype, dev):
    A = torch.randn((B, 2 * d, d), generator=gen, dtype=dtype,
                    device=dev) / (2 * d) ** 0.5
    H = A.mT @ A + 1e-3 * torch.eye(d, dtype=dtype, device=dev)
    b = torch.randn((B, d), generator=gen, dtype=dtype, device=dev)
    return H, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--shape", action="append", default=[],
                    help="B,d,iters (repeatable)")
    args = ap.parse_args()
    shapes = [tuple(int(v) for v in sh.split(",")) for sh in args.shape] \
        or [DEFAULT_SHAPE]
    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from tinyopt_tpu_torch import _build
    from tinyopt_tpu_torch.ops import cuda_cg
    from tinyopt_tpu_torch.ops.linalg import solve_psd_cg
    old_cg = parent_cg(os.path.abspath(args.parent))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rec = {"nvidia_smi": smi, "shapes": {}}
    log(f"[device] {smi}")
    if args.ptxas:
        rec["ptxas"] = ptxas_report(_build)
        for ln in rec["ptxas"]:
            log(f"[ptxas] {ln}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, D, iters in shapes:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            tag = f"{B}x{D}x{D} iters={iters} {name}"
            H, b = spd(gen, B, D, dtype, dev)
            # chip_smoke.py's hold: against the float64 twin, float64 to
            # 1e-11 of max|x|, float32 to twice the float32 twin's own gap
            # or 1e-5 of max|x|
            xt = solve_psd_cg(H.double(), b.double(), iters)
            scale = max(1.0, xt.abs().max().item())
            gap = (solve_psd_cg(H, b, iters).double() - xt).abs().max().item()
            limit = (max(2 * gap, 1e-5 * scale) if dtype == torch.float32
                     else 1e-11 * scale)
            plan = cuda_cg.k1_launch_plan(B, D, H.element_size(),
                                          H.data_ptr())
            r = rec["shapes"][tag] = {"plan": plan._asdict()}
            runs = {"old": lambda: old_cg.cg_solve(H, b, iters),
                    "new": lambda: cuda_cg.cg_solve(H, b, iters)}
            for who, fn in runs.items():
                err = (fn().double() - xt).abs().max().item()
                assert err <= limit, f"{who} K1 {tag}: err {err} > {limit}"
                r[f"{who}_err"] = err
            r["turns_ms"] = [[w, gpu_ms(runs[w], n=N_LAUNCH)]
                             for w in ("old", "new", "new", "old")]
            log(f"[A/B] {tag} ({plan.h_in}): turns {r['turns_ms']} ms; max "
                f"|x - x_f64| old {r['old_err']:.3e}, new {r['new_err']:.3e} "
                f"(limit {limit:.3e}, max|x| {scale:.3e})")
            r["zero_iters_ms"] = {
                w: gpu_ms(lambda m=m: m.cg_solve(H, b, 0), n=N_LAUNCH)
                for w, m in (("old", old_cg), ("new", cuda_cg))}
            log(f"[A/B] {tag} at 0 iterations (the copy of H and the work "
                f"of each instance alone): {r['zero_iters_ms']} ms")
            Hs, bs = H[:64].clone(), b[:64].clone()
            r["host_us"] = {w: host_us(lambda f=f: f(Hs, bs, iters))
                            for w, f in (("old", old_cg.cg_solve),
                                         ("new", cuda_cg.cg_solve))}
            log(f"[host] {tag} at 64 instances: us per call {r['host_us']}")
            def chol():
                L, _ = torch.linalg.cholesky_ex(H)
                return torch.cholesky_solve(b[..., None], L)[..., 0]
            r["exact_solve_ms"] = gpu_ms(chol, n=5)
            log(f"[context] {tag}: exact solve (cholesky_ex + "
                f"cholesky_solve, not K1's function) "
                f"{r['exact_solve_ms']:.4f} ms")
            del H, b, xt
            torch.cuda.empty_cache()

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k1_bench.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
