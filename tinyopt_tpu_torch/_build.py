"""Build and load the package's CUDA kernels.

All kernels live in ``csrc/*.cu`` (with shared headers ``csrc/*.cuh``) and
expose a plain C interface.  At first use they are compiled by ``nvcc``,
one process per ``.cu`` source, all started together, and linked into
ONE shared library for Hopper (``sm_90a``), placed in ``_build/``
next to this file under a name keyed by a hash of the sources and flags,
and loaded with ``ctypes``.  Nothing is compiled when the package is
imported, and nothing here runs on a machine without CUDA unless a CUDA
tensor reaches a kernel wrapper.

K2's families generated from a traced residual (``ops/residual_codegen``)
are built apart: one translation unit per family and instance (type,
dogleg, history, coloring, the kernel's path) — the emitted header, then
``csrc/solver_gen.cuh`` — compiled by one ``nvcc`` at first use into a
library of its own under ``_build/``, keyed by a hash of the emitted source,
the instance, K2's sources and the flags, and loaded with ``ctypes``
(:func:`generated_library`; :func:`build_generated` starts several builds
together).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# --fmad=false: no contraction of a*b + c into one fused multiply-add, so
# the kernels round every product and sum as their plain torch twins do
# (measured on an H100: with contraction the Jennrich-Sampson K2 runs drift
# from the twin, without it they agree bit for bit).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "tinyopt_tpu_torch are compiled at first use and need the CUDA "
            "toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtinyopt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library if it is missing."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in sources() if s.endswith(".cu")]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # Compile in a private temporary directory, then publish the library
    # atomically, so two processes building at once never load a
    # half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(c)[:-3] + ".o") for c in cu]
        cmds = [[_nvcc(), *compile_flags, "-c", "-I", CSRC, "-o", o, c]
                for c, o in zip(cu, objs)]
        cmds.append([_nvcc(), *NVCC_FLAGS, "-o", os.path.join(tmp, "lib.so"),
                     *objs])
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        outs = [p.communicate()[0] for p in procs]
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
        proc = subprocess.run(cmds[-1], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmds[-1])}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(os.path.join(tmp, "lib.so"), path)
    return path


#: K2's sources a generated family's library is compiled from.
GEN_SOURCES = ("common.cuh", "solver.cuh", "solver_seg.cuh", "solver_warp.cuh",
               "solver_gen.cuh")
#: ``GenInstance.path``: K2's warp kernel (``enum Path``'s kPathWarp,
#: csrc/solver.cuh) or its register kernel (kPathSegment).
GEN_WARP, GEN_SEGMENT = 0, 1


class GenInstance(NamedTuple):
    """One instance of a generated family's kernel: ``ctype`` "float" or
    "double", the dogleg or GN / LM, with or without the history rows, the
    coloring's code (``enum Coloring``, csrc/solver.cuh) and the kernel's
    path (``GEN_WARP`` past max(P, D, n_res) = 64, else
    ``GEN_SEGMENT``)."""
    ctype: str
    dogleg: bool
    hist: bool
    coloring: int
    path: int = GEN_SEGMENT


def _generated_unit(family, inst: GenInstance) -> str:
    return (f"// K2 on the generated family {family.hash}, one instance.\n"
            f"#define K2G_T {inst.ctype}\n#define K2G_DL {int(inst.dogleg)}\n"
            f"#define K2G_HIST {int(inst.hist)}\n"
            f"#define K2G_COLOR {inst.coloring}\n"
            f"#define K2G_PATH {inst.path}\n"
            f'#include "k2gen_{family.hash}.cuh"\n#include "solver_gen.cuh"\n')


def generated_library_path(family, inst: GenInstance) -> str:
    """Where the library of ``family`` (a ``residual_codegen.
    GeneratedFamily``) at instance ``inst`` is built: a name keyed by the
    hash of its emitted source, the instance, K2's sources and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_generated_unit(family, inst).encode())
    h.update(family.source.encode())
    for name in GEN_SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtinyopt_k2gen_{h.hexdigest()[:16]}.so")


def build_generated(items, nice: int = 0) -> list[str]:
    """Build the generated families' libraries that are missing, one
    ``nvcc`` each, all started together (``nice``: their scheduling
    priority, raised by that much, for a build that runs beside other
    work); ``items``: (family, GenInstance) pairs.  ptxas's report of each
    (registers, spills) is kept beside its library as
    ``<library>.ptxas.txt``.  A failed build raises.  Returns the
    libraries' paths."""
    paths = [generated_library_path(f, i) for f, i in items]
    todo = {p: (f, i) for p, (f, i) in zip(paths, items)
            if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for k, (path, (family, inst)) in enumerate(todo.items()):
            unit = os.path.join(tmp, f"gen{k}")
            os.makedirs(unit)
            with open(os.path.join(unit, f"k2gen_{family.hash}.cuh"), "w") as f:
                f.write(family.source)
            src = os.path.join(unit, "family.cu")
            with open(src, "w") as f:
                f.write(_generated_unit(family, inst))
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-I",
                   unit, "-o", os.path.join(unit, "lib.so"), src]
            procs.append((path, unit, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, preexec_fn=(lambda: os.nice(nice)) if nice
                else None)))
        outs = [(path, unit, cmd, p, p.communicate()[0])
                for path, unit, cmd, p in procs]
        for path, unit, cmd, p, out in outs:
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
        for path, unit, cmd, p, out in outs:
            with open(path + ".ptxas.txt", "w") as f:
                f.write(out)
            os.replace(os.path.join(unit, "lib.so"), path)
    return paths


@functools.lru_cache(maxsize=None)
def _load_generated(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # params, io, the multi-color probes and recovery (or null), B, then
    # ops.cuda_solver.K2Plan's S, E, warps, grid, smem_bytes, then the
    # stream
    lib.tinyopt_gen_solver.argtypes = [
        ctypes.POINTER(SolverParams), ctypes.POINTER(SolverIO), vp, vp, ci,
        ci, ci, ci, ci, ci, vp]
    lib.tinyopt_gen_solver.restype = ci
    lib.tinyopt_gen_error_string.argtypes = [ci]
    lib.tinyopt_gen_error_string.restype = ctypes.c_char_p
    return lib


def generated_library(family, inst: GenInstance) -> ctypes.CDLL:
    """The loaded library of ``family`` at instance ``inst``, built first
    if it is missing."""
    return _load_generated(build_generated([(family, inst)])[0])


class SolverParams(ctypes.Structure):
    """Mirror of ``struct SolverParams`` in csrc/solver.cuh."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "d", "n_res", "family", "fam_m", "solver", "coloring",
        "max_iters_total", "max_consec_failures", "max_total_failures",
        "cg_iters", "use_quality", "use_squared_norm", "downscale_by_2",
        "normalize")] + [(n, ctypes.c_double) for n in (
            "min_error", "min_rerr_dec", "min_step_norm2", "min_grad_norm2",
            "damping_init", "lam_lo", "lam_hi", "good_factor", "bad_factor",
            "grad_clipping")] + [("cap", ctypes.c_int),
                                 ("n_colors", ctypes.c_int)]


class SolverIO(ctypes.Structure):
    """Mirror of ``struct SolverIO`` in csrc/solver.cuh (device pointers)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x0", "data0", "data1", "x", "cost", "rerr", "lam", "g", "stop",
        "iters", "nfail", "nconsec", "nres", "nhist", "inlier", "duration",
        "errs", "deltas2", "succ")]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("tinyopt_cg_f32", "tinyopt_cg_f64"):
        # H, b, x, B, d, iters, then ops.cuda_cg.K1Plan's path, h_in, bulk,
        # reg_rows, cols, warps, smem_bytes, then the stream
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    for name in ("tinyopt_solver_f32", "tinyopt_solver_f64"):
        # params, io, the multi-color probes and recovery (or null), B,
        # then ops.cuda_solver.K2Plan's path, S, E, warps, grid,
        # smem_bytes, then the stream
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(SolverParams), ctypes.POINTER(SolverIO),
                       vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    lib.tinyopt_cuda_error_string.argtypes = [ci]
    lib.tinyopt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str, lib: ctypes.CDLL | None = None) -> None:
    """Raise if a kernel entry point returned a CUDA error code (``lib``:
    a generated family's library, which names its own errors)."""
    if err != 0:
        msg = (load().tinyopt_cuda_error_string(err) if lib is None
               else lib.tinyopt_gen_error_string(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
