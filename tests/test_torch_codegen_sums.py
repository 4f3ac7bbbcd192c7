"""The order in which K2's generated families add (``ops/residual_codegen.
py``'s ``reduce_sum``): a sum over the fastest dim in the warp order
(``k2g_warp_sum``), a sum over another dim as four running sums, slot k % 4
of summand k, then ((s0 + s1) + s2) + s3.  Those are the orders torch's CUDA
sums add in at ``chip_smoke.py`` phase 22's shapes, on which a generated
kernel's bit parity with its twin rests.

On the CPU the emitted sums, compiled by g++, are held bit for bit to a
numpy model of the two orders.  On the card (``cuda``) the emitted sums,
compiled by nvcc, are held bit for bit to the twin's sum (``torch.func.
vmap`` of the same function on CUDA tensors) at 10,000 instances, and to
the model: a change in torch's reduction order fails here first.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tinyopt_tpu_torch.ops import residual_codegen

torch.set_num_threads(1)

#: (the summed shape, the dim, the order): the squared norm of a point's
#: residual and a rotation's vector part (3), per point (16 × 3), ICP's 48
#: residuals (past 32: two summands a slot), and the vjp of a translation,
#: a quaternion and a rotation broadcast over 16 points or 4 rotations
SUMS = (((3,), 0, "warp"), ((16, 3), 1, "warp"), ((48,), 0, "warp"),
        ((16, 3), 0, "slots"), ((16, 4), 0, "slots"), ((4, 3), 0, "slots"))
DTYPES = (torch.float32, torch.float64)


def summed(dim):
    def fn(x, d):
        return (d * x).sum(dim).reshape(-1)
    return fn


def family(shape, dim, dtype):
    fam, why = residual_codegen.generated_family(
        summed(dim), torch.ones(1, dtype=dtype), torch.zeros(shape,
                                                             dtype=dtype))
    assert fam is not None, why
    return fam


def model(t, order):
    """The sums of the rows of ``t`` (M, n), in numpy's arithmetic of
    ``t``'s type: "warp" (slot l < 32 holds 0 + t_l + t_(l+32) + ...,
    then halving trees over the slots that may hold a value) or "slots"."""
    M, n = t.shape
    zero = np.zeros(M, t.dtype)
    if order == "slots":
        s = [zero] * 4
        for k in range(n):
            s[k % 4] = s[k % 4] + t[:, k]
        return ((s[0] + s[1]) + s[2]) + s[3]
    u = [zero + t[:, k] if k < n else zero for k in range(32)]
    for k in range(32):
        for j in range(k + 32, n, 32):
            u[k] = u[k] + t[:, j]
    live, off = n, 16
    while off >= 1:
        for k in range(off):
            if k + off < live:
                u[k] = u[k] + u[k + off]
        live, off = min(live, off), off // 2
    return u[0]


def expected(d, dim, order):
    """The model's sums of each instance of ``d`` (B, *shape) over
    ``dim``, as (B, outputs)."""
    a = np.moveaxis(d, dim + 1, -1)
    rows = model(a.reshape(-1, a.shape[-1]), order)
    return rows.reshape(d.shape[0], -1)


def draw(B, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B,) + shape).astype(
        np.float32 if dtype == torch.float32 else np.float64)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emitted C++ on the host")
    root = tmp_path_factory.mktemp("k2sums")

    def build(fam):
        d = root / fam.hash
        d.mkdir(exist_ok=True)
        (d / "family.h").write_text(fam.source)
        (d / "family.cpp").write_text(
            '#define K2G_HOST_ENTRY\n#include "family.h"\n')
        so = d / "family.so"
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(so),
             str(d / "family.cpp")], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return ctypes.CDLL(str(so))
    return build


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dim,order", SUMS)
def test_emitted_sums_follow_the_model(shape, dim, order, dtype, host_lib):
    """The emitted sum, compiled by g++, equals the model of its order bit
    for bit on 64 seeded instances."""
    fam = family(shape, dim, dtype)
    lib = host_lib(fam)
    d = draw(64, shape, dtype, 19)
    want = expected(d, dim, order)
    x = torch.ones(1, dtype=dtype)
    out = torch.empty(fam.n_res, dtype=dtype)
    for i in range(d.shape[0]):
        row = torch.from_numpy(np.ascontiguousarray(d[i]).reshape(-1))
        lib.k2g_residual(ctypes.c_void_p(x.data_ptr()),
                         ctypes.c_void_p(row.data_ptr()),
                         ctypes.c_void_p(out.data_ptr()))
        assert np.array_equal(out.numpy(), want[i]), (i, out, want[i])


_KERNEL = r"""
#include "family.h"
using F = tinyopt::k2gen::Residual;
template <typename T>
__global__ void rows_kernel(int n, const T* x, const T* data, T* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  F::rows<T>(x + (size_t)i * F::kP, data + (size_t)i * F::kQ,
             out + (size_t)i * F::kNRes);
}
extern "C" int run(int n, const void* x, const void* data, void* out) {
  rows_kernel<TT><<<(n + 127) / 128, 128>>>(n, (const TT*)x,
                                            (const TT*)data, (TT*)out);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.fixture(scope="module")
def card_libs(tmp_path_factory):
    """Each case's emitted sum in a one-function kernel, built by nvcc (all
    started together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the emitted sums as CUDA code)")
    from tinyopt_tpu_torch import _build
    root = tmp_path_factory.mktemp("k2sums_card")
    procs, libs = [], {}
    for shape, dim, _ in SUMS:
        for dtype in DTYPES:
            fam = family(shape, dim, dtype)
            d = root / f"{fam.hash}"
            d.mkdir()
            (d / "family.h").write_text(fam.source)
            ct = "float" if dtype == torch.float32 else "double"
            (d / "k.cu").write_text(_KERNEL.replace("TT", ct))
            so = d / "k.so"
            procs.append((shape, dim, dtype, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                 str(so), str(d / "k.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for shape, dim, dtype, so, proc in procs:
        log = proc.communicate()[0]
        assert proc.returncode == 0, log[-4000:]
        libs[shape, dim, dtype] = ctypes.CDLL(str(so))
    return libs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dim,order", SUMS)
def test_emitted_sums_match_torch_on_gpu(shape, dim, order, dtype,
                                         card_libs):
    """At phase 22's 10,000 instances the emitted sum on the card equals
    the twin's (``torch.func.vmap`` of the same function on CUDA tensors)
    and the model of its order, bit for bit."""
    dev = torch.device("cuda")
    B = 10_000
    d = draw(B, shape, dtype, 22)
    db = torch.from_numpy(d).to(dev)
    xb = torch.ones((B, 1), dtype=dtype, device=dev)
    twin = torch.func.vmap(summed(dim))(xb, db)
    out = torch.empty_like(twin)
    torch.cuda.synchronize()
    err = card_libs[shape, dim, dtype].run(
        B, ctypes.c_void_p(xb.data_ptr()), ctypes.c_void_p(db.data_ptr()),
        ctypes.c_void_p(out.data_ptr()))
    assert err == 0, f"CUDA error {err}"
    same = (out == twin).all(dim=1).float().mean().item()
    assert same == 1.0, f"bit-equal to torch on {same:.4f} of the instances"
    assert np.array_equal(out.cpu().numpy(), expected(d, dim, order))
