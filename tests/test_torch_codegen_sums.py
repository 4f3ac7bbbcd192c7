"""The order in which K2's generated families add (``ops/residual_codegen.
py``'s ``reduce_sum``): a sum over the fastest dim in the warp order
(``k2g_warp_sum``: below 128 summands slot l of 32 holds t_l + t_(l+32) +
..., from 128 on four running sums over 4-vectors a slot), a sum over
another dim as four running sums, slot k % 4 of summand k, then ((s0 + s1)
+ s2) + s3 — in W groups where torch splits the summands over warps
(``_outer_split``: 4 at 128 points of a quaternion), then the groups'
halving tree.  Those are the orders torch's CUDA sums add in at
``chip_smoke.py`` phase 22's and phase 23's shapes, on which a generated
kernel's bit parity with its twin rests.  Below a batch of 32 torch picks
another geometry (ATen's Reduce.cuh ``setReduceConfig``): a row sum on a
block of W > 32 threads or split over Y warps, a sum over another dim in
other groups; a family emitted for that batch (``GeneratedFamily.
at_batch``) adds in it, and so does K2's warp kernel (``torch_row_sum``,
csrc/solver_warp.cuh).

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
#: (phase 22); the vjp of the curve fit's two parameters over 256 samples,
#: a sum over 384 and 128 residuals (4-vectors), and the vjp of a
#: translation and a quaternion over 128 points (the quaternion's split
#: over 4 warps) (phase 23)
SUMS = (((3,), 0, "warp"), ((16, 3), 1, "warp"), ((48,), 0, "warp"),
        ((16, 3), 0, "slots"), ((16, 4), 0, "slots"), ((4, 3), 0, "slots"),
        ((256,), 0, "warp"), ((384,), 0, "warp"), ((128,), 0, "warp"),
        ((128, 3), 0, "slots"), ((128, 4), 0, "slots"))
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


def model(t, order, groups=1):
    """The sums of the rows of ``t`` (M, n), in numpy's arithmetic of
    ``t``'s type: "warp" (below 128 values slot l < 32 holds 0 + t_l +
    t_(l+32) + ...; from 128 on slot l holds ((a0 + a1) + a2) + a3, a_j =
    0 + t_(4l+j) + t_(4l+128+j) + ...; then halving trees over the slots
    that may hold a value), "split" with ``groups`` = (W, Y) (split_model)
    or "slots" (in ``groups`` groups: group y's summands y + W·i + 4W·m in
    slot i, the rest in slots 0, 1, 2 in turn, ((s0 + s1) + s2) + s3, then
    the groups' halving tree)."""
    M, n = t.shape
    zero = np.zeros(M, t.dtype)
    if order == "split":
        return split_model(t, *groups)
    if order == "slots":
        W, v = groups, []
        for y in range(W):
            s, k = [zero] * 4, y
            while k + 3 * W < n:
                for i in range(4):
                    s[i] = s[i] + t[:, k + i * W]
                k += 4 * W
            for i in range(4):
                if k >= n:
                    break
                s[i] = s[i] + t[:, k]
                k += W
            v.append(((s[0] + s[1]) + s[2]) + s[3])
        off = W // 2
        while off:
            v = [v[y] + v[y + off] for y in range(off)]
            off //= 2
        return v[0]
    if n >= 128:
        u = []
        for k in range(32):
            a = [zero] * 4
            for j in range(4 * k, n - 3, 128):
                a = [a[i] + t[:, j + i] for i in range(4)]
            if n - n % 4 + k < n:
                a[0] = a[0] + t[:, n - n % 4 + k]
            u.append(((a[0] + a[1]) + a[2]) + a[3])
    else:
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


def split_model(t, W, Y):
    """Rows of ``t`` (M, n) summed as torch's block of W threads and Y
    warps adds them: thread (x, y) adds, from 128 values on, 4-vectors x +
    y·W, x + y·W + W·Y, ... in four sums (the n % 4 last values to a0 of
    threads 0, 1, 2 of y = 0) and ((a0 + a1) + a2) + a3, below 128 values
    x, x + W, ... in turn; then each y's halving tree over its W threads,
    then the halving tree over the Y warps."""
    M, n = t.shape
    zero = np.zeros(M, t.dtype)
    tot = []
    for y in range(Y):
        u = []
        for x in range(W):
            if n >= 128:
                a = [zero] * 4
                v = x + y * W
                while 4 * v + 3 < n:
                    a = [a[i] + t[:, 4 * v + i] for i in range(4)]
                    v += W * Y
                if y == 0 and n - n % 4 + x < n:
                    a[0] = a[0] + t[:, n - n % 4 + x]
                u.append(((a[0] + a[1]) + a[2]) + a[3])
            else:
                s = zero
                for j in range(x, n, W):
                    s = s + t[:, j]
                u.append(s)
        off = W // 2
        while off:
            u = [u[x] + u[x + off] for x in range(off)]
            off //= 2
        tot.append(u[0])
    off = Y // 2
    while off:
        tot = [tot[y] + tot[y + off] for y in range(off)]
        off //= 2
    return tot[0]


#: torch's warp groups of each "slots" sum (residual_codegen._outer_split's
#: rule, probed on an H100): 4 for a quaternion's 128 points
GROUPS = {((128, 4), 0): 4}

#: Sums whose geometry depends on the batch, at the batch given: (shape,
#: dim, batch) -> ("split", (W, Y)) of a row sum or ("slots", groups) of a
#: sum over another dim, worked out by hand from ATen's Reduce.cuh
#: ``setReduceConfig`` (vectors of 4 from 128 values on a row; W = min(the
#: largest power of two ≤ the row's vectors or values, 512 / h), h = min(the
#: largest power of two ≤ the outputs, 16); Y = h where at least min(16·h,
#: 256) values a thread are left; over another dim, outputs loaded 4, 2 or
#: 1 at a time, a block min(their power of two, 32) wide and h = min(the
#: summands' power of two, 512 / vec / width) high, split over h from
#: min(16·h, 256) summands).  The curve fit's 256 samples and ICP's 384
#: residuals at a batch of one take 64 threads; 96 values too (no vectors);
#: a row of 8,192 splits over 4 warps of 128 threads at a batch of 4 and
#: over 16 warps of 32 at 10,000; a quaternion's 128 points add in one
#: group at a batch of 1, 3 or 8 and in 8 at 16; 256 points of a quaternion
#: in 128 groups at a batch of one, 512 points of a translation in 256.
BATCHED = {((256,), 0, 1): ("split", (64, 1)),
           ((384,), 0, 1): ("split", (64, 1)),
           ((384,), 0, 3): ("split", (64, 1)),
           ((96,), 0, 1): ("split", (64, 1)),
           ((8192,), 0, 4): ("split", (128, 4)),
           ((8192,), 0, 10_000): ("split", (32, 16)),
           ((128, 4), 0, 1): ("slots", 1),
           ((128, 4), 0, 3): ("slots", 1),
           ((128, 4), 0, 8): ("slots", 1),
           ((128, 4), 0, 16): ("slots", 8),
           ((256, 4), 0, 1): ("slots", 128),
           ((256, 4), 0, 10_000): ("slots", 4),
           ((512, 3), 0, 1): ("slots", 256),
           ((512, 3), 0, 10_000): ("slots", 16)}


def expected(d, dim, order, groups=None):
    """The model's sums of each instance of ``d`` (B, *shape) over
    ``dim``, as (B, outputs)."""
    a = np.moveaxis(d, dim + 1, -1)
    rows = model(a.reshape(-1, a.shape[-1]), order,
                 GROUPS.get((d.shape[1:], dim), 1) if groups is None
                 else groups)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dim,batch", sorted(BATCHED))
def test_emitted_sums_at_a_batch_follow_the_model(shape, dim, batch, dtype,
                                                 host_lib):
    """The family emitted for a batch whose geometry differs (``at_batch``)
    adds as the model of that geometry, bit for bit, compiled by g++ on 16
    seeded instances; from a batch of 32 on a family keeps its one
    source (and below it each of these geometries is another one's)."""
    fam = family(shape, dim, dtype)
    assert fam.at_batch(32) is fam and fam.at_batch(10 ** 6) is fam
    at = fam.at_batch(batch)
    order, groups = BATCHED[shape, dim, batch]
    assert (at is fam) == (batch >= 32)
    lib = host_lib(at)
    d = draw(16, shape, dtype, 23)
    want = expected(d, dim, order, groups)
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
    cases = [(shape, dim, None) for shape, dim, _ in SUMS] + sorted(BATCHED)
    for shape, dim, batch in cases:
        for dtype in DTYPES:
            fam = family(shape, dim, dtype)
            if batch is not None:
                fam = fam.at_batch(batch)
            d = root / f"{fam.hash}"
            if d.exists():
                procs.append((shape, dim, batch, dtype, d / "k.so", None))
                continue
            d.mkdir()
            (d / "family.h").write_text(fam.source)
            ct = "float" if dtype == torch.float32 else "double"
            (d / "k.cu").write_text(_KERNEL.replace("TT", ct))
            so = d / "k.so"
            procs.append((shape, dim, batch, dtype, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                 str(so), str(d / "k.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for shape, dim, batch, dtype, so, proc in procs:
        if proc is not None:
            log = proc.communicate()[0]
            assert proc.returncode == 0, log[-4000:]
    for shape, dim, batch, dtype, so, proc in procs:
        libs[shape, dim, batch, dtype] = ctypes.CDLL(str(so))
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
    err = card_libs[shape, dim, None, dtype].run(
        B, ctypes.c_void_p(xb.data_ptr()), ctypes.c_void_p(db.data_ptr()),
        ctypes.c_void_p(out.data_ptr()))
    assert err == 0, f"CUDA error {err}"
    same = (out == twin).all(dim=1).float().mean().item()
    assert same == 1.0, f"bit-equal to torch on {same:.4f} of the instances"
    assert np.array_equal(out.cpu().numpy(), expected(d, dim, order))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dim,batch", sorted(BATCHED))
def test_emitted_sums_at_a_batch_match_torch_on_gpu(shape, dim, batch, dtype,
                                                   card_libs):
    """At the batch of each geometry the family emitted for it equals, on
    the card, the twin's sum at that batch and the model, bit for bit."""
    dev = torch.device("cuda")
    d = draw(batch, shape, dtype, 24)
    db = torch.from_numpy(d).to(dev)
    xb = torch.ones((batch, 1), dtype=dtype, device=dev)
    twin = torch.func.vmap(summed(dim))(xb, db)
    out = torch.empty_like(twin)
    torch.cuda.synchronize()
    err = card_libs[shape, dim, batch, dtype].run(
        batch, ctypes.c_void_p(xb.data_ptr()), ctypes.c_void_p(db.data_ptr()),
        ctypes.c_void_p(out.data_ptr()))
    assert err == 0, f"CUDA error {err}"
    same = (out == twin).all(dim=1).float().mean().item()
    assert same == 1.0, f"bit-equal to torch on {same:.4f} of the instances"
    order, groups = BATCHED[shape, dim, batch]
    assert np.array_equal(out.cpu().numpy(), expected(d, dim, order, groups))


_ROW_KERNEL = r"""
#include "solver_warp.cuh"
template <typename T>
__global__ void row_kernel(int B, int n, const T* x, T* out) {
  const int b = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const T* row = x + (size_t)b * n;
  int W, Y;
  tinyopt::torch_row_geometry(n, B, W, Y);
  const T s = tinyopt::torch_row_sum<T>([&](int i) { return row[i]; }, n,
                                        (size_t)b, W, Y, lane);
  if (lane == 0) out[b] = s;
}
extern "C" int run(int B, int n, const void* x, void* out) {
  row_kernel<TT><<<(B + 3) / 4, 128>>>(B, n, (const TT*)x, (TT*)out);
  return (int)cudaDeviceSynchronize();
}
"""

#: (B, n) of the row sums K2's warp kernel adds (torch_row_sum): one warp,
#: 64 threads (a batch of one at 256 and 384, at 96 without vectors),
#: rows that start off a 4-vector (130, 385), and rows split over warps
#: (8,192 at a batch of 4 and of 10,000)
ROWS = ((10_000, 384), (1, 256), (1, 384), (3, 384), (1, 96), (7, 130),
        (33, 385), (5, 1000), (4, 8192), (10_000, 8192))


@pytest.fixture(scope="module")
def row_libs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2's warp kernel's row sums)")
    from tinyopt_tpu_torch import _build
    root = tmp_path_factory.mktemp("k2rows_card")
    procs = {}
    for dtype in DTYPES:
        ct = "float" if dtype == torch.float32 else "double"
        (root / f"{ct}.cu").write_text(_ROW_KERNEL.replace("TT", ct))
        procs[dtype] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             str(root / f"{ct}.so"), str(root / f"{ct}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for dtype, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log[-4000:]
        ct = "float" if dtype == torch.float32 else "double"
        libs[dtype] = ctypes.CDLL(str(root / f"{ct}.so"))
    return libs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,n", ROWS)
def test_kernel_row_sums_match_torch_on_gpu(B, n, dtype, row_libs):
    """K2's warp kernel's row sum (``torch_row_sum``, one warp a row) of a
    contiguous (B, n) tensor equals torch's ``sum(dim=-1)`` of it on the
    card, bit for bit, at batches and lengths of each geometry."""
    dev = torch.device("cuda")
    x = torch.from_numpy(draw(B, (n,), dtype, 25)).to(dev)
    out = torch.empty(B, dtype=dtype, device=dev)
    want = torch.sum(x, dim=-1)
    torch.cuda.synchronize()
    err = row_libs[dtype].run(B, n, ctypes.c_void_p(x.data_ptr()),
                              ctypes.c_void_p(out.data_ptr()))
    assert err == 0, f"CUDA error {err}"
    same = (out == want).float().mean().item()
    assert same == 1.0, f"bit-equal to torch on {same:.4f} of the rows"
