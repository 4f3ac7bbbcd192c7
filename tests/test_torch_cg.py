"""K1 and its plain twin: tinyopt_tpu_torch.ops.linalg / ops.cuda_cg against
tinyopt_tpu.ops.linalg and the body of the Pallas CG kernel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyopt_tpu.ops import linalg as jlin
from tinyopt_tpu.ops import pallas_cg
from tinyopt_tpu.ops.pallas_cg import make_cg_solver, pcg_on_values

from tinyopt_tpu_torch.ops import cuda_cg
from tinyopt_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)

# f64: the two packages sum the matvec and the dot products in another
# order, so agreement is to rounding; f32 likewise at single precision.
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _spd(rng, B, d, dtype):
    A = rng.normal(size=(B, 2 * d, d)) / np.sqrt(2 * d)
    H = np.einsum("bki,bkj->bij", A, A) + 1e-3 * np.eye(d)
    b = rng.normal(size=(B, d))
    return H.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("iters", [3, 12])
def test_solve_psd_cg_matches_reference(dtype, iters, monkeypatch):
    H, b = _spd(np.random.default_rng(iters), 13, 9, dtype)
    ref = np.asarray(jlin.solve_psd_cg(jnp.asarray(H), jnp.asarray(b), iters))
    body = np.asarray(pcg_on_values(jnp.asarray(H), jnp.asarray(b), iters))
    vm = np.asarray(jax.vmap(make_cg_solver(iters))(jnp.asarray(H),
                                                    jnp.asarray(b)))
    # the Pallas kernel itself (batch padded to its 256-instance tile), in
    # interpret mode on the CPU
    monkeypatch.setattr(pallas_cg.pl, "pallas_call", functools.partial(
        pallas_cg.pl.pallas_call, interpret=True))
    kern = np.asarray(pallas_cg.batched_cg_tpu(jnp.asarray(H), jnp.asarray(b),
                                               iters))
    got = tlin.solve_psd_cg(torch.from_numpy(H), torch.from_numpy(b),
                            iters).numpy()
    for r in (ref, body, vm, kern):
        np.testing.assert_allclose(got, r, rtol=TOL[dtype], atol=TOL[dtype])


def test_pcg_core_matrix_free_matches_reference():
    rng = np.random.default_rng(5)
    H, b = _spd(rng, 6, 7, np.float64)
    dinv = 1.0 / np.einsum("bii->bi", H)
    ref = jlin.pcg_core(lambda p: jnp.einsum("bij,bj->bi", jnp.asarray(H), p),
                        jnp.asarray(dinv), jnp.asarray(b), 7)
    Ht = torch.from_numpy(H)
    got = tlin.pcg_core(lambda p: torch.einsum("bij,bj->bi", Ht, p),
                        torch.from_numpy(dinv), torch.from_numpy(b), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_alpha_freeze_on_zero_curvature():
    """pᵀHp ≤ tiny freezes the iterate (α = 0): H = 0 leaves x at 0; a
    zero row/column with a zero right-hand side never moves its
    coordinate."""
    rng = np.random.default_rng(1)
    H, b = _spd(rng, 4, 5, np.float64)
    H[0] = 0.0
    H[1, -1, :] = 0.0
    H[1, :, -1] = 0.0
    b[1, -1] = 0.0
    ref = np.asarray(jlin.solve_psd_cg(jnp.asarray(H), jnp.asarray(b), 6))
    got = cuda_cg.cg_solve(torch.from_numpy(H), torch.from_numpy(b),
                           6).numpy()
    assert np.all(got[0] == 0.0) and np.all(ref[0] == 0.0)
    assert got[1, -1] == 0.0 and ref[1, -1] == 0.0
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_column_products_equal_row_products_on_symmetric_h():
    """K1's kernels form Hp from H's columns (Hᵀp); on a symmetric H that
    is the twin's row products Hp to rounding, so the design needs only
    symmetry."""
    rng = np.random.default_rng(8)
    H, b = _spd(rng, 8, 96, np.float64)
    H = 0.5 * (H + np.swapaxes(H, -1, -2))      # symmetric bit for bit
    Ht, bt = torch.from_numpy(H), torch.from_numpy(b)
    dinv = tlin.jacobi_inverse(torch.diagonal(Ht, dim1=-2, dim2=-1))
    rows = tlin.pcg_core(lambda p: (Ht @ p[..., None])[..., 0], dinv, bt, 96)
    cols = tlin.pcg_core(lambda p: (Ht.mT @ p[..., None])[..., 0], dinv, bt,
                         96)
    scale = rows.abs().max().item()
    assert (cols - rows).abs().max().item() <= 1e-12 * scale


def test_damp_and_cholesky_solve_match_reference():
    rng = np.random.default_rng(2)
    H, b = _spd(rng, 5, 6, np.float64)
    H[2] = -H[2]                                 # not PSD: must fail
    lam = rng.uniform(1e-4, 1.0, (5,))
    Hd_ref = jax.vmap(jlin.damp_diagonal)(jnp.asarray(H), jnp.asarray(lam))
    Hd = tlin.damp_diagonal(torch.from_numpy(H), torch.from_numpy(lam))
    np.testing.assert_array_equal(Hd.numpy(), np.asarray(Hd_ref))
    dx_r, ok_r = jlin.solve_psd(Hd_ref, jnp.asarray(b))
    dx, ok = tlin.solve_psd(Hd, torch.from_numpy(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert not bool(ok[2])
    np.testing.assert_allclose(dx.numpy()[ok.numpy()],
                               np.asarray(dx_r)[np.asarray(ok_r)],
                               rtol=1e-10, atol=1e-12)


def test_cg_solve_on_cpu_takes_the_twin():
    H, b = _spd(np.random.default_rng(3), 8, 4, np.float32)
    before = cuda_cg.cg_solve.launches
    x = cuda_cg.cg_solve(torch.from_numpy(H), torch.from_numpy(b), 4)
    assert cuda_cg.cg_solve.launches == before
    np.testing.assert_array_equal(
        x.numpy(), tlin.solve_psd_cg(torch.from_numpy(H), torch.from_numpy(b),
                                     4).numpy())


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [9, 13, 33, 50, 64, 65, 96, 100, 128, 129,
                               200, 300])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_launch_plan(d, itemsize, offset):
    """The kernel, copy mode and geometry K1 takes, from the shape and H's
    address alone: ``offset`` values past a 256-byte aligned base."""
    B = 10_007
    plan = cuda_cg.k1_launch_plan(B, d, itemsize, 4096 + offset * itemsize)
    assert plan.smem_bytes <= cuda_cg.MAX_SMEM
    # one bulk copy needs 16-byte multiples: d*d*itemsize and the address
    bulk = (d * d * itemsize) % 16 == 0 and offset == 0
    if d > 64:
        assert plan.path == "block"
        # a thread a column: d threads rounded up to a warp
        assert plan.cols == 1 and plan.warps == -(-d // 32)
        # H in shared memory while the block's layout fits 227 KB: d = 300
        # is 360 KB in float32 and 720 KB in float64, d = 200 in float64
        # 320 KB; there its columns are read from device memory
        in_smem = d < 300 and (itemsize == 4 or d < 200)
        h_buf = -(-d * d * itemsize // 128) * 128 if in_smem else 0
        p_buf = -(-(-(-d // 8) * 8 * itemsize) // 128) * 128
        assert plan.smem_bytes == 128 + (64 * itemsize + 127) // 128 * 128 \
            + p_buf + h_buf
        if not in_smem:
            assert (plan.h_in, plan.copy, plan.reg_rows) == ("device", "none",
                                                             0)
            return
        assert plan.copy == ("bulk" if bulk else "elementwise")
        if d <= (128 if itemsize == 4 else 96):
            # the whole column in registers, rows rounded up to 8
            assert plan.h_in == "registers"
            assert plan.reg_rows == -(-d // 8) * 8 >= d
        else:
            # 64 rows of it, the rest read from shared memory
            assert (plan.h_in, plan.reg_rows) == ("split", 64)
        return
    assert plan.path == "warp" and (plan.reg_rows, plan.cols) == (0, 1)
    # a lane's 2d values fit its registers in float32, and in float64 up
    # to d = 32; above, float64 keeps column j + 32 in shared memory
    assert plan.h_in == ("split" if itemsize == 8 and d > 32 else "registers")
    assert plan.copy == ("bulk" if bulk else "elementwise")
    assert d not in (9, 13) or itemsize == 8 or plan.copy == "elementwise"
    assert plan.warps == cuda_cg.WARP_WARPS[itemsize]
    # one 128-byte aligned buffer of one H a warp, 8 values of slack, rows
    # padded to an even length under "split"
    ld = d + d % 2 if plan.h_in == "split" else d
    h_buf = -(-(d * ld + 8) * itemsize // 128) * 128
    assert plan.smem_bytes == 128 + plan.warps * (64 * itemsize + h_buf)


@pytest.mark.parametrize("d,itemsize,cols", [
    (1024, 8, 1), (1025, 8, 2), (2049, 8, 3), (4096, 8, 4), (4097, 4, 5),
    (6000, 4, 6), (4500, 8, 5), (11_584, 4, 12), (5_792, 8, 6)])
def test_k1_launch_plan_many_columns(d, itemsize, cols):
    """Past 1024 a thread owns several columns (the wide kernel), whose
    state — p, Hp, r, x and 1/H[j][j] — lives in shared memory, so K1 runs
    up to the d whose five vectors fill a block's 227 KB: 11,584 in
    float32, 5,792 in float64.  Beyond, it refuses."""
    plan = cuda_cg.k1_launch_plan(4, d, itemsize, 0)
    assert (plan.path, plan.h_in, plan.copy, plan.cols) == (
        "block", "device", "none", cols)
    assert plan.warps * 32 <= cuda_cg.BLOCK_MAX_THREADS
    assert plan.warps * 32 * cols >= d
    vecs = 1 if cols == 1 else cuda_cg.WIDE_VECTORS
    assert plan.smem_bytes == 128 + (64 * itemsize + 127) // 128 * 128 \
        + vecs * (-(-(-(-d // 8) * 8 * itemsize) // 128) * 128)
    assert plan.smem_bytes <= cuda_cg.MAX_SMEM
    with pytest.raises(ValueError):
        cuda_cg.k1_launch_plan(4, 11_585 if itemsize == 4 else 5_793,
                               itemsize, 0)


def test_k1_grids_are_persistent():
    """Both kernels launch at most the blocks that fit the device at once
    and stride over instances, so a batch larger than the resident blocks
    runs in one launch."""
    import re
    from tinyopt_tpu_torch import _build
    with open(f"{_build.CSRC}/cg.cu") as f:
        src = f.read()
    launch = src[src.index("int launch_cg("):]
    assert re.search(r"const int grid = \(int\)\(need < fit \? need : fit\);",
                     launch)
    assert re.search(r"const int grid = B < fit \? B : fit;", launch)
    assert "inst += nwarps" in src and "inst += gridDim.x" in src


def test_k1_launch_plan_small_batch():
    """No more warps a block than instances; no other itemsize."""
    assert cuda_cg.k1_launch_plan(1, 50, 4, 0).warps == 1
    assert cuda_cg.k1_launch_plan(3, 50, 4, 0).warps == 3
    assert cuda_cg.k1_launch_plan(3, 50, 8, 0).warps == 2
    with pytest.raises(ValueError):
        cuda_cg.k1_launch_plan(100, 50, 2, 0)


def test_k1_entry_point_matches_its_declaration():
    """The plan reaches csrc/cg.cu through ctypes: the C entry points take
    as many arguments as ``_build.load`` declares, and the kernel's codes
    for where H is read are those of ``cuda_cg.H_IN_CODES``."""
    import inspect
    import re
    from tinyopt_tpu_torch import _build
    with open(f"{_build.CSRC}/cg.cu") as f:
        src = f.read()
    enum = re.search(r"enum HIn \{([^}]*)\}", src).group(1)
    codes = {m[0]: int(m[1]) for m in re.findall(r"k(\w+) = (\d+)", enum)}
    assert {k.lower(): v for k, v in codes.items()} == cuda_cg.H_IN_CODES
    decl = inspect.getsource(_build.load)
    n_declared = re.search(r"argtypes = \[([^\]]*)\]", decl).group(1).count(",") + 1
    for name in ("tinyopt_cg_f32", "tinyopt_cg_f64"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
        assert params.count(",") + 1 == n_declared == 14, name


def _spd_on_card(seed, B, d):
    """``_spd``'s distribution in float64, drawn on the card: numpy's
    einsum takes minutes at d in the thousands."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((B, 2 * d, d), generator=g, dtype=torch.float64,
                    device="cuda") / np.sqrt(2 * d)
    H = A.mT @ A + 1e-3 * torch.eye(d, dtype=torch.float64, device="cuda")
    return H, torch.randn((B, d), generator=g, dtype=torch.float64,
                          device="cuda")


def _hold_against_f64_twin(Hc, bc, iters, zero=None):
    """K1 on ``Hc`` and on an offset view of it, each held against the
    float64 twin on the same inputs: float64 within 1e-11·max|x|; float32
    no farther than twice the float32 twin's own gap, or 1e-5·max|x|
    where that is larger.  Instances ``zero`` (a slice; H = 0 there) must
    stay at 0."""
    x64 = tlin.solve_psd_cg(Hc.double(), bc.double(), iters)
    scale = max(1.0, x64.abs().max().item())
    if Hc.dtype == torch.float32:
        twin_gap = (tlin.solve_psd_cg(Hc, bc, iters).double()
                    - x64).abs().max()
        limit = max(2 * twin_gap.item(), 1e-5 * scale)
    else:
        limit = 1e-11 * scale
    for Hk in (Hc, _offset_view(Hc)):
        before = cuda_cg.cg_solve.launches
        xk = cuda_cg.cg_solve(Hk, bc, iters)
        assert cuda_cg.cg_solve.launches == before + 1
        torch.cuda.synchronize()
        if zero is not None:
            assert torch.all(xk[zero] == 0)
        err = (xk.double() - x64).abs().max().item()
        assert err <= limit, (err, limit, Hk.shape)


def _offset_view(H):
    """The same values as ``H`` in a contiguous view one element past an
    aligned base, so the warp kernel must copy element by element."""
    flat = torch.empty(H.numel() + 1, dtype=H.dtype, device=H.device)
    view = flat[1:].view(H.shape)
    view.copy_(H)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,d", [
    (B, d) for d in (9, 13, 33, 50, 64, 65, 96, 97, 100, 128, 129, 200, 300)
    for B in (1, 3, 10_007 if d <= 100 else 257)] + [
    (B, d) for d in (1024, 1100, 2100) for B in (1, 3)])
def test_k1_shapes_on_gpu(dtype, B, d):
    """Both kernels, both copy modes and the ragged edges (d = 33: rows
    padded to an even length under "split"; the block kernel's ways of
    reading H: its whole column in registers, 64 rows of it with the rest
    from shared memory ("split"), and from device memory at d = 300 and
    1024, and by the wide kernel at d = 1100 and 2100, two and three
    columns a thread; B = 10,007 more instances than resident blocks), 8
    iterations; H = 0 in every other instance freezes x at 0 (α = 0).
    Each is held against the float64 twin (``_hold_against_f64_twin``).
    At d = 9, 8 iterations run CG to exhaustion and float32 iterates are
    rounding noise, twin and kernel alike, so the twin's gap there is the
    scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    if d > 300:
        Hc, bc = _spd_on_card(d, B, d)
    else:
        H, b = _spd(np.random.default_rng(d), B, d, np.float64)
        Hc, bc = torch.from_numpy(H).cuda(), torch.from_numpy(b).cuda()
    Hc[1::2] = 0.0
    _hold_against_f64_twin(Hc.to(dtype), bc.to(dtype), 8,
                           zero=slice(1, None, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 6000),
                                     (torch.float64, 4500)])
def test_k1_wide_on_gpu(dtype, d):
    """The wide kernel at d past what a register array of columns a
    thread could take (6 and 5 columns a thread), one instance, 8
    iterations, against the float64 twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    Hc, bc = _spd_on_card(d, 1, d)
    _hold_against_f64_twin(Hc.to(dtype), bc.to(dtype), 8)
    del Hc, bc
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_batch_sizes_in_any_order_on_gpu(dtype):
    """A block of fewer warps (B = 3) between two of more (B = 10,007,
    B = 257) of the same kernel: each launch admits the shared memory it
    needs, whatever size launched before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    tol = 1e-5 if dtype == torch.float32 else 1e-11
    for B in (10_007, 3, 257):
        H, b = _spd(np.random.default_rng(B), B, 50, np.float64)
        Hc = torch.from_numpy(H).to("cuda", dtype)
        bc = torch.from_numpy(b).to("cuda", dtype)
        xk = cuda_cg.cg_solve(Hc, bc, 8)
        xt = tlin.solve_psd_cg(Hc, bc, 8)
        err = (xk - xt).abs().max().item()
        assert err <= tol * max(1.0, xt.abs().max().item()), (B, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_kernel_matches_twin_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    H, b = _spd(np.random.default_rng(4), 1000, 50, np.float64)
    Hc = torch.from_numpy(H).to("cuda", dtype)
    bc = torch.from_numpy(b).to("cuda", dtype)
    before = cuda_cg.cg_solve.launches
    xk = cuda_cg.cg_solve(Hc, bc, 12)
    assert cuda_cg.cg_solve.launches == before + 1
    xt = tlin.solve_psd_cg(Hc, bc, 12)
    # max error relative to max|x| (chip_smoke.py phase 3): the kernel and
    # cuBLAS sum in another order
    tol = 1e-5 if dtype == torch.float32 else 1e-11
    err = (xk - xt).abs().max().item()
    assert err <= tol * max(1.0, xt.abs().max().item()), err
