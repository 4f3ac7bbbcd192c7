"""K1 — the batched Jacobi-PCG kernel (``csrc/cg.cu``) and its wrapper.

Counterpart of ``tinyopt_tpu/ops/pallas_cg.py`` (``_cg_kernel`` launched by
``batched_cg_tpu``).  Torch has no ``custom_vmap``: the batch-native
optimizer loop calls :func:`cg_solve` on the whole (B, d, d) batch
directly.

:func:`cg_solve` takes the plain twin, ``ops.linalg.solve_psd_cg``, only
for tensors on the CPU.  A CUDA tensor always launches the kernel; a
kernel that fails to build or launch raises.  Which of K1's two kernels
runs, and how, is decided here from the shape and H's address alone
(:func:`k1_launch_plan`), so the CPU tests check every choice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg import solve_psd_cg

__all__ = ["K1Plan", "cg_solve", "cg_solve_cuda", "k1_launch_plan",
           "solve_psd_cg"]

#: Dynamic shared memory a block may use on Hopper (csrc/common.cuh).
MAX_SMEM = 232448
#: The warp kernel gives each lane two columns: d ≤ 64.
WARP_MAX_D = 64
#: Warps per block of the warp kernel, by itemsize, each with one buffer
#: of one instance's H: timed fastest on an H100 at 10k×50×50 (PERF.md §6,
#: PR 3, with deeper rings and H in shared memory, both slower).
WARP_WARPS = {4: 4, 8: 2}
#: Where K1's iterations read H (the entry point's ``h_in``, csrc/cg.cu).
H_IN_CODES = {"device": 0, "split": 1, "registers": 2}
#: Threads a block of the block kernel: one a column up to 1024; past
#: that, ``cg_block_wide_kernel`` gives a thread several columns.
BLOCK_MAX_THREADS = 1024
#: Vectors of d values the wide kernel keeps in shared memory: p, Hp, r,
#: x and 1/H[j][j] (``kWideVectors``).
WIDE_VECTORS = 5
#: The block kernel holds a thread's whole column in registers up to this
#: d (rounded up to 8 rows), by itemsize.
BLOCK_REG_MAX_D = {4: 128, 8: 96}
#: Rows of a column held in registers where the whole column is not, the
#: rest read from shared memory at every iteration ("split").  On an H100
#: at (1000, 96, 96) the whole column ran fastest, then 64 rows, 32 rows
#: and none, and 64 rows beat 32 and none at d = 100 and 128 (PERF.md §6).
BLOCK_SPLIT_ROWS = 64


class K1Plan(NamedTuple):
    """How K1 runs one call (the arguments of ``tinyopt_cg_f32/f64``).

    ``path``: "warp" (one warp per instance, d ≤ 64) or "block" (one
    block per instance at a time, d > 64).  Both launch a persistent
    grid: at most the blocks that fit the device at once, each striding
    over instances.  ``h_in``: where the iterations read H —
    "registers" (warp path: float32, and float64 at d ≤ 32; block path:
    the thread's whole column), "split" (warp path, float64 at d > 32:
    column j in registers, j + 32 in shared memory; block path: rows
    ``reg_rows`` onwards of the column from shared memory) or "device"
    (block path, where H does not fit 227 KB: from device memory).
    ``copy``: how H reaches shared memory — "bulk" (one
    ``cp.async.bulk`` per instance), "elementwise" (per-value
    ``cp.async``) or "none" (read from device memory).  ``reg_rows``:
    rows of a column a block-path thread holds in registers; ``cols``:
    columns a block-path thread owns, more than one only in the wide
    kernel past 1024 (both 0 and 1 on the warp path, which does not read
    them).  ``warps`` per block, ``smem_bytes`` per block."""
    path: str
    h_in: str
    copy: str
    warps: int
    smem_bytes: int
    reg_rows: int = 0
    cols: int = 1


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _warp_smem_bytes(d: int, itemsize: int, warps: int) -> int:
    """Shared memory of one block of the warp kernel (``WarpLayout`` in
    csrc/cg.cu): the warps' mbarriers, their p buffers of 64 values, and
    one buffer of one H a warp — d rows, an even number of values apart
    under "split", and 8 values more — 128-byte aligned."""
    ld = d + (d & 1) if itemsize == 8 and d > 32 else d
    return (_round_up(8 * warps, 128) + warps * WARP_MAX_D * itemsize
            + warps * _round_up((d * ld + 8) * itemsize, 128))


def _block_smem_bytes(d: int, itemsize: int, h_in_smem: bool,
                      vectors: int = 1) -> int:
    """Shared memory of one block of the block kernels (``BlockLayout`` in
    csrc/cg.cu): the mbarrier, two sets of 32 reduction slots, ``vectors``
    vectors of d values rounded up to 8 (p; the wide kernel's column
    state), and one buffer of one H unless H is read from device memory,
    each 128-byte aligned."""
    return (128 + _round_up(64 * itemsize, 128)
            + vectors * _round_up(_round_up(d, 8) * itemsize, 128)
            + (_round_up(d * d * itemsize, 128) if h_in_smem else 0))


def k1_launch_plan(B: int, d: int, itemsize: int, h_ptr: int) -> K1Plan:
    """Pick K1's kernel and launch geometry from the shape and H's address.

    d ≤ 64 takes the warp kernel, with as much of H in registers as fits
    a lane: all of it in float32, and in float64 at d ≤ 32; one of a
    lane's two columns in float64 above.  Larger d takes the block
    kernel: a thread a column, the whole column in registers up to
    ``BLOCK_REG_MAX_D``, else ``BLOCK_SPLIT_ROWS`` rows of it with the
    rest in shared memory, and H read from device memory where it does
    not fit a block's 227 KB.  Past 1024 the wide kernel gives a thread
    ``cols`` columns and reads H from device memory, up to the d whose
    ``WIDE_VECTORS`` vectors fill a block's shared memory (11,584 in
    float32, 5,792 in float64); beyond, K1 raises.  The copy is one bulk
    copy per instance when an instance's H (d·d·itemsize bytes) and
    ``h_ptr`` are multiples of 16 bytes, per-value ``cp.async``
    otherwise."""
    if itemsize not in (4, 8):
        raise ValueError(f"k1_launch_plan: itemsize {itemsize}")
    h_bytes = d * d * itemsize
    bulk = h_bytes % 16 == 0 and h_ptr % 16 == 0
    copy = "bulk" if bulk else "elementwise"
    if d <= WARP_MAX_D:
        h_in = "split" if itemsize == 8 and d > 32 else "registers"
        warps = max(1, min(WARP_WARPS[itemsize], B))
        return K1Plan("warp", h_in, copy, warps,
                      _warp_smem_bytes(d, itemsize, warps))
    if d > BLOCK_MAX_THREADS:
        cols = -(-d // BLOCK_MAX_THREADS)
        smem = _block_smem_bytes(d, itemsize, False, WIDE_VECTORS)
        if smem > MAX_SMEM:
            raise ValueError(f"k1_launch_plan: d = {d} needs {smem} bytes "
                             f"of shared memory, more than {MAX_SMEM}")
        return K1Plan("block", "device", "none", -(-d // (32 * cols)), smem,
                      0, cols)
    warps = -(-d // 32)
    smem = _block_smem_bytes(d, itemsize, True)
    if smem > MAX_SMEM:
        return K1Plan("block", "device", "none", warps,
                      _block_smem_bytes(d, itemsize, False))
    if d <= BLOCK_REG_MAX_D[itemsize]:
        return K1Plan("block", "registers", copy, warps, smem,
                      _round_up(d, 8))
    return K1Plan("block", "split", copy, warps, smem, BLOCK_SPLIT_ROWS)


def cg_solve_cuda(H: torch.Tensor, b: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """Launch K1 on ``H`` (B, d, d), symmetric, and ``b`` (B, d), both
    CUDA tensors of one float dtype, on the current stream, as
    :func:`k1_launch_plan` of the inputs says."""
    from .. import _build

    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cg_solve: unsupported dtype {H.dtype}")
    if H.dim() != 3 or b.dim() != 2 or H.shape[0] != b.shape[0] \
            or H.shape[1] != H.shape[2] or H.shape[2] != b.shape[1]:
        raise ValueError(f"cg_solve: bad shapes H{tuple(H.shape)} "
                         f"b{tuple(b.shape)}")
    if b.dtype != H.dtype or b.device != H.device:
        raise ValueError("cg_solve: H and b must share dtype and device")
    H = H.contiguous()
    b = b.contiguous()
    x = torch.empty_like(b)
    B, d = b.shape
    plan = k1_launch_plan(B, d, H.element_size(), H.data_ptr())
    lib = _build.load()
    fn = lib.tinyopt_cg_f32 if H.dtype == torch.float32 else lib.tinyopt_cg_f64
    with torch.cuda.device(H.device):
        err = fn(H.data_ptr(), b.data_ptr(), x.data_ptr(), B, d, int(iters),
                 int(plan.path == "warp"), H_IN_CODES[plan.h_in],
                 int(plan.copy == "bulk"), plan.reg_rows, plan.cols,
                 plan.warps, plan.smem_bytes,
                 torch.cuda.current_stream(H.device).cuda_stream)
    _build.check(err, "K1 cg kernel")
    cg_solve.launches += 1
    return x


def cg_solve(H: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched Jacobi-PCG ``H x = b`` with exactly ``iters`` iterations.

    ``H`` (B, d, d) must be symmetric: both of K1's kernels form Hp from
    H's columns (as the reference's "sublane" matvec did), so for an H that is
    not bit-for-bit symmetric it agrees with the twin's row products only
    to rounding.  ``b`` (B, d).  CPU tensors run the plain twin
    (``solve_psd_cg``); CUDA tensors launch K1 and add one to
    ``cg_solve.launches``."""
    if H.device.type == "cpu":
        return solve_psd_cg(H, b, iters)
    if H.device.type != "cuda":
        raise ValueError(f"cg_solve: no kernel for device {H.device}")
    return cg_solve_cuda(H, b, iters)


#: Number of K1 launches in this process (reset freely by callers).
cg_solve.launches = 0
