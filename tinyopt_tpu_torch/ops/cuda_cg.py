"""K1 — the batched Jacobi-PCG kernel (``csrc/cg.cu``) and its wrapper.

Counterpart of ``tinyopt_tpu/ops/pallas_cg.py`` (``_cg_kernel`` launched by
``batched_cg_tpu``).  Torch has no ``custom_vmap``: the batch-native
optimizer loop calls :func:`cg_solve` on the whole (B, d, d) batch
directly.

:func:`cg_solve` takes the plain twin, ``ops.linalg.solve_psd_cg``, only
for tensors on the CPU.  A CUDA tensor always launches the kernel; a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from .linalg import solve_psd_cg

__all__ = ["cg_solve", "cg_solve_cuda", "solve_psd_cg"]


def cg_solve_cuda(H: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Launch K1 on ``H`` (B, d, d) and ``b`` (B, d), both CUDA tensors of
    one float dtype, on the current stream."""
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
    lib = _build.load()
    fn = lib.tinyopt_cg_f32 if H.dtype == torch.float32 else lib.tinyopt_cg_f64
    with torch.cuda.device(H.device):
        err = fn(H.data_ptr(), b.data_ptr(), x.data_ptr(), B, d, int(iters),
                 torch.cuda.current_stream(H.device).cuda_stream)
    _build.check(err, "K1 cg kernel")
    cg_solve.launches += 1
    return x


def cg_solve(H: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched Jacobi-PCG ``H x = b`` with exactly ``iters`` iterations.

    ``H`` (B, d, d), ``b`` (B, d).  CPU tensors run the plain twin
    (``solve_psd_cg``); CUDA tensors launch K1 and add one to
    ``cg_solve.launches``."""
    if H.device.type == "cpu":
        return solve_psd_cg(H, b, iters)
    if H.device.type != "cuda":
        raise ValueError(f"cg_solve: no kernel for device {H.device}")
    return cg_solve_cuda(H, b, iters)


#: Number of K1 launches in this process (reset freely by callers).
cg_solve.launches = 0
