"""tinyopt_tpu_torch — the PyTorch / CUDA port of tinyopt_tpu.

The JAX package ``tinyopt_tpu`` is the reference; this package mirrors its
module paths and solves the same problems with torch tensors, and its two
TPU kernels are hand-written CUDA kernels for Hopper (``csrc/``): K1, the
batched Jacobi-PCG (``ops/cuda_cg.py``), and K2, the whole batched LM/GN
solve (``ops/cuda_solver.py``).  It never imports JAX.

    import torch, tinyopt_tpu_torch as to
    x, out = to.optimize(torch.tensor(1.0), lambda x: x * x - 2)
"""

from .cost import Cost
from .optimize import build_solver, optimize
from .options import (CostScalingOptions, DogLeg, GaussNewton, HessianOptions,
                      LevenbergMarquardt, LMOptions, LogOptions, Options,
                      SolverType)
from .output import Output
from .parallel.batched import batched_optimize, batched_solver
from .stop_reasons import StopReason, stop_reason_description

__all__ = [
    "Cost", "CostScalingOptions", "DogLeg", "GaussNewton", "HessianOptions",
    "LMOptions", "LevenbergMarquardt", "LogOptions", "Options",
    "Output", "SolverType", "StopReason", "batched_optimize",
    "batched_solver", "build_solver", "optimize", "stop_reason_description",
]
