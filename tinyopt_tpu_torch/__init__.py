"""tinyopt_tpu_torch — the PyTorch / CUDA port of tinyopt_tpu.

The JAX package ``tinyopt_tpu`` is the reference; this package mirrors its
module paths and solves the same problems with torch tensors, and its two
TPU kernels are hand-written CUDA kernels for Hopper (``csrc/``): K1, the
batched Jacobi-PCG (``ops/cuda_cg.py``), and K2, the whole batched
GN / LM / DogLeg solve (``ops/cuda_solver.py``).  ``losses`` holds the
norms and robust M-estimators, ``diff`` the automatic and numerical
differentiation and the gradient checker.  It never imports JAX.

    import torch, tinyopt_tpu_torch as to
    x, out = to.optimize(torch.tensor(1.0), lambda x: x * x - 2)
    x, out = to.dogleg.optimize(torch.tensor([-1.2, 1.0]), fn)
"""

from . import diff, losses
from .cost import Cost
from .optimize import build_solver, optimize
from .options import (LBFGS, SGD, Adam, AdamW, CostScalingOptions, DogLeg,
                      GaussNewton, GradientDescent, HessianOptions,
                      LevenbergMarquardt, LMOptions, LogOptions, Options,
                      SolverType)
from .output import Output
from .parallel.batched import batched_optimize, batched_solver
from .stop_reasons import StopReason, stop_reason_description

# Namespace products mirroring the reference (optimizers/{nlls,unconstrained}.h)
from . import _methods as _m  # noqa: E402
lm = _m.lm
gn = _m.gn
gd = _m.gd
sgd = _m.sgd
adam = _m.adam
adamw = _m.adamw
lbfgs = _m.lbfgs
dogleg = _m.dogleg
nlls = _m.lm
unconstrained = _m.gd

__all__ = [
    "Adam", "AdamW", "Cost", "CostScalingOptions", "DogLeg", "GaussNewton",
    "GradientDescent", "HessianOptions", "LBFGS", "LMOptions",
    "LevenbergMarquardt", "LogOptions", "Options", "Output", "SGD",
    "SolverType", "StopReason", "adam", "adamw", "batched_optimize",
    "batched_solver", "build_solver", "diff", "dogleg", "gd", "gn", "lbfgs",
    "lm", "losses",
    "nlls", "optimize", "sgd", "stop_reason_description", "unconstrained",
]
