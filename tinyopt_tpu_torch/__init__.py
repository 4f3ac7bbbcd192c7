"""tinyopt_tpu_torch — the PyTorch / CUDA port of tinyopt_tpu.

The JAX package ``tinyopt_tpu`` is the reference; this package mirrors its
module paths and solves the same problems with torch tensors, and its two
TPU kernels are hand-written CUDA kernels for Hopper (``csrc/``): K1, the
batched Jacobi-PCG (``ops/cuda_cg.py``), and K2, the whole batched
GN / LM / DogLeg solve (``ops/cuda_solver.py``).  ``losses`` holds the
norms and robust M-estimators, ``diff`` the automatic and numerical
differentiation and the gradient checker; the first-order solvers, the
segmented solve (``checkpoint``), covariance recovery and implicit
differentiation (``implicit``) run on the same loop, and so do the
block-diagonal, general-sparse, matrix-free and Schur-complement
(bundle adjustment) solves of ``sparse`` (``block_optimize``,
``sparse_optimize``, ``matfree_optimize``, ``schur_optimize``, and for
sparse visibility ``schur_sparse_optimize`` with
``schur_sparse_covariance``, K-bucketed for heavy-tailed visibility in
``schur_sparse_optimize_buckets`` / ``schur_sparse_covariance_buckets``),
and the
chain solver of pose graphs (``chain_optimize``, ``chain_marginals``:
block-tridiagonal Cholesky or cyclic reduction with Woodbury loop
closures, ``ops/tridiag.py``).  ``parallel`` splits a batch or one large
problem over the ranks of ``torch.distributed`` (``sharded_optimize``,
``sharded_schur_optimize``, ``sharded_schur_sparse_optimize``...).  It
never imports JAX.

    import torch, tinyopt_tpu_torch as to
    x, out = to.optimize(torch.tensor(1.0), lambda x: x * x - 2)
    x, out = to.dogleg.optimize(torch.tensor([-1.2, 1.0]), fn)
    x, out = to.adam.optimize(x0, lambda x: torch.sum((x - 1) ** 2))
"""

from . import chain, checkpoint, diff, implicit, losses, sparse
from .chain import ChainSystem, chain_marginals, chain_optimize
from .checkpoint import Stepper, stepper
from .cost import Cost
from .implicit import implicit_solver
from .manifold import (Manifold, TangentSpec, local, register_manifold,
                       retract, tangent_spec)
from .optimize import (Optimize, build_solver, covariance_at,
                       multi_start_optimize, optimize)
from .options import (LBFGS, SGD, Adam, AdamOptions, AdamW,
                      CostScalingOptions, DogLeg, GaussNewton, GDOptions,
                      GradientDescent, HessianOptions, LBFGSOptions,
                      LevenbergMarquardt, LMOptions, LogOptions, Options,
                      SGDOptions, SolverType)
from .ops.block import BlockDiag
from .ops.sparse_sym import SparseSym
from .output import Output
from .parallel import (batched_optimize, batched_solver, sharded_optimize,
                       sharded_schur_optimize,
                       sharded_schur_sparse_covariance)
from .profiling import dispatch_floor, profile_iterations
from .sparse import (block_optimize, matfree_optimize, schur_optimize,
                     schur_sparse_covariance, schur_sparse_covariance_buckets,
                     schur_sparse_optimize, schur_sparse_optimize_buckets,
                     sparse_optimize)
from .stop_reasons import StopReason, stop_reason_description
from .version import __version__
from . import manifolds, models, parallel, utils  # noqa: E402

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
    "__version__", "Manifold", "TangentSpec", "register_manifold",
    "retract", "local", "tangent_spec", "manifolds", "models", "parallel",
    "utils",
    "Adam", "AdamOptions", "AdamW", "BlockDiag", "ChainSystem", "Cost",
    "CostScalingOptions", "DogLeg",
    "GDOptions", "GaussNewton", "GradientDescent", "HessianOptions",
    "LBFGS", "LBFGSOptions", "LMOptions", "LevenbergMarquardt", "LogOptions",
    "Optimize", "Options", "Output", "SGD", "SGDOptions", "SolverType",
    "SparseSym", "StopReason", "Stepper", "adam", "adamw",
    "batched_optimize", "batched_solver", "block_optimize", "build_solver",
    "chain", "chain_marginals", "chain_optimize", "checkpoint",
    "covariance_at", "diff", "dispatch_floor", "dogleg", "gd",
    "gn", "implicit", "implicit_solver", "lbfgs", "lm", "losses",
    "matfree_optimize", "multi_start_optimize", "nlls", "optimize",
    "profile_iterations", "schur_optimize", "schur_sparse_covariance",
    "schur_sparse_covariance_buckets", "schur_sparse_optimize",
    "schur_sparse_optimize_buckets", "sgd", "sharded_optimize",
    "sharded_schur_optimize", "sharded_schur_sparse_covariance", "sparse",
    "sparse_optimize", "stepper", "stop_reason_description", "unconstrained",
]
