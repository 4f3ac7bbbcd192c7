"""Batched and multi-device solving (``torch.distributed``)."""

from .mesh import make_mesh, local_mesh, init_distributed
from .batched import batched_optimize, batched_solver
from .sharded import make_block_system, sharded_optimize
from .schur import make_sharded_schur_system, sharded_schur_optimize
from .schur_obs import (make_sharded_schur_obs_system,
                        sharded_schur_sparse_covariance,
                        sharded_schur_sparse_optimize,
                        sharded_schur_sparse_optimize_buckets)
from .padding import pad_instances, masked_residuals

__all__ = [
    "make_mesh", "local_mesh", "init_distributed",
    "batched_optimize", "batched_solver",
    "make_block_system", "sharded_optimize",
    "make_sharded_schur_system", "sharded_schur_optimize",
    "make_sharded_schur_obs_system", "sharded_schur_sparse_optimize",
    "sharded_schur_sparse_covariance",
    "sharded_schur_sparse_optimize_buckets",
    "pad_instances", "masked_residuals",
]
