"""Linear algebra, column coloring and the CUDA kernels K1 and K2."""

from .linalg import damp_diagonal, inv_cov, solve_psd

__all__ = ["solve_psd", "inv_cov", "damp_diagonal"]
