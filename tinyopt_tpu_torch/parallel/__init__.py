"""Batched solving."""

from .batched import batched_optimize, batched_solver

__all__ = ["batched_optimize", "batched_solver"]
