"""Canonical problems and models (counterpart of
``tinyopt_tpu.models``)."""

from . import problems
from .icp import icp, icp_multi_start, make_icp_problem, nearest_neighbors
from .se3_refinement import make_se3_refinement

__all__ = ["problems", "make_se3_refinement", "icp", "icp_multi_start",
           "make_icp_problem", "nearest_neighbors"]
