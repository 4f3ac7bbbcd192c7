"""Canonical problems and models (counterpart of
``tinyopt_tpu.models``)."""

from .icp import icp, icp_multi_start, make_icp_problem, nearest_neighbors

__all__ = ["icp", "icp_multi_start", "make_icp_problem",
           "nearest_neighbors"]
