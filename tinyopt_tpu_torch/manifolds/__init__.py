"""Registered manifold parameter types (counterpart of
``tinyopt_tpu.manifolds``; SEn3 is not ported yet, ROADMAP Queue 1 item 9)."""

from .se23 import SE23
from .se3 import SE3
from .so3 import SO3

__all__ = ["SO3", "SE3", "SE23"]
