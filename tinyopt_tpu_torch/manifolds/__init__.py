"""Registered manifold parameter types (counterpart of
``tinyopt_tpu.manifolds``)."""

from .se23 import SE23
from .se3 import SE3
from .sen3 import SEn3
from .so3 import SO3

__all__ = ["SO3", "SE3", "SE23", "SEn3"]
