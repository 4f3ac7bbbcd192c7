"""Small shared helpers: the FloatEpsilon policy, per-instance selects and
tic/toc timing.

Counterpart of ``tinyopt_tpu.utils`` (reference: include/tinyopt/time.h and
math.h:297-301) for torch dtypes.
"""

from __future__ import annotations

import time

import torch
from torch.utils import _pytree as pytree


def float_epsilon(dtype) -> float:
    """The reference's FloatEpsilon policy (math.h:297-301): 1e-7 for
    64-bit floats, 1e-4 for narrower.  Shared by the accept/reject
    rel_derr zeroing of the loop, the fused twin and the K2 kernel."""
    return 1e-7 if torch.empty((), dtype=dtype).element_size() >= 8 else 1e-4


def where_instance(pred: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Per-instance select: ``pred`` (B,) broadcast over trailing axes."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


def where_tree(pred: torch.Tensor, a, b):
    """:func:`where_instance` over matching pytrees (an LMState, a loop
    carry, a first-order state); ``None`` leaves stay None."""
    return pytree.tree_map(
        lambda u, v: None if u is None else where_instance(pred, u, v), a, b)


def tic() -> float:
    """Start time in seconds (reference: time.h:22)."""
    return time.perf_counter()


def toc_ms(t0: float) -> float:
    """Milliseconds since ``t0`` (reference: time.h:30-38)."""
    return (time.perf_counter() - t0) * 1e3
