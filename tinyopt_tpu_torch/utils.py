"""Small shared helpers: the FloatEpsilon policy, per-instance selects,
tic/toc timing, a profiler trace, a NaN check and a synchronized timer.

Counterpart of ``tinyopt_tpu.utils`` (reference: include/tinyopt/time.h and
math.h:297-301) for torch dtypes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


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


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of a block: host operations and,
    where CUDA is available, the device's kernels and copies.  Written to
    ``log_dir/trace_<pid>.json`` as a Chrome trace, which Perfetto and
    ``chrome://tracing`` open.  End the block with
    ``torch.cuda.synchronize()`` so that its device work lies inside the
    trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"debug_nans: {func} produced NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError`` at the first operation inside the block
    whose result holds a NaN, naming the operation.

    Torch has no switch like JAX's ``jax_debug_nans``, which the JAX
    package's ``debug_nans`` sets.  So this checks in the forward pass
    instead: a dispatch mode looks at the output of every tensor operation
    the block runs (one device read an operation, a debugging aid, not a
    production path) and raises where one is NaN.  Like
    ``jax_debug_nans`` it also fires on NaNs a computation discards
    afterwards (a ``torch.where`` over both branches).  The production path
    routes NaNs to ``StopReason.SYSTEM_HAS_NAN_OR_INF`` instead
    (``optimizers/loop.py``)."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def block_ms(fn, *args, n: int = 5) -> float:
    """Best-of-``n`` wall-clock milliseconds of ``fn(*args)``, each rep
    ended by ``torch.cuda.synchronize()`` where CUDA is in use, so that
    the device's work lies inside the time.  One unmeasured call first."""
    def run():
        fn(*args)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    run()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3
