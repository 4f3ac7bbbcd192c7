"""Per-iteration timing through the one-iteration ``Stepper``.

Counterpart of ``tinyopt_tpu.profiling``.  :func:`profile_iterations`
drives the loop one iteration a call (``checkpoint.stepper``: each step
runs exactly the iteration the whole loop would) and clocks each call on
the host, forcing a read of the iteration's cost so the clock includes
the device's work.  An untimed pass from the true start comes first; the
timed pass starts from ``x0`` retracted by a random tangent of size
``perturb`` (``perturb=0``: the exact trajectory).
:func:`dispatch_floor` is the fixed cost a step pays on the device of
the caller: one trivial launch and its read back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .checkpoint import stepper
from .optimize import _RUNNING
from .options import Options


def dispatch_floor(reps: int = 5, device="cuda") -> float:
    """Seconds of one trivial launch on ``device`` and the read of its
    result (the least of ``reps``), after one untimed call."""
    x = torch.zeros((), device=device)
    float(x + 1.0)
    ts = []
    for i in range(reps):
        x = torch.full((), float(i), device=device)
        t0 = time.perf_counter()
        float(x + 1.0)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def profile_iterations(x0, fn: Callable, options: Options | None = None,
                       *, mode: str = "auto", perturb: float = 1e-6,
                       seed: int = 0):
    """Solve one instance while clocking every iteration: ``(x, Output,
    tau_s)``, ``tau_s`` a float64 array of per-iteration wall seconds of
    length ``Output.num_iters``.  The perturbation is drawn from a
    ``torch.Generator`` seeded with ``seed``, on the parameters'
    device."""
    options = options or Options()
    x0 = mf.as_pytree(x0)
    st = stepper(fn, options, x_example=x0, mode=mode)
    budget = options.max_iters + 1 + (1 if options.check_final_cost else 0)

    def drive(x_start, clock):
        taus = []
        out = state = None
        for _ in range(budget):
            t0 = time.perf_counter()
            if state is None:
                _, out, state = st.step(x_start)
            else:
                _, out, state = st.step(state=state)
            float(out.final_cost.cost)          # forced completion read
            if clock:
                taus.append(time.perf_counter() - t0)
            if int(out.stop_reason) not in _RUNNING:
                break
        return st.best_x(state), out, np.asarray(taus, np.float64)

    drive(x0, clock=False)
    if perturb:
        spec = mf.tangent_spec(x0)
        device = torch.as_tensor(pytree.tree_leaves(x0)[0]).device
        gen = torch.Generator(device=device).manual_seed(seed)
        delta = perturb * torch.randn((spec.dims,), generator=gen,
                                      dtype=spec.dtype, device=device)
        x_start = mf.retract(x0, delta, spec)
    else:
        x_start = x0
    x, out, taus = drive(x_start, clock=True)
    total = int(out.num_iters) if len(taus) == 0 else len(taus)
    out = dataclasses.replace(
        out, num_iters=torch.tensor(total, dtype=torch.int32),
        duration_ms=torch.tensor(taus.sum() * 1e3, dtype=torch.float32))
    return x, out, taus
