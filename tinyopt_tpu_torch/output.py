"""Optimization results (reference: include/tinyopt/output.h:26-147).

A dataclass of tensors.  Batched solves give every field a leading instance
axis; ``optimize`` (a batch of one) squeezes it away.  History arrays have
capacity ``max_iters + 1 (+1)`` with a valid-prefix counter ``num_hist``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from .cost import Cost
from .ops.linalg import cov_rescale, inv_cov
from .stop_reasons import StopReason, stop_reason_description


@dataclasses.dataclass
class Output:
    final_cost: Cost                   #: last accepted cost (+inf before)
    final_rerr_dec: torch.Tensor       #: last relative error decrease
    stop_reason: torch.Tensor          #: int32 StopReason code

    num_iters: torch.Tensor            #: int32
    num_failures: torch.Tensor         #: int32
    num_consec_failures: torch.Tensor  #: int32
    duration_ms: torch.Tensor          #: float32, host wall time of optimize()

    final_grad: torch.Tensor | None    #: last gradient (JᵀR), post-clipping
    #: last un-damped JᵀJ (if save_last): a dense tensor, a ``BlockDiag``
    #: or a ``SparseSym``
    final_hessian: Any

    errs: torch.Tensor                 #: (..., capacity) per-iteration cost
    deltas2: torch.Tensor              #: (..., capacity) per-iteration |δx|²
    successes: torch.Tensor            #: (..., capacity) bool accept flags
    num_hist: torch.Tensor             #: int32 valid prefix length

    #: last LM damping factor λ
    final_lambda: torch.Tensor | None = None
    num_diff_used: bool = False
    #: Whether requested log lines were dropped.  Always False here: the
    #: loop prints from the host, which drops no line (the JAX package sets
    #: it where its backend rejects host callbacks).
    log_dropped: bool = False

    def succeeded(self) -> torch.Tensor:
        """Stop reason is not a failure (>= kNone)."""
        return self.stop_reason >= int(StopReason.NONE)

    def converged(self) -> torch.Tensor:
        """Stop reason in [kMinError, kMaxIters)."""
        return (self.stop_reason >= int(StopReason.MIN_ERROR)) & (
            self.stop_reason < int(StopReason.MAX_ITERS))

    Succeeded = succeeded
    Converged = converged

    def covariance(self, rescaled: bool = False):
        """Covariance ≈ H⁻¹ of the final (un-damped) Hessian, batched over
        the instance axis: (..., n, n), dense also for a ``BlockDiag``
        (blockwise inverse) or a ``SparseSym`` (dense inverse with the
        diagonal-shift retry), as in the JAX package.

        With ``rescaled=True`` and an overdetermined system
        (num_residuals > dims), scales by ``final_cost² / (#res − dims)``
        as the reference does (output.h:80-93).  Returns None if no
        Hessian was saved; entries are NaN or Inf where H is singular."""
        H = self.final_hessian
        if H is None:
            return None
        d = H.shape[-1]
        cov = inv_cov(H) if isinstance(H, torch.Tensor) else \
            H.inv().to_dense()
        if rescaled:
            scale = cov_rescale(self.final_cost.cost,
                                self.final_cost.num_residuals, d)
            cov = cov * scale.to(cov.dtype)[..., None, None]
        return cov

    Covariance = covariance

    def stop_reason_description(self, options=None) -> str:
        return stop_reason_description(
            int(self.stop_reason), options, float(self.final_cost.cost))

    @property
    def errs_list(self):
        return [float(e) for e in self.errs[: int(self.num_hist)]]

    @property
    def deltas2_list(self):
        return [float(e) for e in self.deltas2[: int(self.num_hist)]]

    @property
    def successes_list(self):
        return [bool(e) for e in self.successes[: int(self.num_hist)]]

    def __repr__(self):
        if self.stop_reason.dim() == 0:
            reason = StopReason(int(self.stop_reason)).name
            return (f"Output(stop={reason}, "
                    f"cost={float(self.final_cost.cost):.6e}, "
                    f"iters={int(self.num_iters)}, "
                    f"fails={int(self.num_failures)})")
        return (f"Output(batch={self.stop_reason.shape[0]}, "
                f"stop_reason={self.stop_reason!r})")


def map_output(fn, out: Output) -> Output:
    """Apply ``fn`` to every tensor field of ``out`` (e.g. squeeze a batch
    of one)."""
    def f(v):
        if isinstance(v, torch.Tensor):
            return fn(v)
        if dataclasses.is_dataclass(v):     # a BlockDiag or SparseSym
            return pytree.tree_map(fn, v)
        return v
    cost = Cost(*(f(getattr(out.final_cost, k.name))
                  for k in dataclasses.fields(Cost)))
    kw = {k.name: f(getattr(out, k.name)) for k in dataclasses.fields(Output)
          if k.name != "final_cost"}
    return Output(final_cost=cost, **kw)
