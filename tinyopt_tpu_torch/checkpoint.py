"""Checkpoint / resume for long-running solves.

Counterpart of ``tinyopt_tpu.checkpoint``: the segmented execution of the
loop (the machinery of the ``max_duration_ms`` loop, both built on
``optimize._segment_pair``) as a public API, with ``torch.save`` /
``torch.load`` in place of orbax:

    solver = segment_solver(fn, options, x_example, iters_per_segment=10)
    x, out, st = solver.start(x0)           # first 10 iterations
    save_state(path, st)                    # ... process dies ...
    st = load_state(path, solver.abstract_state(x0))
    x, out, st = solver.resume(st)          # next 10, exact continuation

The segment state is the loop's complete carry (``optimizers.loop.Carry``:
λ schedule with compounded bad factors, accept / reject flags, failure
budgets, first-order optimizer state, Rebuild(false) flags), so N segments
of k iterations follow the trajectory of one N·k iteration solve bit for
bit.  ``SegmentSolver.run`` honors the ORIGINAL options (``max_iters`` + 1
rollback slot in total, the ``check_final_cost`` fallback) and sums
iteration counts and history over segments, as ``optimize`` reports them.

The port is batch-native: ``segment_solver(..., data_example=...)``
takes and returns a leading instance axis, with ``fn(x, data)`` one
instance's function and ``data_batch`` passed to each call; instances
that stop stay stopped in later segments.  Without data every call is a
batch of one (the JAX package's signatures); the state keeps its
instance axis either way.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from . import manifold as mf
from .optimize import (_RUNNING, _best_if_running, _history_cap,
                       _segment_pair, _SegmentHistory)
from .optimizers.loop import Carry, init_carry
from .options import Options
from .output import map_output


@dataclasses.dataclass
class SegmentSolver:
    """``start`` / ``resume`` running ``iters_per_segment`` iterations a
    call with full state continuity."""

    options: Options            #: the ORIGINAL options (total budgets)
    batched: bool
    _pair: Any                  #: optimize._SegmentPair at the full size
    _x_example: Any
    _data_example: Any
    _mode: str
    _fn: Callable
    _iters_per_segment: int = 10
    _tails: dict = dataclasses.field(default_factory=dict)

    def _in(self, x0):
        x0 = mf.as_pytree(x0)
        return x0 if self.batched else pytree.tree_map(lambda a: a[None], x0)

    def _out(self, x, out, st):
        if self.batched:
            return x, out, st
        return (pytree.tree_map(lambda a: a[0], x),
                map_output(lambda v: v[0], out), st)

    def start(self, x0, data_batch=None):
        """The first segment from ``x0``: ``(x, Output, state)``."""
        return self._out(*self._pair.start(self._in(x0), data_batch))

    def resume(self, state: Carry, data_batch=None):
        """The next segment from ``state``: ``(x, Output, state)``."""
        return self._out(*self._pair.resume(state, data_batch))

    def _sized(self, remaining: int):
        """The segment functions sized to ``remaining`` iterations (built
        once per distinct remainder)."""
        pair = self._tails.get(remaining)
        if pair is None:
            pair = _segment_pair(self._fn, self.options, self._mode,
                                 self._x_example, remaining,
                                 self._data_example)
            self._tails[remaining] = pair
        return pair

    def abstract_state(self, x_example=None) -> Carry:
        """The template :func:`load_state` restores into: the initial
        state for ``x_example`` (a batch when ``batched``; by default one
        instance, the solver's example), on its device and in its
        types."""
        xb = (pytree.tree_map(lambda a: a[None], self._x_example)
              if x_example is None else self._in(x_example))
        spec = self._pair.spec
        k = self._iters_per_segment
        return init_carry(mf.flatten_batch(xb, spec),
                          self.options.replace(max_iters=k), spec,
                          cap=k if self.options.save_history else 0,
                          dense_H=True)

    def run(self, x0, data_batch=None, *, max_segments: int | None = None,
            on_segment: Callable[[Carry], Carry] | None = None):
        """Drive segments until every instance has a terminal stop reason
        or the original options' budget is spent (``max_iters`` + 1
        rollback slot, + 1 with ``check_final_cost``).  Sums ``num_iters``
        and history over segments (rows of the budget's capacity, as an
        unsegmented solve's) and returns an instance still running its
        best accepted point.  ``on_segment(state) -> state`` runs after
        each segment and gives the state to continue from (e.g. one
        written to disk by :func:`save_state` and read back).  Returns
        ``(x, Output, state)``."""
        opts = self.options
        budget = opts.max_iters + 1 + (1 if opts.check_final_cost else 0)
        xb = self._in(x0)
        spec = self._pair.spec
        leaf = torch.as_tensor(pytree.tree_leaves(xb)[0])
        agg = _SegmentHistory(leaf.shape[0], budget, opts.save_history,
                              spec.dtype, leaf.device)
        st, out, n_seg = None, None, 0
        while True:
            remaining = budget - agg.total
            # every segment, the first included, sized to the budget left
            pair = (self._sized(remaining)
                    if remaining < self._iters_per_segment else self._pair)
            _, out, st = (pair.start(xb, data_batch) if st is None
                          else pair.resume(st, data_batch))
            agg.add(out)
            n_seg += 1
            if on_segment is not None:
                st = on_segment(st)
            if not any(int(s) in _RUNNING for s in out.stop_reason.tolist()):
                break
            if agg.total >= budget:
                break
            if max_segments is not None and n_seg >= max_segments:
                break
        x = mf.unflatten(_best_if_running(out, st), spec)
        return self._out(x, agg.finish(out), st)


@dataclasses.dataclass
class Stepper:
    """One loop iteration a call: the reference's ``Optimizer_::Step``
    (optimizer.h:332).  Each :meth:`step` runs exactly one iteration —
    build (or evaluate-only after a rejection), solve-retry with λ
    escalation, accept / reject / rollback, budgets and the stop cascade —
    and hands the complete state back.  N ``step`` calls follow the
    trajectory of one ``optimize`` with ``max_iters=N``.

        st = to.stepper(fn, options, x_example=x0)
        x, out, state = st.step(x0)          # iteration 0
        while int(out.stop_reason) in (int(to.StopReason.NONE),
                                       int(to.StopReason.MAX_ITERS)):
            x, out, state = st.step(state=state)
        x = st.best_x(state)                 # last ACCEPTED parameters

    ``out.stop_reason`` is ``MAX_ITERS`` while the one-iteration budget is
    all that stops the loop; the ``x`` returned mid-run carries the
    applied but not yet evaluated proposal, :meth:`best_x` the best
    evaluated point."""

    _seg: SegmentSolver

    def step(self, x0=None, state=None, data_batch=None):
        """Run one iteration: ``x0`` on the first call, ``state`` (from
        the previous call) afterwards.  Returns ``(x, Output, state)``."""
        if (x0 is None) == (state is None):
            raise ValueError("pass exactly one of x0 (first call) or "
                             "state (subsequent calls)")
        if state is None:
            return self._seg.start(x0, data_batch)
        return self._seg.resume(state, data_batch)

    def best_x(self, state: Carry):
        """The best accepted parameters in ``state`` (what ``optimize``
        returns: never an unevaluated trailing proposal)."""
        x = mf.unflatten(state.best_x, self._seg._pair.spec)
        return x if self._seg.batched else pytree.tree_map(
            lambda a: a[0], x)

    def evaluate(self, x, data_batch=None):
        """Normalized cost at ``x`` (the loop's evaluate-only branch)."""
        c = self._seg._pair.evaluate(self._seg._in(x), data_batch)
        return c if self._seg.batched else c[0]


def segment_solver(fn: Callable, options: Options | None = None,
                   x_example=None, *, mode: str = "auto",
                   iters_per_segment: int = 10,
                   data_example=None) -> SegmentSolver:
    """A resumable solver running ``iters_per_segment`` loop iterations a
    call (see the module docstring).  ``x_example`` is one instance."""
    options = options or Options()
    if x_example is None:
        raise ValueError("segment_solver requires x_example")
    x_example = mf.as_pytree(x_example)
    pair = _segment_pair(fn, options, mode, x_example, iters_per_segment,
                         data_example)
    return SegmentSolver(options=options,
                         batched=data_example is not None,
                         _pair=pair, _x_example=x_example,
                         _data_example=data_example, _mode=pair.mode,
                         _fn=fn, _iters_per_segment=iters_per_segment)


def stepper(fn: Callable, options: Options | None = None, x_example=None, *,
            mode: str = "auto", data_example=None) -> Stepper:
    """A :class:`Stepper`: the imperative single-``Step()`` API."""
    return Stepper(_seg=segment_solver(fn, options, x_example, mode=mode,
                                       iters_per_segment=1,
                                       data_example=data_example))


def save_state(path: str, state) -> None:
    """Write a segment state (or any pytree of tensors) to ``path`` with
    ``torch.save``: its leaves as a list of tensors, so a load runs no
    pickled code."""
    leaves = mf.tree_leaves_sorted(state)
    torch.save([None if l is None else l.detach() for l in leaves],
               os.path.abspath(path))


def load_state(path: str, abstract_state):
    """Read a state written by :func:`save_state` into the structure of
    ``abstract_state`` (from :meth:`SegmentSolver.abstract_state`): every
    tensor is placed on the template's device in the template's type, so
    a state saved on the card resumes on the card."""
    leaves, spec = mf.tree_flatten_sorted(abstract_state)
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if len(saved) != len(leaves):
        raise ValueError(f"{path}: {len(saved)} tensors, the template has "
                         f"{len(leaves)}")
    out = []
    for s, t in zip(saved, leaves):
        if (s is None) != (t is None):
            raise ValueError(f"{path}: does not match the template")
        out.append(None if t is None else s.to(device=t.device,
                                               dtype=t.dtype))
    return mf.tree_unflatten_sorted(out, spec)
