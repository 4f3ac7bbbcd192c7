"""Per-solver namespaces: ``lm.optimize``, ``gn.optimize``, ``dogleg.optimize``...

Counterpart of ``tinyopt_tpu._methods``, mirroring the reference namespace
products ``tinyopt::lm/gn/gd::Optimizer`` and the aliases ``nlls`` (= lm)
and ``unconstrained`` (= gd) (reference: include/tinyopt/optimizers/
{lm,gn,gd,nlls,unconstrained}.h); the first-order namespaces (``gd``,
``sgd``, ``adam``, ``adamw``, ``lbfgs``) run ``solvers/first_order.py``
in the same loop.
"""

from __future__ import annotations

import dataclasses
import types

from .optimize import optimize as _optimize
from .options import Options, SolverType


def _make(name: str, solver: SolverType) -> types.SimpleNamespace:
    def opt(x, fn, options: Options | None = None, **kw):
        options = options or Options()
        if options.solver_type != solver:
            options = dataclasses.replace(options, solver_type=solver)
        return _optimize(x, fn, options, **kw)

    def default_options(**kw) -> Options:
        return Options(solver_type=solver, **kw)

    return types.SimpleNamespace(
        optimize=opt, Optimize=opt, Options=default_options, name=name,
        solver_type=solver)


lm = _make("lm", SolverType.LEVENBERG_MARQUARDT)
gn = _make("gn", SolverType.GAUSS_NEWTON)
gd = _make("gd", SolverType.GRADIENT_DESCENT)
sgd = _make("sgd", SolverType.SGD)
adam = _make("adam", SolverType.ADAM)
adamw = _make("adamw", SolverType.ADAMW)
lbfgs = _make("lbfgs", SolverType.LBFGS)
# Powell dogleg trust region, beyond the reference (it skips Wood and
# Freudenstein-Roth "pending trust-region", tests/optimize_hard.cpp:289-295).
dogleg = _make("dogleg", SolverType.DOGLEG)
