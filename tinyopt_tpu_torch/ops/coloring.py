"""Curtis–Powell–Reid column coloring for matrix-free diag(JᵀJ).

Counterpart of ``tinyopt_tpu.ops.coloring`` (``probe_structure`` and
``detect_diag_coloring``), with the Jacobian probed by
``torch.func.jacfwd``.  The probe points come from the same numpy
generators (seeds 12345 + k) as the JAX package's, so both packages find
the same structure, colors, probes and recovery on the same example.

The fused path (ops/cuda_solver.py) uses the result to choose how it gets
diag(H): the identity structure needs one jvp of the all-ones probe and
makes the damped step closed form; no coloring means one jvp per tangent
dimension.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..diff.auto import instance_residuals


@dataclasses.dataclass(frozen=True)
class DiagColoring:
    """Static coloring data (see ``tinyopt_tpu.ops.coloring.DiagColoring``)."""
    probes: np.ndarray      # (C, d): probe tangent per color
    recovery: np.ndarray    # (C * n_res, d): one-hot diag recovery
    n_colors: int
    #: J is exactly diagonal with row i <-> dim i.
    identity: bool = False


def _greedy_color(structure: np.ndarray) -> np.ndarray:
    """Greedy distance-1 coloring of columns under row-support conflicts,
    largest support first."""
    n, d = structure.shape
    # a float product (BLAS) of nonnegative counts: > 0 exactly where the
    # integer one is
    s = structure.astype(np.float64)
    conflict = (s.T @ s) > 0
    order = np.argsort(-structure.sum(axis=0), kind="stable")
    colors = np.full(d, -1, dtype=np.int64)
    for j in order:
        used = set(colors[k] for k in np.nonzero(conflict[j])[0]
                   if colors[k] >= 0 and k != j)
        c = 0
        while c in used:
            c += 1
        colors[j] = c
    return colors


def probe_structure(residual_fn, x_example, data_example, spec,
                    n_res: int, dims: int, *, n_probes: int = 3
                    ) -> np.ndarray | None:
    """The (n_res, dims) tangent-Jacobian nonzero STRUCTURE of one
    instance (of δ ↦ r(x ⊞ δ), through the retraction), OR-ed over a few
    deterministic pseudo-random points, or ``None`` when the Jacobian is
    non-finite or cannot be traced."""
    x_example = pytree.tree_map(lambda a: torch.as_tensor(a).detach().cpu(),
                                x_example)
    if data_example is not None:
        data_example = pytree.tree_map(
            lambda a: torch.as_tensor(a).detach().cpu(), data_example)
    xv = mf.flatten_batch(pytree.tree_map(lambda a: a[None], x_example),
                          spec)[0]
    has_data = data_example is not None
    r1 = instance_residuals(residual_fn, spec, has_data)

    def perturb(a, rng):
        if not a.is_floating_point():
            return a
        shape = tuple(a.shape)
        noise = (rng.uniform(0.25, 1.0, shape)
                 * np.where(rng.uniform(size=shape) < 0.5, -1.0, 1.0))
        return a + torch.as_tensor(noise, dtype=a.dtype)

    structure = np.zeros((n_res, dims), dtype=bool)
    for k in range(n_probes):
        rng = np.random.default_rng(12345 + k)
        if k == 0:
            xk, data_k = xv, data_example
        else:
            delta = rng.uniform(-0.5, 0.5, (dims,))
            xk = mf.retract_flat(xv, torch.as_tensor(delta, dtype=spec.dtype),
                                 spec)
            data_k = (None if data_example is None else
                      pytree.tree_map(lambda a: perturb(a, rng), data_example))
        extra = (data_k,) if has_data else ()
        try:
            J = torch.func.jacfwd(
                lambda dd: r1(mf.retract_flat(xk, dd, spec), *extra))(
                    torch.zeros((dims,), dtype=xk.dtype))
        except (RuntimeError, TypeError, ValueError, NotImplementedError):
            return None     # untraceable residual: no coloring
        J = J.detach().numpy()
        if not np.all(np.isfinite(J)):
            return None
        structure |= J.reshape(n_res, dims) != 0
    return structure


def detect_diag_coloring(residual_fn, x_example, data_example, spec,
                         n_res: int, dims: int, dtype,
                         *, n_probes: int = 3,
                         max_recovery_bytes: int = 4 * 1024 * 1024
                         ) -> DiagColoring | None:
    """Probe the tangent Jacobian structure and color it, or ``None`` when
    detection fails, the structure needs ≥ max(1, d/2) colors, or the
    recovery table would exceed ``max_recovery_bytes``."""
    structure = probe_structure(residual_fn, x_example, data_example, spec,
                                n_res, dims, n_probes=n_probes)
    if structure is None:
        return None
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    colors = _greedy_color(structure)
    n_colors = int(colors.max()) + 1 if dims else 1
    if n_colors > max(1, dims // 2):
        return None
    if n_colors * n_res * dims * np_dtype.itemsize > max_recovery_bytes:
        return None

    probes = np.zeros((n_colors, dims), dtype=np_dtype)
    recovery = np.zeros((n_colors, n_res, dims), dtype=np_dtype)
    for j in range(dims):
        c = int(colors[j])
        probes[c, j] = 1.0
        recovery[c, :, j] = structure[:, j]
    identity = bool(
        n_colors == 1 and n_res >= dims
        and np.array_equal(structure[:dims], np.eye(dims, dtype=bool))
        and not structure[dims:].any())
    return DiagColoring(probes=probes,
                        recovery=recovery.reshape(n_colors * n_res, dims),
                        n_colors=n_colors, identity=identity)
