"""Parameters as a tensor or a dict/tuple of tensors — Euclidean case.

Counterpart of ``tinyopt_tpu.manifold`` for Euclidean leaves: the tangent
space of a parameter pytree is the concatenation of its flattened leaves
(pytree order), and the retraction is ``x + δ``.  Internally the optimizer
loop and the fused path keep parameters FLAT, as a (B, d) tensor with a
leading instance axis, and unflatten only to call the user's residual
function and to return the result.  Registered manifold types (SO3/SE3/…)
are not ported yet (ROADMAP, slice B).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree


class TangentSpec(NamedTuple):
    """Static description of one instance's parameter pytree."""

    treedef: Any
    shapes: tuple             # per-leaf shape (one instance)
    sizes: tuple              # per-leaf number of scalars
    offsets: tuple            # per-leaf offset into the flat vector
    dims: int                 # total tangent dimension
    dtype: torch.dtype        # promoted floating dtype over leaves


def as_pytree(x):
    """Canonicalize user input: Python scalars/lists -> tensors.

    Python ints are promoted to floats (an integer starting point is meant
    as a real-valued parameter)."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, int) and not isinstance(v, bool):
            v = float(v)
        return torch.as_tensor(v)
    return pytree.tree_map(conv, x)


def tangent_spec(x) -> TangentSpec:
    """The (static) tangent layout of ONE instance's parameter pytree."""
    leaves, treedef = pytree.tree_flatten(x)
    shapes = tuple(tuple(torch.as_tensor(l).shape) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    dtype = torch.get_default_dtype()
    if leaves:
        dtype = torch.as_tensor(leaves[0]).dtype
        for l in leaves[1:]:
            dtype = torch.promote_types(dtype, torch.as_tensor(l).dtype)
    dims = int(sum(sizes))
    if dims > 0 and not dtype.is_floating_point:
        raise ValueError(
            f"parameters must be floating point, got dtype {dtype}; cast "
            "your initial values (e.g. torch.as_tensor(x, dtype="
            "torch.float32))")
    return TangentSpec(treedef, shapes, sizes, offsets, dims, dtype)


def flatten_batch(xb, spec: TangentSpec) -> torch.Tensor:
    """Batched pytree (leading instance axis on every leaf) -> (B, d)."""
    leaves = pytree.tree_leaves(xb)
    cols = [torch.reshape(l, (l.shape[0], -1)).to(spec.dtype) for l in leaves]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)


def unflatten(v: torch.Tensor, spec: TangentSpec):
    """Flat (..., d) -> pytree whose leaves have shape (..., *leaf_shape)."""
    lead = tuple(v.shape[:-1])
    leaves = [torch.reshape(v[..., o:o + n], lead + s)
              for s, n, o in zip(spec.shapes, spec.sizes, spec.offsets)]
    return pytree.tree_unflatten(leaves, spec.treedef)


def retract(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Euclidean retraction ``x ⊞ δ`` on flat parameters."""
    return x + delta
