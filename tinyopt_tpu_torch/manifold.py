"""Parameters as pytrees of tensors, with a manifold (retraction) registry.

Counterpart of ``tinyopt_tpu.manifold``.  Any pytree of tensors is a valid
parameter block: tensors are Euclidean leaves (tangent dimension = size,
retraction = addition); types registered here with a :class:`Manifold`
(``manifolds.SO3``, ``SE3``, ``SE23``, ``SEn3``) are atomic leaves whose tangent
dimension differs from their count of stored values.  The tangent vector
concatenates the leaf tangents in pytree order, JAX's order: a dict's
leaves by sorted key (:func:`tree_flatten_sorted`), whatever order the
caller inserted them in.

The optimizer loop and the fused path keep parameters FLAT, as a (B, P)
tensor of stored values (every tensor of the pytree flattened, in pytree
order: 7 a pose for SE3, quaternion then translation), and steps and
gradients as (B, D) tangent vectors (6 a pose).  :func:`retract_flat`
maps the two: ``x + δ`` when every leaf is Euclidean (P = D), the
registered retraction of each manifold leaf otherwise.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree


class Manifold(NamedTuple):
    """Retraction + tangent-dimension spec for one registered type.

    dims(x) -> int                   static tangent dimension of the leaf
    retract(x, delta) -> x'          x ⊞ delta, delta of shape (..., dims)
    local(x, y) -> delta (optional)  y ⊟ x
    """

    dims: Callable[[Any], int]
    retract: Callable[[Any, torch.Tensor], Any]
    local: Callable[[Any, Any], torch.Tensor] | None = None


_REGISTRY: dict[type, Manifold] = {}


def register_manifold(cls: type, manifold: Manifold) -> None:
    """Register a manifold implementation for a (pytree-registered) type."""
    _REGISTRY[cls] = manifold


def manifold_for(x) -> Manifold | None:
    return _REGISTRY.get(type(x))


def _is_manifold_leaf(x) -> bool:
    return type(x) in _REGISTRY


def _leaf_dims(leaf) -> int:
    m = manifold_for(leaf)
    if m is not None:
        return int(m.dims(leaf))
    return int(torch.as_tensor(leaf).numel())


class SortedTreeDef(NamedTuple):
    """A pytree's structure as torch flattens it (every dict in its
    insertion order), and the order JAX flattens it in (every dict's keys
    sorted): leaf ``k`` in JAX's order is torch's leaf ``order[k]``."""
    treedef: Any
    order: tuple

    def structure(self):
        """The structure in JAX's terms: every dict's keys sorted, so two
        pytrees whose dicts hold the same keys in another insertion order
        compare equal, as their JAX treedefs do."""
        return _sorted_structure(self.treedef)


def _children(spec) -> list:
    return list(spec.children()) if hasattr(spec, "children") \
        else list(spec.children_specs)


def _dict_keys(spec):
    """The keys of a dict or defaultdict node in insertion order, else
    None."""
    if spec.type is dict:
        return spec.context
    if spec.type is defaultdict:
        return spec.context[1]
    return None


def _sorted_structure(spec):
    if spec.is_leaf():
        return None
    kids = _children(spec)
    keys = _dict_keys(spec)
    if keys is None:
        return (spec.type, spec.context,
                tuple(_sorted_structure(k) for k in kids))
    idx = sorted(range(len(kids)), key=lambda i: keys[i])
    factory = spec.context[0] if spec.type is defaultdict else None
    return (spec.type, factory, tuple(keys[i] for i in idx),
            tuple(_sorted_structure(kids[i]) for i in idx))


def _jax_order(spec, start: int) -> list:
    """Torch's leaf positions of ``spec`` in JAX's order, from ``start``."""
    if spec.is_leaf():
        return [start]
    kids = _children(spec)
    offsets = np.cumsum([start] + [k.num_leaves for k in kids]).tolist()
    idx = range(len(kids))
    keys = _dict_keys(spec)
    if keys is not None:
        idx = sorted(idx, key=lambda i: keys[i])
    return [p for i in idx for p in _jax_order(kids[i], offsets[i])]


def tree_flatten_sorted(x, is_leaf=None):
    """Flatten ``x`` as JAX's ``tree_flatten`` does: every dict (and
    defaultdict) by its sorted keys, where torch keeps insertion order.
    Every flat layout of the port (parameters, tangents, steps, gradients,
    covariances) follows it, so it is the JAX package's layout.  Returns
    the leaves and a :class:`SortedTreeDef`, from which
    :func:`tree_unflatten_sorted` rebuilds the caller's structure, keys in
    the caller's order."""
    leaves, treedef = pytree.tree_flatten(x, is_leaf=is_leaf)
    order = tuple(_jax_order(treedef, 0))
    return [leaves[i] for i in order], SortedTreeDef(treedef, order)


def tree_leaves_sorted(x, is_leaf=None) -> list:
    """The leaves of ``x`` in JAX's order (:func:`tree_flatten_sorted`)."""
    return tree_flatten_sorted(x, is_leaf)[0]


def tree_unflatten_sorted(leaves, sdef: SortedTreeDef):
    """Inverse of :func:`tree_flatten_sorted`."""
    out = [None] * len(sdef.order)
    for k, i in enumerate(sdef.order):
        out[i] = leaves[k]
    return pytree.tree_unflatten(out, sdef.treedef)


def _leaves(x):
    return tree_flatten_sorted(x, is_leaf=_is_manifold_leaf)


class Block(NamedTuple):
    """One manifold-level leaf of a parameter pytree in the flat layouts."""
    manifold: Manifold | None   # None: a Euclidean tensor
    treedef: Any                # the leaf's own tensor-level SortedTreeDef
    shapes: tuple               # shapes of its tensors (one instance)
    p_offset: int               # offset of its stored values in the (P,) vector
    p_size: int
    t_offset: int               # offset of its tangent in the (D,) vector
    t_dims: int


class TangentSpec(NamedTuple):
    """Static description of ONE instance's parameter pytree: the flat
    parameter vector (``params`` = P stored values, per tensor ``shapes``)
    and its tangent (``dims`` = D; per manifold-level leaf ``leaf_dims``
    and ``offsets``, as the JAX package's ``TangentSpec``)."""

    treedef: Any              # tensor-level SortedTreeDef (rebuilds x)
    shapes: tuple             # per-tensor shape
    params: int               # P: stored values
    leaf_dims: tuple          # per manifold-level leaf tangent dimension
    offsets: tuple            # per manifold-level leaf tangent offset
    dims: int                 # D: tangent dimension
    dtype: torch.dtype        # promoted floating dtype over leaves
    blocks: tuple             # per manifold-level leaf: a Block
    has_manifold: bool


def tangent_spec(x) -> TangentSpec:
    """The (static) parameter and tangent layout of ONE instance's pytree."""
    mleaves, _ = _leaves(x)
    tensors, treedef = tree_flatten_sorted(x)
    tensors = [torch.as_tensor(t) for t in tensors]
    shapes = tuple(tuple(t.shape) for t in tensors)
    sizes = tuple(math.prod(s) for s in shapes)
    blocks, leaf_dims, offsets, dtypes = [], [], [], []
    i = p_off = t_off = 0
    for leaf in mleaves:
        sub, sub_def = tree_flatten_sorted(leaf)
        n = len(sub)
        p_size = sum(sizes[i:i + n])
        td = _leaf_dims(leaf)
        m = manifold_for(leaf)
        blocks.append(Block(m, sub_def, shapes[i:i + n], p_off, p_size,
                            t_off, td))
        leaf_dims.append(td)
        offsets.append(t_off)
        subs = [t.dtype for t in tensors[i:i + n]]
        if m is not None:
            # only a manifold leaf's floating storage defines the dtype
            subs = [dt for dt in subs if dt.is_floating_point] or subs
        dtypes.extend(subs)
        i, p_off, t_off = i + n, p_off + p_size, t_off + td
    dtype = dtypes[0] if dtypes else torch.get_default_dtype()
    for dt in dtypes[1:]:
        dtype = torch.promote_types(dtype, dt)
    dims = int(t_off)
    if dims > 0 and not dtype.is_floating_point:
        raise ValueError(
            f"parameters must be floating point, got dtype {dtype}; cast "
            "your initial values (e.g. torch.as_tensor(x, dtype="
            "torch.float32))")
    return TangentSpec(treedef, shapes, int(p_off),
                       tuple(leaf_dims), tuple(offsets), dims, dtype,
                       tuple(blocks), any(b.manifold for b in blocks))


def flatten_batch(xb, spec: TangentSpec) -> torch.Tensor:
    """Batched pytree (leading instance axis on every tensor) -> (B, P)."""
    leaves = tree_leaves_sorted(xb)
    cols = [torch.reshape(l, (l.shape[0], -1)).to(spec.dtype) for l in leaves]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)


def _unflatten(v, treedef, shapes):
    lead = tuple(v.shape[:-1])
    leaves, o = [], 0
    for s in shapes:
        n = math.prod(s)
        leaves.append(torch.reshape(v[..., o:o + n], lead + s))
        o += n
    return tree_unflatten_sorted(leaves, treedef)


def unflatten(v: torch.Tensor, spec: TangentSpec):
    """Flat (..., P) -> pytree whose tensors have shape (..., *shape)."""
    return _unflatten(v, spec.treedef, spec.shapes)


def retract_flat(x: torch.Tensor, delta: torch.Tensor,
                 spec: TangentSpec) -> torch.Tensor:
    """``x ⊞ δ`` on flat parameters: x (..., P), δ (..., D) -> (..., P).

    Euclidean leaves add; each manifold leaf is rebuilt from its slice of
    ``x`` and retracted by its registered map (the JAX package's
    ``mf.retract``, and the fused kernel's ``ret_flat``)."""
    if not spec.has_manifold:
        return x + delta
    lead = tuple(x.shape[:-1])
    parts = []
    for blk in spec.blocks:
        xs = x[..., blk.p_offset:blk.p_offset + blk.p_size]
        ds = delta[..., blk.t_offset:blk.t_offset + blk.t_dims]
        if blk.manifold is None:
            parts.append(xs + ds)
            continue
        new = blk.manifold.retract(_unflatten(xs, blk.treedef, blk.shapes),
                                   ds.to(xs.dtype))
        parts.extend(torch.reshape(a, lead + (-1,))
                     for a in tree_leaves_sorted(new))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def local_flat(x: torch.Tensor, y: torch.Tensor,
               spec: TangentSpec) -> torch.Tensor:
    """``y ⊟ x`` on flat parameters: x, y (..., P) -> δ (..., D), the
    inverse of :func:`retract_flat` (``y − x`` when every leaf is
    Euclidean)."""
    if not spec.has_manifold:
        return y - x
    parts = []
    for blk in spec.blocks:
        xs = x[..., blk.p_offset:blk.p_offset + blk.p_size]
        ys = y[..., blk.p_offset:blk.p_offset + blk.p_size]
        if blk.manifold is None:
            parts.append(ys - xs)
            continue
        if blk.manifold.local is None:
            raise NotImplementedError("a registered manifold without a "
                                      "local() map")
        parts.append(blk.manifold.local(
            _unflatten(xs, blk.treedef, blk.shapes),
            _unflatten(ys, blk.treedef, blk.shapes)).to(x.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def retract(x, delta: torch.Tensor, spec: TangentSpec | None = None):
    """Manifold retraction ``x ⊞ delta`` over a full parameter pytree;
    ``delta`` is the flat tangent vector (D,)."""
    if spec is None:
        spec = tangent_spec(x)
    leaves, treedef = _leaves(x)
    new_leaves = []
    for leaf, d, off in zip(leaves, spec.leaf_dims, spec.offsets):
        sl = delta[off:off + d]
        m = manifold_for(leaf)
        if m is not None:
            new_leaves.append(m.retract(leaf, sl))
        else:
            arr = torch.as_tensor(leaf)
            new_leaves.append(arr + sl.reshape(arr.shape).to(arr.dtype))
    return tree_unflatten_sorted(new_leaves, treedef)


def local(x, y, spec: TangentSpec | None = None) -> torch.Tensor:
    """Inverse retraction ``y ⊟ x`` as a flat tangent vector."""
    if spec is None:
        spec = tangent_spec(x)
    xl, xdef = _leaves(x)
    yl, ydef = _leaves(y)
    if xdef.structure() != ydef.structure():
        raise ValueError(
            f"local(x, y): mismatched pytree structures {xdef} vs {ydef}")
    parts = []
    for lx, ly in zip(xl, yl):
        m = manifold_for(lx)
        if m is not None:
            if m.local is None:
                raise NotImplementedError(
                    f"Manifold for {type(lx).__name__} has no local() map")
            parts.append(torch.reshape(m.local(lx, ly), (-1,)))
        else:
            parts.append(torch.reshape(torch.as_tensor(ly)
                                       - torch.as_tensor(lx), (-1,)))
    if not parts:
        return torch.zeros((0,), dtype=spec.dtype)
    return torch.cat([p.to(spec.dtype) for p in parts])


def zero_tangent(x, spec: TangentSpec | None = None) -> torch.Tensor:
    if spec is None:
        spec = tangent_spec(x)
    device = None
    tensors = pytree.tree_leaves(x)
    if tensors:
        device = torch.as_tensor(tensors[0]).device
    return torch.zeros((spec.dims,), dtype=spec.dtype, device=device)


def as_pytree(x):
    """Canonicalize user input: Python scalars/lists -> tensors, manifold
    leaves kept as they are.

    Python ints are promoted to floats (an integer starting point is meant
    as a real-valued parameter)."""
    def conv(v):
        if _is_manifold_leaf(v) or isinstance(v, torch.Tensor):
            return v
        if isinstance(v, int) and not isinstance(v, bool):
            v = float(v)
        return torch.as_tensor(v)
    return pytree.tree_map(conv, x, is_leaf=_is_manifold_leaf)


def element_perm(x_batched, n: int) -> np.ndarray | None:
    """Index map from the ELEMENT-MAJOR flat tangent of a leading-axis
    batched pytree (element 0's full tangent, then element 1's, …) to the
    global leaf-major layout of ``tangent_spec(x_batched)``.

    Returns ``em2gl`` with ``t_global = t_elem_major[em2gl]``, or ``None``
    when the two layouts coincide (a single-leaf pytree: a batched SE3, a
    plain (n, d) tensor).  The bipartite (Schur) systems do their algebra
    element-major, each camera's tangent block contiguous, while the loop
    retracts in the leaf-major layout; a multi-leaf element such as
    ``{"f": (n, 1), "pose": SE3}`` needs this permutation at their
    boundary (``tinyopt_tpu.manifold.element_perm``)."""
    leaves, _ = _leaves(x_batched)
    if len(leaves) <= 1:
        return None
    d_tot = [_leaf_dims(l) for l in leaves]
    d_el = [d // n for d in d_tot]
    if any(d != de * n for d, de in zip(d_tot, d_el)):
        raise ValueError(
            f"batched pytree leaf tangent dims {d_tot} not divisible by "
            f"the batch size {n}")
    da = sum(d_el)
    goff = np.cumsum([0] + [n * de for de in d_el])[:-1]
    eoff = np.cumsum([0] + d_el[:-1])
    em2gl = np.empty(n * da, np.int64)
    i = np.arange(n)[:, None]
    for l, de in enumerate(d_el):
        c = np.arange(de)[None, :]
        em2gl[(goff[l] + i * de + c).reshape(-1)] = \
            (i * da + eoff[l] + c).reshape(-1)
    return em2gl


def flatten_values(x) -> torch.Tensor:
    """Flatten the *values* (not tangents) of a pytree into one vector."""
    arrs = [torch.reshape(torch.as_tensor(a), (-1,))
            for a in tree_leaves_sorted(x)]
    if not arrs:
        return torch.zeros((0,))
    return torch.cat(arrs)
