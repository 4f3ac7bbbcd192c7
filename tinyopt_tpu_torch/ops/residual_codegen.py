"""Residual families generated from the traced residual: K2 for any
residual inside the generated envelope.

Counterpart of what ``tinyopt_tpu/ops/pallas_solver.py`` traces into its
kernel (``_x_layout``, ``res_flat``, ``linearize_at``): there the user's
residual is traced into ``_solver_kernel``; here it is traced with
``make_fx`` and emitted as C++ into one of K2's kernels through the
``GeneratedFamily`` of ``csrc/solver.cuh``.  :func:`generated_family`
traces one instance, on the example's own device (where the residual's
closed-over tensors live) at its static shapes, four functions: the
residual r(x, data), ``torch.func.jvp`` / ``torch.func.vjp`` of δ ↦ r(x ⊞
δ, data) at δ = 0 (the twin's linearization,
``cuda_solver.fused_solve_plain``), and the retraction x ⊞ δ, so the
emitter differentiates nothing itself.  Each graph becomes a C++ function
templated on the scalar type T, in one of two forms:

* the register form, up to max(P, D, n_res) = ``SEG_MAX`` (K2's register
  kernel, one instance a thread, ``csrc/solver_seg.cuh``): straight-line
  code, host-and-device, every value a flat array of its static shape,
  elementwise ops and reductions loops over static extents (fully unrolled
  on the card, so the arrays live in registers);
* the warp form, past it (K2's warp kernel, one instance a warp,
  ``csrc/solver_warp.cuh``): device code for the 32 lanes of a warp, each
  op one loop over its output entries, entry e on lane e % 32, then a
  ``__syncwarp`` (so an op may read any lane's entries of the ops before
  it), every array in a per-warp scratch of shared memory whose room
  arrays reuse once no later op reads them; the host build runs the lanes
  one after another (the tests).  The retraction keeps the register form:
  every lane retracts the whole x.

In both, the views (``view``, ``expand``, ``select``, ``slice``,
``transpose``...) are index maps over another value's array with no copy,
a sum adds in the order torch's CUDA sum adds the twin's tensor (the
twin's bits) at the twin's batch — one source for a batch of ``BATCH`` or
more, another below it where an order differs (:meth:`GeneratedFamily.
at_batch`) —, and every value that depends on no input — a closed-over
tensor, ``arange``, ``zeros_like``, an op on such values — is folded to a
literal, up to ``MAX_CONST`` entries.

The envelope: parameters of tensors and registered manifold leaves of one
dtype, float32 or float64, per-instance data leaves of the same dtype
(packed into one row of Q values an instance) or none, only the ops of
``OP_TABLE``, and past ``SEG_MAX`` a warp state and scratch that fit a
block's shared memory.  Anything else — mixed dtypes, an op outside the
table, a trace that fails — is refused with its reason, once, when the
fused path is planned; the loop then runs.  No code generator but this
module's own is used.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import operator
import re
from typing import Any

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..diff.auto import instance_residuals

#: The batch from which torch's CUDA sums add the twin's tensors in one
#: geometry whatever the batch (:func:`_row_split`, :func:`_outer_split`):
#: a family's source for a batch of ``BATCH`` serves every batch from it.
BATCH = 32

#: Largest max(P, D, n_res) of a generated family's register form (K2's
#: register kernel, one instance a thread); past it the warp form (K2's
#: warp kernel, one instance a warp).
SEG_MAX = 64
#: Largest constant (closed-over tensor, or a value that depends on no
#: input) emitted as a literal array; a larger one is refused.
MAX_CONST = 256

#: Elementwise ops of one input: aten name -> C expression of ``a``.
_UNARY = {
    "neg": "(-{a})", "exp": "exp({a})", "log": "log({a})",
    "sqrt": "sqrt({a})", "rsqrt": "({one} / sqrt({a}))", "abs": "fabs({a})",
    "sin": "sin({a})", "cos": "cos({a})", "tanh": "tanh({a})",
    "reciprocal": "({one} / {a})", "sign": "k2g_sign({a})",
    "sgn": "k2g_sign({a})",
}
#: Elementwise ops of two inputs: aten name -> C expression.
_BINARY = {
    "add": "({a} + {b})", "sub": "({a} - {b})", "mul": "({a} * {b})",
    "div": "({a} / {b})",
    "tanh_backward": "k2g_tanh_backward({a}, {b})",
    "atan2": "atan2({a}, {b})",
}
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
            "ne": "!="}
#: Logical ops on masks (clamp's derivative ands two).
_LOGICAL = {"logical_and": "({a} && {b})", "logical_or": "({a} || {b})",
            "logical_not": "(!{a})"}
#: Ops that only look at another value: the same array under an index map.
_VIEWS = ("view", "_unsafe_view", "reshape", "expand", "unsqueeze",
          "squeeze", "select", "slice", "transpose", "t", "permute",
          "alias", "detach", "clone", "lift_fresh_copy", "contiguous",
          "_to_copy", "unbind", "split", "split_with_sizes")
#: Ops whose value depends on their inputs' shapes alone: folded to
#: literals.
_SHAPE_ONLY = ("zeros_like", "ones_like", "full_like", "new_zeros",
               "new_ones", "new_full", "_efficientzerotensor", "zeros",
               "ones", "full", "scalar_tensor", "arange")
#: The elementwise ops (one output element from the inputs' elements at
#: its index).
_ELEMENTWISE = tuple(list(_UNARY) + list(_BINARY) + list(_COMPARE)
                     + list(_LOGICAL) + ["rsub", "pow", "where",
                                         "masked_fill", "clamp", "clamp_min",
                                         "clamp_max"])


def _core(shape) -> tuple:
    """A shape without its size-1 dims: two shapes with the same core list
    the same elements in the same order."""
    return tuple(int(n) for n in shape if n != 1)
#: Every op a generated family may hold (aten names).
OP_TABLE = frozenset(
    list(_UNARY) + list(_BINARY) + list(_COMPARE) + list(_LOGICAL)
    + list(_VIEWS)
    + list(_SHAPE_ONLY)
    + ["rsub", "pow", "where", "masked_fill", "clamp", "clamp_min",
       "clamp_max", "cat", "stack",
       "select_backward", "slice_backward", "sum", "mean", "dot", "mv",
       "mm", "bmm"])


class Refused(Exception):
    """A residual outside the generated envelope; the message is why."""


@dataclasses.dataclass(frozen=True, eq=False)
class GeneratedFamily:
    """A residual family generated from a traced residual: what K2's
    ``kGenerated`` family is built from.

    ``p``, ``d`` and ``n_res``: the widths of the flat parameters, of the
    tangent and of the residual (the family's ``kP``, ``kD`` and
    ``kNRes``; ``p`` = ``d`` on Euclidean parameters); ``data_treedef`` / ``data_shapes``: the layout
    of one instance's data leaves, packed row-major one after the other
    into one row of ``q`` values (``q`` = 0 without data); ``dtype``: the
    traced type; ``source``: the emitted C++ header; ``hash``: 16 hex
    digits of its SHA-256; ``ops``: the arithmetic operations of one
    instance's residual, jvp, vjp and retraction (a multiply, an add, an
    exponential or a comparison count one each); ``warp``: whether the
    header holds the warp form (one instance a warp, for K2's warp kernel;
    emitted past ``SEG_MAX``), whose arrays take ``scratch`` values of the
    traced type a warp; ``batch``: the twin's batch whose sum orders the
    source copies (``BATCH`` stands for ``BATCH`` or more;
    :meth:`at_batch`).  Compared and hashed by identity: a solver keeps
    the one its plan traced."""
    p: int
    d: int
    n_res: int
    data_treedef: Any
    data_shapes: tuple
    q: int
    dtype: torch.dtype
    source: str
    hash: str
    ops: dict
    warp: bool = False
    scratch: int = 0
    batch: int = BATCH
    #: batch -> the family's source at that batch (:meth:`at_batch`)
    _emit: Any = dataclasses.field(default=None, repr=False)
    _at: dict = dataclasses.field(default_factory=dict, repr=False)

    def at_batch(self, B: int) -> "GeneratedFamily":
        """The family whose sums add as torch's add the twin's tensors at a
        batch of ``B``: this one from ``BATCH`` on; below it the source
        emitted anew at ``B`` (kept for the family), or this one where no
        order differs at ``B`` (the same source)."""
        b = min(max(int(B), 1), BATCH)
        if b == self.batch or self._emit is None:
            return self
        if b not in self._at:
            fam = self._emit(b)
            self._at[b] = self if fam.source == self.source else fam
        return self._at[b]

    def pack_data(self, data, B: int, dtype, dev) -> torch.Tensor | None:
        """The batch's data leaves as one contiguous (B, q) tensor of the
        solver's type on ``dev`` (``None`` without data); raises on a
        layout other than the traced one."""
        if self.q == 0:
            if data is not None:
                raise ValueError("generated K2 family: traced without data,"
                                 " called with data")
            return None
        leaves, tdef = pytree.tree_flatten(data)
        if tdef != self.data_treedef or len(leaves) != len(self.data_shapes):
            raise ValueError("generated K2 family: the data's structure is "
                             "not the traced one")
        rows = []
        for leaf, shape in zip(leaves, self.data_shapes):
            if (not isinstance(leaf, torch.Tensor)
                    or tuple(leaf.shape) != (B,) + shape
                    or leaf.device != dev or leaf.dtype != dtype):
                raise ValueError(
                    f"generated K2 family: a data leaf must be {(B,) + shape}"
                    f" {dtype} on {dev}; got "
                    f"{getattr(leaf, 'shape', None)} "
                    f"{getattr(leaf, 'dtype', None)} on "
                    f"{getattr(leaf, 'device', None)}")
            rows.append(leaf.reshape(B, -1))
        packed = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
        return packed.contiguous()


def _shape(node) -> tuple:
    return _shape_of(node.meta["val"])


def _shape_of(t) -> tuple:
    return tuple(int(s) for s in t.shape)


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


@dataclasses.dataclass(frozen=True)
class _Val:
    """A value of the graph: ``shape`` and ``dtype``, and either an array
    ``name`` read at ``offset`` + Σ ``strides``·index, or (``name`` None) a
    uniform literal ``lit``."""
    shape: tuple
    dtype: torch.dtype
    name: str | None = None
    strides: tuple = ()
    offset: int = 0
    lit: str | None = None
    conv: str | None = None     # a C type the element is cast to
    #: a fusion group's scalar (``_Emitter.elementwise``): its C expression
    #: at the group's index
    expr: Any = dataclasses.field(default=None, compare=False)

    def at(self, idx) -> str:
        """C expression of the element at the multi-index ``idx`` (ints or
        C index expressions, one a dim)."""
        e = self.element(idx)
        return e if self.conv is None else f"static_cast<{self.conv}>({e})"

    def element(self, idx) -> str:
        if self.expr is not None:
            return self.expr(idx)
        if self.name is None:
            return self.lit
        const, terms = self.offset, []
        for s, i in zip(self.strides, idx):
            if s == 0:
                continue
            if isinstance(i, int):
                const += s * i
            else:
                terms.append(i if s == 1 else f"{s} * {i}")
        if const or not terms:
            terms.append(str(const))
        return f"{self.name}[{' + '.join(terms)}]"

    def contiguous(self) -> bool:
        if self.expr is not None:
            return False
        want = _contiguous_strides(self.shape)
        return self.name is None or all(
            n == 1 or s == w for n, s, w in zip(self.shape, self.strides,
                                                want))


class _Emitter:
    """C++ of one traced graph (:func:`_emit_function`)."""

    def __init__(self, dtype: torch.dtype, warp: bool = False,
                 batch: int = BATCH):
        self.dtype = dtype
        self.warp = warp
        #: the twin's batch, which sets the geometry of its sums
        self.batch = batch
        self.lines: list[str] = []
        self.count = 0
        self.ops = 0
        self.member: dict = {}          # elementwise node -> fusion group
        self.needs_array: set = set()   # members read outside their group
        self.group: dict | None = None  # the open group
        #: the warp form's arrays in the scratch: name -> bytes
        self.scratch: dict = {}

    # -- C types and literals --
    def ctype(self, dtype) -> str:
        if dtype == self.dtype:
            return "T"
        return {torch.float32: "float", torch.float64: "double",
                torch.bool: "bool"}[dtype]

    def literal(self, v, dtype) -> str:
        if dtype == torch.bool:
            return "true" if bool(v) else "false"
        v = float(v)
        ct = self.ctype(dtype)
        if math.isnan(v):
            return f"{ct}(NAN)"
        if math.isinf(v):
            return f"{ct}({'-' if v < 0 else ''}INFINITY)"
        return f"{ct}({v!r})"

    def fresh(self, prefix: str = "v") -> str:
        self.count += 1
        return f"{prefix}{self.count}"

    def emit(self, line: str, depth: int = 1) -> None:
        self.lines.append("  " * depth + line)

    def loop(self, shape, body) -> None:
        """Nested loops over ``shape`` (a dim of size 1 takes index 0 and
        no loop); ``body(idx)`` gives the innermost statement.  In the warp
        form one loop over the entries, lane-strided (``K2G_LANES``), each
        dim's index taken from the entry's, then ``K2G_SYNC``."""
        if self.warp:
            self.lanes(shape, "i", lambda idx: [body(idx)])
            return
        idx, depth = [], 2
        for k, n in enumerate(shape):
            if n == 1:
                idx.append(0)
                continue
            self.emit("K2G_UNROLL", depth)
            self.emit(f"for (int i{k} = 0; i{k} < {n}; ++i{k}) {{", depth)
            idx.append(f"i{k}")
            depth += 1
        self.emit(body(idx), depth)
        for _ in range(depth - 2):
            depth -= 1
            self.emit("}", depth)

    def lanes(self, shape, prefix, body) -> None:
        """The warp form's loop over ``shape``: entry e of the flattened
        shape on lane e % 32 (``K2G_LANES``), index ``<prefix>k`` of dim k
        from e; ``body(idx)`` gives the statements of an entry.  The warp
        syncs after it (``K2G_SYNC``), so the next op may read any lane's
        entries."""
        n = max(1, math.prod(shape))
        self.emit(f"K2G_LANES(e, {n}) {{", 2)
        idx, first = [], True
        for k, m in enumerate(shape):
            if m == 1:
                idx.append(0)
                continue
            stride = math.prod(shape[k + 1:])
            e = "e" if stride == 1 else f"e / {stride}"
            self.emit(f"const int {prefix}{k} = {e}"
                      f"{'' if first else f' % {m}'};", 3)
            idx.append(f"{prefix}{k}")
            first = False
        for line in body(idx):
            self.emit(line, 3)
        self.emit("}", 2)
        self.emit("K2G_SYNC();", 2)

    def array(self, shape, dtype) -> _Val:
        name = self.fresh()
        n = max(1, math.prod(shape))
        if self.warp:
            # a place in the warp's scratch, given by place_scratch
            ct = self.ctype(dtype)
            self.scratch[name] = n * {torch.bool: 1, torch.float32: 4,
                                      torch.float64: 8}[dtype]
            self.emit(f"{ct}* {name} = reinterpret_cast<{ct}*>(ws + "
                      f"@{name}@);", 2)
        else:
            self.emit(f"{self.ctype(dtype)} {name}[{n}];", 2)
        return _Val(shape, dtype, name, _contiguous_strides(shape), 0)

    def place_scratch(self) -> int:
        """Give each array of the warp form its offset in the scratch, in
        bytes, 16-aligned: an array lives from the line that declares it to
        the last line that names it, and an array that begins after
        another's last line may take its place (ops are whole loops with a
        sync after each, so no lane still reads it).  Returns the scratch's
        bytes."""
        last = {}
        for k, line in enumerate(self.lines):
            for name in re.findall(r"\bv\d+\b", line):
                if name in self.scratch:
                    last[name] = k
        live, top = [], 0           # (offset, bytes, last line) of each
        for k, line in enumerate(self.lines):
            m = re.search(r"@(v\d+)@", line)
            if m is None:
                continue
            name = m.group(1)
            size = -(-self.scratch[name] // 16) * 16
            live = [a for a in live if a[2] >= k]
            off = 0
            for o, n, _ in sorted(live):
                if off + size <= o:
                    break
                off = max(off, o + n)
            live.append((off, size, last.get(name, k)))
            top = max(top, off + size)
            self.lines[k] = line.replace(f"@{name}@", str(off))
        return top

    def regrouped(self, v: _Val, shape) -> _Val:
        """A fusion group's scalar read at another shape with the same core
        (:func:`_passes_through`): the same element."""
        if _core(shape) != _core(v.shape):
            raise AssertionError("a group scalar read at another index")
        return dataclasses.replace(v, shape=tuple(shape))

    def materialize(self, v: _Val) -> _Val:
        out = self.array(v.shape, v.dtype)
        self.loop(v.shape, lambda i: f"{out.at(i)} = {v.at(i)};")
        return out

    def constant(self, t: torch.Tensor) -> _Val:
        t = t.detach().cpu()
        shape = tuple(t.shape)
        if t.dtype not in (torch.float32, torch.float64, torch.bool):
            # an integer constant (``arange``) is used through a cast
            t = t.to(self.dtype)
        flat = t.reshape(-1)
        if flat.numel() == 0:
            raise Refused("an empty tensor")
        first = flat[0]
        if bool(torch.all(flat == first)) or (
                t.is_floating_point() and bool(torch.all(torch.isnan(flat)))):
            return _Val(shape, t.dtype, lit=self.literal(first.item(),
                                                         t.dtype))
        if flat.numel() > MAX_CONST:
            raise Refused(f"a constant of {flat.numel()} entries (more than "
                          f"{MAX_CONST})")
        name = self.fresh()
        vals = ", ".join(self.literal(v, t.dtype) for v in flat.tolist())
        self.emit(f"const {self.ctype(t.dtype)} {name}[{flat.numel()}] = "
                  f"{{{vals}}};", 2)
        return _Val(shape, t.dtype, name, _contiguous_strides(shape), 0)

    # -- index maps --
    def broadcast(self, v: _Val, shape) -> _Val:
        """``v`` read at the multi-index of ``shape`` (right-aligned, size-1
        dims repeated)."""
        if v.expr is not None:
            return self.regrouped(v, shape)
        if v.name is None:
            return dataclasses.replace(v, shape=tuple(shape))
        lead = len(shape) - len(v.shape)
        strides = [0] * lead + [0 if n == 1 and m != 1 else s for n, m, s in
                                zip(v.shape, shape[lead:], v.strides)]
        return dataclasses.replace(v, shape=tuple(shape),
                                   strides=tuple(strides))

    def reshaped(self, v: _Val, shape) -> _Val:
        shape = tuple(shape)
        if v.expr is not None:
            return self.regrouped(v, shape)
        if v.name is None:
            return dataclasses.replace(v, shape=shape)
        if not v.contiguous():
            v = self.materialize(v)
        return dataclasses.replace(v, shape=shape,
                                   strides=_contiguous_strides(shape))

    def view_op(self, name, node, a: _Val, args):
        shape = _shape(node) if "val" in node.meta and not isinstance(
            node.meta["val"], (list, tuple)) else None
        if name in ("view", "_unsafe_view", "reshape"):
            return self.reshaped(a, shape)
        if name in ("alias", "detach", "clone", "lift_fresh_copy",
                    "contiguous"):
            return a
        if name == "_to_copy":
            want = node.meta["val"].dtype
            if want == a.dtype:
                return a
            if want not in (torch.float32, torch.float64):
                raise Refused(f"a cast to {want}")
            ct = self.ctype(want)
            return self.elementwise(node, [a],
                                    lambda x: f"static_cast<{ct}>({x})")
        if name == "expand":
            return self.broadcast(a, shape)
        if a.expr is not None:      # a group scalar: a view that keeps it
            return self.regrouped(a, shape)
        if a.name is None:
            if name in ("unbind", "split", "split_with_sizes"):
                return [dataclasses.replace(a, shape=_shape_of(m))
                        for m in node.meta["val"]]
            return dataclasses.replace(a, shape=shape)
        st, sh, off = list(a.strides), list(a.shape), a.offset

        def view(shape, strides, offset):
            return dataclasses.replace(a, shape=tuple(shape),
                                       strides=tuple(strides), offset=offset)
        nd = len(sh)
        if name == "unsqueeze":
            dim = args[1] % (nd + 1)
            return view(shape, st[:dim] + [0] + st[dim:], off)
        if name == "squeeze":
            dims = (range(nd) if len(args) < 2 else
                    [args[1]] if isinstance(args[1], int) else args[1])
            dims = {x % nd for x in dims if sh[x % nd] == 1} if nd else set()
            return view(shape, [s for k, s in enumerate(st) if k not in dims],
                        off)
        if name == "select":
            dim = args[1] % nd
            i = args[2] % sh[dim]
            return view(shape, st[:dim] + st[dim + 1:], off + st[dim] * i)
        if name == "slice":
            dim = args[1] % nd if len(args) > 1 else 0
            start, end, step = (list(args[2:]) + [None, None, 1])[:3]
            start, end, step = slice(start, end, step).indices(sh[dim])
            st[dim] *= step
            return view(shape, st, off + a.strides[dim] * start)
        if name in ("transpose", "t", "permute"):
            if name == "permute":
                perm = [p % nd for p in args[1]]
            else:
                d0, d1 = (args[1] % nd, args[2] % nd) if name == "transpose" \
                    else (0, 1 % max(nd, 1))
                perm = list(range(nd))
                perm[d0], perm[d1] = perm[d1], perm[d0]
            return view(shape, [st[p] for p in perm], off)
        if name in ("unbind", "split", "split_with_sizes"):
            at = 1 if name == "unbind" else 2       # the dim argument
            dim = (args[at] if len(args) > at else 0) % nd
            outs, pos = [], 0
            for m in node.meta["val"]:
                n = int(m.shape[dim]) if name != "unbind" else 1
                ms = _shape_of(m)
                ost = (st[:dim] + st[dim + 1:] if name == "unbind" else st)
                outs.append(view(ms, ost, off + st[dim] * pos))
                pos += n
            return outs
        raise Refused(f"the view aten.{name}")

    # -- elementwise --
    def elementwise(self, node, ins, expr) -> _Val:
        """An elementwise op, one statement of its fusion group's loop
        (:func:`_plan_groups`): a scalar ``s<n>`` the group's other members
        read at the same index, stored into an array where a reader outside
        the group needs it."""
        shape = _shape(node)
        dtype = node.meta["val"].dtype
        self.ops += max(1, math.prod(shape))
        gid = self.member[node]
        if self.group is None or self.group["gid"] != gid:
            self.flush()
            self.group = {"gid": gid, "core": _core(shape), "body": [],
                          "arrays": {}}
        idx, it = [], iter(f"c{k}" for k in range(len(self.group["core"])))
        for n in shape:
            idx.append(0 if n == 1 else next(it))
        views = [self.broadcast(v, shape) for v in ins]
        name = self.fresh("s")
        body = self.group["body"]
        body.append(f"{self.ctype(dtype)} {name} = "
                    f"{expr(*(v.at(idx) for v in views))};")
        if node in self.needs_array:
            arr = self.array(shape, dtype)
            body.append(f"{arr.at(idx)} = {name};")
            self.group["arrays"][node] = arr
        return _Val(shape, dtype, expr=lambda i, n=name: n)

    def flush(self) -> dict:
        """Emit the open fusion group's loop over its core shape; returns
        its members' arrays (node -> array value)."""
        g, self.group = self.group, None
        if g is None:
            return {}
        if self.warp:
            self.lanes(g["core"], "c", lambda idx: g["body"])
            return g["arrays"]
        depth = 2
        self.emit("{", depth)
        for k, n in enumerate(g["core"]):
            depth += 1
            self.emit("K2G_UNROLL", depth)
            self.emit(f"for (int c{k} = 0; c{k} < {n}; ++c{k}) {{", depth)
        for line in g["body"]:
            self.emit(line, depth + 1)
        for _ in g["core"]:
            self.emit("}", depth)
            depth -= 1
        self.emit("}", depth)
        return g["arrays"]

    def as_val(self, a, like: _Val, dtype=None) -> _Val:
        """A node's value, or a Python number as a literal of ``dtype``
        (the other operand's by default)."""
        if isinstance(a, _Val):
            return a
        return _Val((), dtype or like.dtype,
                    lit=self.literal(a, dtype or like.dtype))

    def cast(self, v: _Val, dtype) -> _Val:
        """``v`` read as ``dtype`` (a C cast where the types differ)."""
        if v.dtype == dtype:
            return v
        return dataclasses.replace(v, dtype=dtype, conv=self.ctype(dtype))

    # -- the ops that make new arrays from several values --
    def place(self, out: _Val, src: _Val) -> None:
        """out (a strided view of a new array) = src, element by element."""
        self.loop(src.shape, lambda i: f"{out.at(i)} = {src.at(i)};")

    def cat(self, node, vals, dim) -> _Val:
        shape = _shape(node)
        dtype = node.meta["val"].dtype
        out = self.array(shape, dtype)
        dim %= len(shape)
        pos = 0
        for v in vals:
            if math.prod(v.shape) == 0:
                continue
            v = self.cast(v, dtype)
            region = dataclasses.replace(out, shape=v.shape,
                                         offset=out.strides[dim] * pos)
            self.place(region, v)
            pos += v.shape[dim]
        return out

    def scatter_back(self, node, grad: _Val, sizes, dim, where) -> _Val:
        """zeros of ``sizes`` with ``grad`` placed at ``where`` along
        ``dim``: (index,) for select_backward, (start, end, step) for
        slice_backward."""
        shape = tuple(int(s) for s in sizes)
        dtype = node.meta["val"].dtype
        out = self.array(shape, dtype)
        zero = self.literal(0.0, dtype)
        self.loop(shape, lambda i: f"{out.at(i)} = {zero};")
        nd = len(shape)
        dim %= nd
        st = list(out.strides)
        if len(where) == 1:
            i = where[0] % shape[dim]
            region = dataclasses.replace(out, shape=grad.shape,
                                         strides=tuple(st[:dim] + st[dim + 1:]),
                                         offset=st[dim] * i)
        else:
            start, end, step = slice(*where).indices(shape[dim])
            st2 = list(st)
            st2[dim] *= step
            region = dataclasses.replace(out, shape=grad.shape,
                                         strides=tuple(st2),
                                         offset=st[dim] * start)
        self.place(region, self.cast(grad, dtype))
        return out

    def reduce_sum(self, node, a: _Val, dims, keepdim, mean=False) -> _Val:
        """A sum over ``dims`` in the order torch adds on CUDA at the
        twin's batch (the emitter's ``batch``), measured on an H100
        (PERF.md): over trailing dims (size-1 dims aside: the summands of
        each output contiguous, the fastest dim) the row-sum order
        ``k2g_warp_sum`` (csrc/solver.cuh's lane_part on one lane), or
        ``k2g_split_sum`` where torch's block is wider than a warp or its
        warps split the row (:func:`_row_split`), over other dims four
        running sums in :func:`_outer_split`'s groups."""
        nd = len(a.shape)
        dims = (set(range(nd)) if dims is None or (
            isinstance(dims, (list, tuple)) and len(dims) == 0)
            else {x % nd for x in ([dims] if isinstance(dims, int)
                                   else dims)})
        shape = _shape(node)
        dtype = node.meta["val"].dtype
        out = self.array(shape, dtype)
        kept = [k for k in range(nd) if k not in dims]
        red = [k for k in range(nd) if k in dims]
        count = math.prod(a.shape[k] for k in red)
        self.ops += max(0, math.prod(a.shape) - math.prod(shape))
        a = self.cast(a, dtype)
        kshape = [a.shape[k] for k in kept]

        def out_index(oi):
            if keepdim is False or len(shape) == len(kshape):
                return oi
            it = iter(oi)           # keepdim: the reduced dims are size 1
            return [next(it) if k in kept else 0 for k in range(nd)]

        def result(expr):
            return (f"{expr} / {self.literal(count, dtype)}" if mean
                    else expr)

        # the summands of each output are the fastest dim: no kept dim of
        # more than one entry after a reduced one
        big = [k for k in range(nd) if a.shape[k] > 1]
        fastest = all(k < j for k in big if k in kept
                      for j in big if j in dims)
        # the twin's outputs of this sum: the batch's
        outputs = self.batch * math.prod(kshape)
        if fastest and count > 1:
            if not a.contiguous() or a.conv is not None:
                a = self.materialize(a)
            flat = dataclasses.replace(a, shape=tuple(kshape),
                                       strides=_contiguous_strides(
                                           kshape + [count])[:-1])
            W, Y = _row_split(count, outputs)
            # 64 threads on at most 64 values, one a thread, add as 32 do
            fn = (f"k2g_warp_sum<{count}>" if (W <= 32 or count <= 64)
                  and Y == 1 else f"k2g_split_sum<{count}, {W}, {Y}>")

            def body(oi):
                start = flat.at(oi)[len(a.name) + 1:-1]
                return (f"{out.at(out_index(oi))} = "
                        + result(f"{fn}({a.name} + {start})") + ";")
            self.loop(kshape, body)
            return out
        if count == 0:
            raise Refused("a sum over no entries")
        # over leading or middle dims: the summands in the order of the
        # reduced dims, added as torch on CUDA adds a dim that is not the
        # fastest (_outer_split): W groups (y = 0..W-1, W = 1 below torch's
        # split), group y's summands y + W·i + 4W·m in four running sums
        # (slot i), the last ones in slots 0, 1, 2 in turn, then ((s0 + s1)
        # + s2) + s3, then the groups' halving tree
        rshape = [a.shape[k] for k in red]
        inner = math.prod(a.shape[k] for k in kept if k > max(red))
        W = _outer_split(count, inner, outputs)
        acc = self.fresh("s")
        ct = self.ctype(dtype)

        def summand(full, k):
            """a's entry of summand ``k`` (an int, or in the warp form a C
            expression of the loop's counter)."""
            ri = []
            for j, n in enumerate(rshape):
                st = math.prod(rshape[j + 1:])
                if isinstance(k, int):
                    ri.append(k // st % n)
                else:
                    e = f"({k})" if st == 1 else f"({k}) / {st}"
                    ri.append(e if j == 0 else f"{e} % {n}")
            for kk, i in zip(red, ri):
                full[kk] = i
            return a.at(full)

        def body(oi):
            full = [None] * nd
            for k, i in zip(kept, oi):
                full[k] = i
            lines = []
            for y in range(W):
                g = f"{acc}_{y}"
                lines.append(f"{ct} " + ", ".join(f"{g}_{j} = {ct}(0)"
                                                  for j in range(4)) + ";")
                ks = list(range(y, count - 3 * W, 4 * W))
                if self.warp and ks:
                    # the warp form: a loop, not unrolled over the width
                    lines.append(
                        f"for (int k = {y}; k < {ks[-1] + 4 * W}; k += "
                        f"{4 * W}) {{ " + " ".join(
                            f"{g}_{j} = {g}_{j} + "
                            f"{summand(full, f'k + {j * W}')};"
                            for j in range(4)) + " }")
                else:
                    for k in ks:
                        lines += [f"{g}_{j} = {g}_{j} + "
                                  f"{summand(full, k + j * W)};"
                                  for j in range(4)]
                k = ks[-1] + 4 * W if ks else y
                for j in range(4):
                    if k >= count:
                        break
                    lines.append(f"{g}_{j} = {g}_{j} + {summand(full, k)};")
                    k += W
                lines.append(f"{ct} {g} = (({g}_0 + {g}_1) + {g}_2) + "
                             f"{g}_3;")
            off = W // 2
            while off:
                lines += [f"{acc}_{y} = {acc}_{y} + {acc}_{y + off};"
                          for y in range(off)]
                off //= 2
            lines.append(f"{out.at(out_index(oi))} = "
                         + result(f"{acc}_0") + ";")
            return "{ " + " ".join(lines) + " }"

        self.loop(kshape, body)
        return out

    def matmul(self, node, a: _Val, b: _Val, kind: str) -> _Val:
        """dot, mv, mm, bmm: out = Σ_k a[..., k] b[..., k, ...] in
        ascending k."""
        shape = _shape(node)
        dtype = node.meta["val"].dtype
        out = self.array(shape, dtype)
        a, b = self.cast(a, dtype), self.cast(b, dtype)
        K = a.shape[-1]
        zero = self.literal(0.0, dtype)
        self.ops += 2 * K * max(1, math.prod(shape))
        acc = self.fresh()

        def idx(oi):
            if kind == "dot":
                return [], []
            if kind == "mv":
                return [oi[0]], []
            if kind == "mm":
                return [oi[0]], [oi[1]]
            return [oi[0], oi[1]], [oi[0], oi[2]]

        def body(oi):
            ai, bi = idx(oi)
            if kind == "bmm":
                ea = lambda k: a.at([ai[0], ai[1], k])        # noqa: E731
                eb = lambda k: b.at([bi[0], k, bi[1]])        # noqa: E731
            elif kind == "mm":
                ea = lambda k: a.at([ai[0], k])               # noqa: E731
                eb = lambda k: b.at([k, bi[0]])               # noqa: E731
            elif kind == "mv":
                ea = lambda k: a.at([ai[0], k])               # noqa: E731
                eb = lambda k: b.at([k])                      # noqa: E731
            else:
                ea = lambda k: a.at([k])                      # noqa: E731
                eb = lambda k: b.at([k])                      # noqa: E731
            k = "k0" if K > 1 else 0
            loop = (f"{'' if self.warp else 'K2G_UNROLL '}for (int k0 = 0; "
                    f"k0 < {K}; ++k0) " if K > 1 else "")
            return (f"{{ {self.ctype(dtype)} {acc} = {zero}; {loop}"
                    f"{acc} = {acc} + {ea(k)} * {eb(k)}; "
                    f"{out.at(oi)} = {acc}; }}")

        self.loop(shape, body)
        return out


def _last_pow2(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _row_split(count: int, outputs: int) -> tuple[int, int]:
    """The geometry in which torch's CUDA sum adds ``count`` contiguous
    summands of each of ``outputs`` outputs (ATen's Reduce.cuh
    ``setReduceConfig``, csrc/solver_warp.cuh's ``torch_row_geometry``):
    from 128 summands it reads 4-vectors; a block is W threads along the
    row (the largest power of two ≤ the row's vectors or values, at most
    512 / h, h = min(the largest power of two ≤ ``outputs``, 512 / min(that,
    32)) rows a block), and Y = h warps split the row where that leaves at
    least min(16·h, 256) summands a thread, else Y = 1.  (W, Y) = (32, 1),
    or W < 32 on a shorter row (which adds as 32 slots do), from 16 outputs
    on below 8,161 summands."""
    dim0 = count // 4 if count >= 128 else count
    p0 = _last_pow2(dim0) if dim0 < 512 else 512
    p1 = _last_pow2(outputs) if outputs < 512 else 512
    h = min(p1, 512 // min(p0, 32))
    W = min(p0, 512 // h)
    return W, (h if -(-count // W) >= min(16 * h, 256) else 1)


def _outer_split(count: int, inner: int, outputs: int) -> int:
    """The groups W in which torch's CUDA sum adds ``count`` summands over
    a dim that is not the fastest, ``inner`` outputs contiguous after it,
    ``outputs`` outputs in all (ATen's Reduce.cuh ``setReduceConfig``;
    probed on an H100, PERF.md): it loads ``vec`` outputs at a time (4, 2 or
    1, as ``inner`` divides), a block is w = min(the largest power of two ≤
    ``outputs`` / ``vec``, 32) threads wide and ``h`` = min(the largest
    power of two ≤ ``count``, 512 / ``vec`` / w) warps high, and from
    min(16·h, 256) summands a thread on the warps split the summands (W =
    h), else each thread adds them all (W = 1).  From a batch of 32 on,
    w = 32."""
    vec = 4 if inner % 4 == 0 else 2 if inner % 2 == 0 else 1
    most = 512 // vec
    dim0 = max(outputs // vec, 1)
    wide = min(_last_pow2(dim0) if dim0 < most else most, 32)
    high = min(_last_pow2(count) if count < most else most, most // wide)
    return high if count >= min(16 * high, 256) else 1


def _passes_through(node) -> bool:
    """Whether ``node`` hands its input on unchanged, at the same index:
    an alias, a copy of the same type, a view or expand to the same
    shape."""
    if node.op != "call_function" or node.target is operator.getitem:
        return False
    try:
        op = _op_name(node)
    except Refused:
        return False
    src = node.args[0] if node.args else None
    if not isinstance(src, torch.fx.Node) or not isinstance(
            node.meta.get("val"), torch.Tensor) or not isinstance(
                src.meta.get("val"), torch.Tensor):
        return False
    a, b = node.meta["val"], src.meta["val"]
    if a.dtype != b.dtype:
        return False
    if op in ("alias", "detach", "clone", "lift_fresh_copy", "contiguous",
              "_to_copy", "expand"):
        return tuple(a.shape) == tuple(b.shape)
    if op in ("view", "_unsafe_view", "reshape", "squeeze", "unsqueeze"):
        return _core(a.shape) == _core(b.shape)
    if op in ("transpose", "t", "permute"):
        nd = len(b.shape)
        if op == "permute":
            perm = [int(p) % nd for p in node.args[1]]
        else:
            d0, d1 = ((int(node.args[1]) % nd, int(node.args[2]) % nd)
                      if op == "transpose" else (0, 1 % max(nd, 1)))
            perm = list(range(nd))
            perm[d0], perm[d1] = perm[d1], perm[d0]
        kept = [p for p in perm if b.shape[p] != 1]
        return kept == sorted(kept)
    return False


def _is_elementwise(node) -> bool:
    """Whether ``node``'s output element at an index is computed from its
    inputs' elements at that index (broadcast): the ops of
    ``_ELEMENTWISE``, a cast, and a matrix product of depth 1."""
    op = _op_name(node)
    if op in _ELEMENTWISE:
        return True
    src = node.args[0] if node.args else None
    if op == "_to_copy":
        return (isinstance(src, torch.fx.Node)
                and node.meta["val"].dtype != src.meta["val"].dtype)
    return op in ("mm", "bmm") and int(src.meta["val"].shape[-1]) == 1


def _plan_groups(gm, consts) -> tuple[dict, set]:
    """Fusion groups of a graph: consecutive elementwise nodes over one
    core shape (:func:`_core`) that read each other only at their own
    index make one loop, each node a scalar there.  A group ends where a
    node outside it reads one of its members, or where an elementwise node
    of another core — or reading a member at another index — begins the
    next.  Returns (node -> group, the members read outside their group,
    which are stored into arrays)."""
    member, gid, core = {}, -1, None

    def source(a):
        while (isinstance(a, torch.fx.Node) and a not in consts
               and _passes_through(a)):
            a = a.args[0]
        return a

    for n in gm.graph.nodes:
        if n.op != "call_function" or n in consts or _passes_through(n):
            continue
        ins = {source(a) for a in n.all_input_nodes}
        if _is_elementwise(n):
            c = _core(_shape(n))
            cur = [i for i in ins if member.get(i) == gid]
            if core is None or c != core or any(
                    _core(_shape(i)) != c for i in cur):
                gid, core = gid + 1, c
            member[n] = gid
        elif any(member.get(i) == gid for i in ins):
            core = None
    needs = {m for m in member
             if any(member.get(r) != member[m] for r in _readers(m))}
    return member, needs


def _readers(node) -> list:
    """The nodes that read ``node``'s value, looking through the nodes
    that pass it on unchanged."""
    out = []
    for u in node.users:
        out += _readers(u) if _passes_through(u) else [u]
    return out


def _op_name(node) -> str:
    t = node.target
    if t is operator.getitem:
        return "getitem"
    packet = getattr(t, "overloadpacket", None)
    if packet is None or not str(t).startswith("aten."):
        raise Refused(f"the call {t}")
    return packet.__name__


def _emit_function(gm, dtype, inputs: list, values: dict, name: str,
                   signature: str, warp: bool = False, batch: int = BATCH
                   ) -> tuple[str, int, int]:
    """C++ of one traced graph ``gm`` as ``name``: its placeholders bound
    in order to ``inputs`` (each a :class:`_Val` over a pointer of the
    signature), its output copied into ``out``; in the warp form
    (``warp``) for the 32 lanes of a warp, every array in the scratch
    ``ws``; its sums in torch's orders at the twin's ``batch``.  Returns
    (source, the arithmetic operations, the scratch's bytes)."""
    em = _Emitter(dtype, warp, batch)
    env: dict = {}
    consts: dict = {}       # values that depend on no input, emitted on use
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, val in zip(placeholders, inputs):
        env[node] = val
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            consts[node] = values[node]
        elif node.op == "call_function":
            op = _op_name(node)
            if op != "getitem" and op not in OP_TABLE:
                raise Refused(f"the op aten.{op} (not in residual_codegen."
                              f"OP_TABLE)")
            if op in _SHAPE_ONLY or all(a in consts
                                        for a in node.all_input_nodes):
                if not isinstance(values[node], (torch.Tensor, list,
                                                 tuple)):
                    raise Refused("a constant of type "
                                  f"{type(values[node]).__name__}")
                consts[node] = values[node]
        elif node.op not in ("placeholder", "output"):
            raise Refused(f"a graph node of kind {node.op}")
    em.member, em.needs_array = _plan_groups(gm, consts)

    def value(a):
        if a in consts and a not in env:
            v = consts[a]
            env[a] = ([em.constant(t) for t in v] if isinstance(v, (list,
                                                                     tuple))
                      else em.constant(v))
        if a not in env:        # a view that passes its input on
            return em.view_op(_op_name(a), a, value(a.args[0]),
                              arg(list(a.args)))
        return env[a]

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return value(a)
        if isinstance(a, (list, tuple)):
            return [arg(x) for x in a]
        return a

    def flush():
        env.update(em.flush())

    def reads_group(node):
        for a in node.all_input_nodes:
            while a not in consts and _passes_through(a):
                a = a.args[0]
            if em.member.get(a) == em.group["gid"]:
                return True
        return False

    out_node = None
    for node in gm.graph.nodes:
        if node.op == "output":
            out_node = node.args[0]
            break
        if node.op != "call_function" or node in consts \
                or _passes_through(node):
            continue
        if em.group is not None and em.member.get(node) != em.group["gid"] \
                and (node in em.member or reads_group(node)):
            flush()
        val = node.meta.get("val")
        op = _op_name(node)
        if isinstance(val, torch.Tensor) and val.dtype not in (
                torch.float32, torch.float64, torch.bool):
            raise Refused(f"a value of type {val.dtype} (aten.{op})")
        env[node] = _emit_op(em, node, op, arg(list(node.args)),
                             dict(node.kwargs))
    flush()
    if not isinstance(out_node, torch.fx.Node):
        raise Refused("a function whose output is not one tensor")
    res = value(out_node)
    if isinstance(res, list):
        raise Refused("a function whose output is not one tensor")
    flat = em.cast(em.reshaped(res, (max(1, math.prod(res.shape)),)), dtype)
    em.loop(flat.shape, lambda i: f"out[{i[0]}] = {flat.at(i)};")
    scratch = em.place_scratch() if warp else 0
    body = "\n".join(em.lines)
    if warp:
        signature += ", unsigned char* ws, int lane"
    return (f"  template <typename T>\n  static K2G_{'WD' if warp else 'HD'} "
            f"void {name}"
            f"({signature}) {{\n{body}\n  }}\n", em.ops, scratch)


def _emit_op(em: _Emitter, node, op: str, args, kw):
    out_dtype = node.meta["val"].dtype if isinstance(
        node.meta.get("val"), torch.Tensor) else None
    if op == "getitem":
        return args[0][args[1]]
    if op in _VIEWS:
        return em.view_op(op, node, args[0], args)
    if op in _UNARY:
        a = em.cast(args[0], out_dtype)
        one, zero = em.literal(1.0, out_dtype), em.literal(0.0, out_dtype)
        return em.elementwise(node, [a], lambda x: _UNARY[op].format(
            a=x, one=one, zero=zero))
    if op in _BINARY or op == "rsub":
        if op == "div" and kw.get("rounding_mode") is not None:
            raise Refused("aten.div with a rounding mode")
        a = em.cast(args[0], out_dtype)
        if op == "div" and not isinstance(args[1], _Val):
            # torch divides a CUDA tensor by a Python number as a product
            # with its reciprocal (the twin's arithmetic on the card)
            r = em.literal(1.0, out_dtype) + " / " + em.literal(args[1],
                                                                 out_dtype)
            b = _Val((), out_dtype, lit=f"({r})")
            return em.elementwise(node, [a, b],
                                  lambda x, y: f"({x} * {y})")
        b = em.cast(em.as_val(args[1], a, out_dtype), out_dtype)
        alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
        al, one = em.literal(alpha, out_dtype), em.literal(1.0, out_dtype)

        def expr(x, y):
            if alpha != 1:          # a + alpha b, a - alpha b, b - alpha a
                x, y = ((f"({al} * {x})", y) if op == "rsub"
                        else (x, f"({al} * {y})"))
            if op == "rsub":
                return f"({y} - {x})"
            return _BINARY[op].format(a=x, b=y, one=one)
        return em.elementwise(node, [a, b], expr)
    if op in _COMPARE:
        a = args[0]
        b = em.as_val(args[1], a)
        ct = torch.promote_types(a.dtype, b.dtype)
        a, b = em.cast(a, ct), em.cast(b, ct)
        return em.elementwise(node, [a, b],
                              lambda x, y: f"({x} {_COMPARE[op]} {y})")
    if op in _LOGICAL:
        return em.elementwise(node, args[:2 if op != "logical_not" else 1],
                              lambda a, b=None: _LOGICAL[op].format(a=a, b=b))
    if op == "where":
        c = args[0]
        a = em.cast(em.as_val(args[1], c, out_dtype), out_dtype)
        b = em.cast(em.as_val(args[2], c, out_dtype), out_dtype)
        return em.elementwise(node, [c, a, b],
                              lambda x, y, z: f"({x} ? {y} : {z})")
    if op == "masked_fill":
        # where(mask, value, a): atan2's derivative zeroes 1 / (a² + b²)
        # where a² + b² = 0
        a = em.cast(args[0], out_dtype)
        v = em.cast(em.as_val(args[2], a, out_dtype), out_dtype)
        return em.elementwise(node, [args[1], v, a],
                              lambda m, y, x: f"({m} ? {y} : {x})")
    if op == "pow":
        if not isinstance(args[1], (int, float)):
            raise Refused("aten.pow with a tensor exponent")
        e = float(args[1])
        a = em.cast(args[0], out_dtype)
        one = em.literal(1.0, out_dtype)
        expr = {2.0: "k2g_pow2({a})", 3.0: "k2g_pow3({a})",
                0.5: "sqrt({a})", -1.0: "(" + one + " / {a})",
                1.0: "{a}", -2.0: "(" + one + " / k2g_pow2({a}))"}.get(
                    e, "pow({a}, " + em.literal(e, out_dtype) + ")")
        return em.elementwise(node, [a], lambda x: expr.format(a=x))
    if op in ("clamp", "clamp_min", "clamp_max"):
        a = em.cast(args[0], out_dtype)
        lo = kw.get("min", args[1] if len(args) > 1 and op != "clamp_max"
                    else None)
        hi = kw.get("max", args[2] if len(args) > 2 else
                    args[1] if op == "clamp_max" else None)
        if isinstance(lo, _Val) or isinstance(hi, _Val):
            raise Refused("aten.clamp with tensor bounds")

        def clamp(x):
            # torch.clamp keeps a NaN
            if lo is not None:
                x = f"k2g_clamp_min({x}, {em.literal(lo, out_dtype)})"
            if hi is not None:
                x = f"k2g_clamp_max({x}, {em.literal(hi, out_dtype)})"
            return x
        return em.elementwise(node, [a], clamp)
    if op in ("cat", "stack"):
        dim = kw.get("dim", args[1] if len(args) > 1 else 0)
        vals = list(args[0])
        if op == "stack":
            nd = len(vals[0].shape) + 1
            dim %= nd
            vals = [em.view_op("unsqueeze", _FakeNode(
                v.shape[:dim] + (1,) + v.shape[dim:]), v, [None, dim])
                for v in vals]
        return em.cat(node, vals, dim)
    if op == "select_backward":
        return em.scatter_back(node, args[0], args[1], args[2], (args[3],))
    if op == "slice_backward":
        return em.scatter_back(node, args[0], args[1], args[2],
                               (args[3], args[4], args[5]))
    if op in ("sum", "mean"):
        if kw.get("dtype") is not None and kw["dtype"] != out_dtype:
            raise Refused(f"aten.{op} with a dtype")
        dims = kw.get("dim", args[1] if len(args) > 1 else None)
        keep = kw.get("keepdim", args[2] if len(args) > 2 else False)
        return em.reduce_sum(node, args[0], dims, keep, mean=op == "mean")
    if op in ("mm", "bmm") and args[0].shape[-1] == 1:
        # depth 1 (a dot of one entry, robust_whiten's n² under vmap): the
        # product of the operands broadcast over the output
        a, b = (em.cast(v, out_dtype) for v in args[:2])
        return em.elementwise(node, [a, b], lambda x, y: f"({x} * {y})")
    if op in ("dot", "mv", "mm", "bmm"):
        return em.matmul(node, args[0], args[1], op)
    raise Refused(f"the op aten.{op}")


class _FakeNode:
    """The ``meta`` of a node that is not in the graph (stack's
    unsqueezed inputs)."""

    def __init__(self, shape):
        self.meta = {"val": torch.empty(shape, device="meta")}


class _Recorder(torch.fx.Interpreter):
    """Runs a traced graph and keeps every node's value."""

    def __init__(self, gm):
        super().__init__(gm)
        self.values: dict = {}

    def run_node(self, n):
        out = super().run_node(n)
        self.values[n] = out
        return out


def _trace(fn, args):
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)
    # functionalized: an in-place op (the vjp of clamp ands its masks in
    # place) becomes its out-of-place form; traced on fake tensors (shapes
    # and types only, no arithmetic on the device), then run once on the
    # example for the values the emitter folds
    try:
        gm = make_fx(torch.func.functionalize(fn), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
    except (GuardOnDataDependentSymNode, DataDependentOutputException) as e:
        raise Refused("a value read back to the host (aten."
                      "_local_scalar_dense: data-dependent control flow)"
                      ) from e
    gm.graph.eliminate_dead_code()
    gm.recompile()
    rec = _Recorder(gm)
    with torch.no_grad():
        rec.run(*args)
    return gm, rec.values


_HEADER = """\
// Generated by tinyopt_tpu_torch/ops/residual_codegen.py from the traced
// residual {fn} ({dtype}): P = {P}, d = {d}, n_res = {n_res}, a data row
// of {q} values{leaves}.  The residual, its jvp and its vjp (torch.func's,
// traced through the retraction) and the retraction of one instance, for
// K2's GeneratedFamily (csrc/solver.cuh).
#pragma once
#ifdef __CUDACC__
#define K2G_HD __host__ __device__ __forceinline__
#define K2G_UNROLL _Pragma("unroll")
// the warp form (device code: it syncs the warp): entry e of an op on lane
// e % 32, a sync after each op; each function compiled once, not inlined
// at each of the kernel's calls (nvcc took minutes on the inlined copies)
#define K2G_WD __device__ __noinline__
#define K2G_LANES(e, n) for (int e = lane; e < (n); e += 32)
#define K2G_SYNC() __syncwarp()
#else
#include <cmath>
#include <vector>
#define K2G_HD inline
#define K2G_WD inline
#define K2G_UNROLL
// the warp form on the host: the 32 lanes one after another, each op whole
// before the next
#define K2G_LANES(e, n) \\
  for (int k2g_l = 0; k2g_l < 32; ++k2g_l) \\
    for (int e = k2g_l; e < (n); e += 32)
#define K2G_SYNC() ((void)lane)
#endif

namespace tinyopt {{
namespace k2gen {{
#ifndef __CUDACC__
using std::atan2; using std::cos; using std::exp; using std::fabs;
using std::log;
using std::pow; using std::sin; using std::sqrt; using std::tanh;
#endif

// The sum of N contiguous values in the order of a CUDA row sum of torch
// (the twin's, csrc/solver.cuh's lane_part on one lane): below 128 values
// slot l < 32 holds 0 + t_l + t_(l+32) + ...; from 128 on (torch loads
// 4-vectors) slot l holds ((a0 + a1) + a2) + a3, a_j = 0 + t_(4l+j) +
// t_(4l+128+j) + ..., the N % 4 last values added to a0 of slots 0, 1, 2;
// then halving trees over the slots that may hold a value.
template <int N, typename T>
K2G_HD T k2g_warp_sum(const T* t) {{
  T u[32];
  if (N >= 128) {{
    K2G_UNROLL
    for (int k = 0; k < 32; ++k) {{
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      for (int j = 4 * k; j + 3 < N; j += 128) {{
        a0 = a0 + t[j];
        a1 = a1 + t[j + 1];
        a2 = a2 + t[j + 2];
        a3 = a3 + t[j + 3];
      }}
      if (N - N % 4 + k < N) a0 = a0 + t[N - N % 4 + k];
      u[k] = ((a0 + a1) + a2) + a3;
    }}
  }} else {{
    K2G_UNROLL
    for (int k = 0; k < 32; ++k) {{
      u[k] = k < N ? T(0) + t[k] : T(0);
      for (int j = k + 32; j < N; j += 32) u[k] = u[k] + t[j];
    }}
  }}
  int live = N < 32 ? N : 32;
  K2G_UNROLL
  for (int off = 16; off >= 1; off >>= 1) {{
    K2G_UNROLL
    for (int k = 0; k < off; ++k)
      if (k + off < live) u[k] = u[k] + u[k + off];
    live = live < off ? live : off;
  }}
  return u[0];
}}

// The sum of N contiguous values where torch's block is W > 32 threads
// along the row or Y > 1 warps split it (a small batch, or a long row:
// _row_split, csrc/solver_warp.cuh's torch_row_sum): thread (x, y) adds
// 4-vectors x + y W, x + y W + W Y, ... in four sums (from 128 on; the N % 4
// last values to a0 of threads 0, 1, 2 of y = 0) or values x, x + W, ...
// (below), then each y's halving tree over its W threads, then the halving
// tree over the Y warps.
template <int N, int W, int Y, typename T>
K2G_HD T k2g_split_sum(const T* t) {{
  T tot[Y];
  for (int y = 0; y < Y; ++y) {{
    T u[W];
    for (int x = 0; x < W; ++x) {{
      if (N >= 128) {{
        T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
        for (int v = x + y * W; 4 * v + 3 < N; v += W * Y) {{
          a0 = a0 + t[4 * v];
          a1 = a1 + t[4 * v + 1];
          a2 = a2 + t[4 * v + 2];
          a3 = a3 + t[4 * v + 3];
        }}
        if (y == 0 && N - N % 4 + x < N) a0 = a0 + t[N - N % 4 + x];
        u[x] = ((a0 + a1) + a2) + a3;
      }} else {{
        u[x] = T(0);
        for (int j = x; j < N; j += W) u[x] = u[x] + t[j];
      }}
    }}
    for (int off = W / 2; off >= 1; off >>= 1)
      for (int x = 0; x < off; ++x) u[x] = u[x] + u[x + off];
    tot[y] = u[0];
  }}
  for (int off = Y / 2; off >= 1; off >>= 1)
    for (int y = 0; y < off; ++y) tot[y] = tot[y] + tot[y + off];
  return tot[0];
}}

// Ops that read an operand twice, as functions, so that an operand that is
// itself an expression is computed once.
template <typename T>
K2G_HD T k2g_clamp_min(T v, T lo) {{ return v < lo ? lo : v; }}
template <typename T>
K2G_HD T k2g_clamp_max(T v, T hi) {{ return v > hi ? hi : v; }}
template <typename T>
K2G_HD T k2g_sign(T v) {{ return v > T(0) ? T(1) : (v < T(0) ? T(-1) : v); }}
template <typename T>
K2G_HD T k2g_pow2(T v) {{ return v * v; }}
template <typename T>
K2G_HD T k2g_pow3(T v) {{ return v * v * v; }}
template <typename T>
K2G_HD T k2g_tanh_backward(T g, T y) {{ return g * (T(1) - y * y); }}

struct Residual {{
  static constexpr int kP = {P}, kD = {d}, kNRes = {n_res}, kQ = {q};
  static constexpr bool kManifold = {manifold};
  // the warp form (warp_rows, warp_jvp_rows, warp_vjp_rows: one instance a
  // warp, its arrays in kScratch values of T a warp) or the register form
  // (rows, jvp_rows, vjp_rows: one instance a thread)
  static constexpr bool kWarp = {warp};
  static constexpr int kScratch = {scratch};
"""

_FOOTER = """\
}};

}}  // namespace k2gen
}}  // namespace tinyopt

#ifdef K2G_HOST_ENTRY
// Host entry points of the traced type, for the CPU tests (g++): the
// register form's (k2g_residual...) or the warp form's (k2g_warp_residual...,
// its lanes one after another).
extern "C" {{
{entries}void k2g_retract({ct} const* x, {ct} const* dx, {ct}* out) {{
  tinyopt::k2gen::Residual::retract_rows<{ct}>(x, dx, out);
}}
}}
#endif
"""

_REGISTER_ENTRIES = """\
void k2g_residual({ct} const* x, {ct} const* data, {ct}* out) {{
  tinyopt::k2gen::Residual::rows<{ct}>(x, data, out);
}}
void k2g_jvp({ct} const* x, {ct} const* data, {ct} const* p, {ct}* out) {{
  tinyopt::k2gen::Residual::jvp_rows<{ct}>(x, data, p, out);
}}
void k2g_vjp({ct} const* x, {ct} const* data, {ct} const* q, {ct}* out) {{
  tinyopt::k2gen::Residual::vjp_rows<{ct}>(x, data, q, out);
}}
"""

_WARP_ENTRIES = """\
static unsigned char* k2g_ws() {{
  static std::vector<{ct}> ws(tinyopt::k2gen::Residual::kScratch + 1);
  return reinterpret_cast<unsigned char*>(ws.data());
}}
void k2g_warp_residual({ct} const* x, {ct} const* data, {ct}* out) {{
  tinyopt::k2gen::Residual::warp_rows<{ct}>(x, data, out, k2g_ws(), 0);
}}
void k2g_warp_jvp({ct} const* x, {ct} const* data, {ct} const* p,
                  {ct}* out) {{
  tinyopt::k2gen::Residual::warp_jvp_rows<{ct}>(x, data, p, out, k2g_ws(), 0);
}}
void k2g_warp_vjp({ct} const* x, {ct} const* data, {ct} const* q,
                  {ct}* out) {{
  tinyopt::k2gen::Residual::warp_vjp_rows<{ct}>(x, data, q, out, k2g_ws(), 0);
}}
"""


def _make(residual_fn, x_example, data_example, dtype) -> GeneratedFamily:
    """:func:`generated_family`'s work; raises :class:`Refused`."""
    if dtype not in (torch.float32, torch.float64):
        raise Refused(f"parameters of type {dtype} (float32 or float64)")
    leaves = pytree.tree_leaves(x_example)
    if not leaves or any(not isinstance(l, torch.Tensor) for l in leaves):
        raise Refused("parameters that are not tensors")
    if any(l.dtype != dtype for l in leaves):
        raise Refused("parameters of mixed dtypes")
    spec = mf.tangent_spec(x_example)
    P, d = spec.params, spec.dims
    if spec.has_manifold and P == d:
        # GeneratedFamily keeps x in kP values beside a tangent of kD only
        # where the two differ (csrc/solver.cuh's static_assert)
        raise Refused(f"a manifold whose stored width equals its tangent "
                      f"width ({P})")
    detach = functools.partial(pytree.tree_map,
                               lambda a: a.detach()
                               if isinstance(a, torch.Tensor) else a)
    xv = mf.flatten_batch(pytree.tree_map(lambda a: a[None],
                                          detach(x_example)), spec)[0]
    if data_example is None:
        dleaves, dtree = [], None
    else:
        dleaves, dtree = pytree.tree_flatten(detach(data_example))
        for leaf in dleaves:
            if not isinstance(leaf, torch.Tensor):
                raise Refused(f"a data leaf of type {type(leaf).__name__}")
            if leaf.dtype != dtype:
                raise Refused(f"a data leaf of type {leaf.dtype} (the "
                              f"parameters' {dtype})")
    r1 = instance_residuals(residual_fn, spec, data_example is not None)

    def R(x, dl):
        if dtree is None:
            return r1(x)
        return r1(x, pytree.tree_unflatten(list(dl), dtree))

    def res(x, *dl):
        return R(x, dl)

    # the twin's linearization (cuda_solver.fused_solve_plain): δ ↦
    # r(x ⊞ δ) at δ = 0, which is r(x + δ) on Euclidean parameters
    def at(x, dl):
        return lambda dd: R(mf.retract_flat(x, dd, spec), dl)

    def jvp(x, p, *dl):
        return torch.func.jvp(at(x, dl), (torch.zeros_like(p),), (p,))[1]

    def vjp(x, q, *dl):
        z = torch.zeros((d,), dtype=x.dtype, device=x.device)
        return torch.func.vjp(at(x, dl), z)[1](q)[0]

    def retract(x, dx):
        return mf.retract_flat(x, dx, spec)

    try:
        with torch.no_grad():
            r0 = res(xv, *dleaves)
    except Exception as e:                      # noqa: BLE001
        raise Refused(f"the residual does not run on the example "
                      f"({type(e).__name__}: {e})") from e
    n_res = int(r0.numel())
    if n_res == 0:
        raise Refused("no residuals")
    warp = max(P, d, n_res) > SEG_MAX
    shapes = tuple(_shape_of(l) for l in dleaves)
    q_len = sum(math.prod(s) for s in shapes)
    x_in = _Val((P,), dtype, "x", (1,), 0)
    p_in = _Val((d,), dtype, "p", (1,), 0)
    q_in = _Val((n_res,), dtype, "q", (1,), 0)
    dx_in = _Val((d,), dtype, "dx", (1,), 0)
    d_ins, off = [], 0
    for s in shapes:
        d_ins.append(_Val(s, dtype, "data", _contiguous_strides(s), off))
        off += math.prod(s)
    tangent = torch.ones((d,), dtype=dtype, device=xv.device)
    cotangent = torch.ones((n_res,), dtype=dtype, device=xv.device)
    sig = "const T* __restrict__ x, const T* __restrict__ data, "
    # r, its jvp and its vjp in the register form up to SEG_MAX (one
    # instance a thread), in the warp form past it (one instance a warp, for
    # K2's warp kernel); the retraction in the register form (every lane of
    # a warp retracts the whole x)
    traced = []
    for name, fn, args, ins, head, want in (
            ("rows", res, (xv, *dleaves), [x_in, *d_ins], sig, n_res),
            ("jvp_rows", jvp, (xv, tangent, *dleaves), [x_in, p_in, *d_ins],
             sig + "const T* __restrict__ p, ", n_res),
            ("vjp_rows", vjp, (xv, cotangent, *dleaves),
             [x_in, q_in, *d_ins], sig + "const T* __restrict__ q, ", d),
            ("retract_rows", retract, (xv, tangent), [x_in, dx_in],
             "const T* __restrict__ x, const T* __restrict__ dx, ", P)):
        try:
            gm, values = _trace(fn, args)
        except Refused:
            raise
        except Exception as e:                  # noqa: BLE001
            raise Refused(f"the {name} trace failed ({type(e).__name__}: "
                          f"{e})") from e
        out = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
        if not isinstance(out, torch.fx.Node) or not isinstance(
                out.meta.get("val"), torch.Tensor) or math.prod(
                    out.meta["val"].shape) != want:
            raise Refused(f"a {name} that is not one tensor of {want} "
                          "values")
        traced.append((name, gm, values, ins, head))
    itemsize = torch.empty((), dtype=dtype).element_size()
    leaf_text = "".join(f", {tuple(s)}" for s in shapes)
    ct = "float" if dtype == torch.float32 else "double"
    entries = (_WARP_ENTRIES if warp else _REGISTER_ENTRIES).format(ct=ct)

    def emit(batch: int) -> GeneratedFamily:
        """The family's source with the twin's sums at ``batch``."""
        parts, ops, scratch = [], {}, 0
        for name, gm, values, ins, head in traced:
            in_warp = warp and name != "retract_rows"
            src, n_ops, n_ws = _emit_function(
                gm, dtype, ins, values, ("warp_" if in_warp else "") + name,
                head + "T* __restrict__ out", in_warp, batch)
            parts.append(src)
            scratch = max(scratch, n_ws)
            ops[{"rows": "residual", "jvp_rows": "jvp", "vjp_rows": "vjp",
                 "retract_rows": "retract"}[name]] = n_ops
        scratch = -(-scratch // (4 * itemsize)) * 4     # values, 4 at a time
        if warp:
            from .cuda_solver import _MAX_SMEM, warp_state_values
            need = (warp_state_values(P, d, n_res) + scratch) * itemsize
            if need > _MAX_SMEM:
                raise Refused(
                    f"a warp's state and scratch ({need} bytes: (P, D, "
                    f"n_res) = ({P}, {d}, {n_res}), {scratch} values of "
                    f"scratch) exceed a block's shared memory ({_MAX_SMEM} "
                    "bytes)")
        source = (_HEADER.format(
            fn=getattr(residual_fn, "__qualname__", "residual"),
            dtype=str(dtype).replace("torch.", ""), P=P, d=d, n_res=n_res,
            q=q_len, leaves=f" (leaves {leaf_text[2:]})" if shapes else "",
            manifold=str(spec.has_manifold).lower(), warp=str(warp).lower(),
            scratch=scratch)
            + "\n".join(parts) + _FOOTER.format(ct=ct, entries=entries))
        return GeneratedFamily(
            p=P, d=d, n_res=n_res, data_treedef=dtree, data_shapes=shapes,
            q=q_len, dtype=dtype, source=source,
            hash=hashlib.sha256(source.encode()).hexdigest()[:16], ops=ops,
            warp=warp, scratch=scratch, batch=batch, _emit=emit)

    return emit(BATCH)


def generated_family(residual_fn, x_example, data_example=None, dtype=None
                     ) -> tuple[GeneratedFamily | None, str]:
    """The generated K2 family of ``residual_fn`` at one instance's example
    (``x_example``, ``data_example``), or ``None`` and the reason the
    residual lies outside the generated envelope (a module docstring).
    ``dtype``: the solver's (the parameters' by default).  Traced anew at
    every call, so the residual's closed-over values are the ones it holds
    when the solver is built; an unchanged residual emits the same source,
    whose library ``_build`` keeps under its hash."""
    if dtype is None:
        leaves = pytree.tree_leaves(x_example)
        dtype = leaves[0].dtype if leaves and isinstance(
            leaves[0], torch.Tensor) else None
    try:
        return _make(residual_fn, x_example, data_example, dtype), ""
    except Refused as e:
        return None, str(e)
