"""K2 — the whole-solve CUDA kernel (``csrc/solver.cu``), its plain twin
and the fused path's envelope.

Counterpart of ``tinyopt_tpu/ops/pallas_solver.py`` (``_solver_kernel``,
``fused_batched_solver``, ``fused_supported``).  The fused path runs the
``carry_system=False`` + CG semantics of the optimizer loop with the
normal matrix never built: g = Jᵀr by one vjp, diag(JᵀJ) by jvps, the
damped step by Jacobi-PCG applying H as Jᵀ(J p) — or in closed form when
the coloring proves H diagonal — for GN, LM and the Powell dogleg, with
the per-iteration history when ``save_history`` asks for it.  J is the
tangent Jacobian of δ ↦ r(x ⊞ δ) at δ = 0, and an accepted step is
applied through the same retraction (the JAX kernel's ``ret_flat``): the
parameters are flat (B, P), the steps and gradients (B, D), P ≠ D on a
manifold (7 and 6 for an SE3 pose).

:func:`fused_solve` dispatches by device.  On the CPU it runs
:func:`fused_solve_plain`, a batch-native torch version of the same
algorithm with the kernel's op order, differentiating ANY residual with
``torch.func``.  On a CUDA device it launches K2, which has no automatic
differentiation: the residual has a hand-written family, which the module
defining it registers (:func:`register_family`; the models'
prior_residual, jennrich_sampson_residuals, powell_singular_residuals,
wood_residuals and se3_residual, the last on an SE3 pose, whose family
holds the retraction too), or else a family generated from its trace
(``ops/residual_codegen.py``: tensors and registered manifold leaves,
the ops of its table; the retraction traced with the residual), which K2
runs from a library built for it (:func:`k2_envelope`): one instance a
thread up to max(P, D, n_res) = 64, one instance a warp past it, in the
warp kernel, whose state and the family's scratch must fit a block's
shared memory.  diag(JᵀJ) comes from the coloring the
example's Jacobian structure admits (ops/coloring.py): one jvp of the
all-ones probe for the identity, one jvp a color and the recovery sum for
Curtis–Powell–Reid probes (Powell's and Wood's 2 colors), else one jvp a
tangent dimension; one color makes the step closed form.  It never falls
back: a configuration the kernel does not cover raises, and
:func:`fused_plan` (behind :func:`fused_supported`) decides before any
launch.  Which of K2's two kernels runs, and how, is decided here from the
shapes alone (:func:`k2_launch_plan`), so the CPU tests check every choice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from .. import manifold as mf
from ..cost import Cost
from ..diff.auto import instance_residuals, num_residuals
from ..options import Options, SolverType
from ..output import Output
from ..solvers.lm import lm_bad_step, lm_good_step, lm_init, tr_bad_step
from ..solvers.step import dogleg_core
from ..stop_reasons import StopReason
from ..utils import float_epsilon, where_tree
from .coloring import DiagColoring, detect_diag_coloring
from .linalg import jacobi_inverse, pcg_core
from .residual_codegen import GeneratedFamily, generated_family

_I32 = torch.int32


class Family(NamedTuple):
    """A residual function's hand-written device family in csrc/solver.cuh:
    its id in ``enum Family`` there, and ``accepts(x_example, spec,
    data_example)``, whether the family takes such an instance (``None``:
    every instance)."""
    id: int
    accepts: Callable | None = None


#: Residual functions with a hand-written device family, filled by
#: :func:`register_family` from the modules that define them.
FAMILIES: dict = {}
#: The SE3 family's parameter and tangent widths (one pose).
SE3_P, SE3_D = 7, 6

#: Shared memory a block of K2 may use (227 KB, opted in): the budget of
#: one warp's instance in the warp kernel (2·P + 12·D + 2·n_res values,
#: :func:`warp_values`, and a generated family's scratch) and of a
#: multi-color coloring's tables in the register kernel
#: (:func:`k2_table_bytes`; the warp kernel reads them from device
#: memory).
_MAX_SMEM = 232448
#: Shared memory a block may use without opting in (csrc/common.cuh).
_DEFAULT_SMEM = 48 * 1024
#: K2's register kernel covers max(d, n_res) up to this.
SEG_MAX = 64
#: K2's residual families (``enum Family``, csrc/solver.cuh); 5 is
#: ``kGenerated``, a family generated from a traced residual.
FAMILY_IDS = (0, 1, 2, 3, 4, 5)
GENERATED = 5
#: Points a lane of the SE3 family's register kernel serves, by itemsize
#: (csrc/solver_se3.cuh, ``se3_points``): a segment is the least power of
#: two of lanes, from 1, that holds the K points, and each of its lanes
#: holds the whole pose-side state.
SE3_POINTS = {4: 4, 8: 8}
#: Entries of each vector a lane of the register kernel holds, by family
#: (``kSegE`` of the family in csrc/solver.cuh): a segment is the least
#: power of two of lanes, 2 to 32, that holds max(d, n_res) — or one lane,
#: one instance a thread, for a family of fixed shape (``FIXED_SHAPES``,
#: whose E holds all of max(d, n_res); csrc/solver_seg.cuh's
#: ``min_segment``).  The SE3 family's E is ``SE3_POINTS``.
SEG_E = {0: 4, 1: 2, 3: 4, 4: 6}
#: The colorings K2 is built for, by family (the ``launch_segment``
#: dispatch in csrc/solver_seg.cuh, ``launch_solver`` in csrc/solver.cu,
#: a generated family's library): "identity" (one probe, closed form),
#: "multi" (Curtis–Powell–Reid probes) or ``None`` (a jvp a dimension,
#: PCG).  Both kernels take every coloring of a family's.
SEG_COLORINGS = {0: (None, "identity"), 1: (None,), 2: (None,),
                 3: (None, "multi"), 4: (None, "multi"),
                 5: (None, "identity", "multi")}
#: (d, n_res) of the families of fixed shape: Powell's and Wood's.  A
#: generated family's shape is fixed too, but by its trace: it runs one
#: instance a thread at max(P, D, n_res) ≤ 64 (E = max(P, D, n_res)), one
#: instance a warp past it.
FIXED_SHAPES = {3: (4, 4), 4: (4, 6)}
#: ``SolverParams.coloring`` (``enum Coloring``, csrc/solver.cuh).
COLORING_CODES = {None: 0, "identity": 1, "multi": 2}
#: Warps a block of the register kernel; one where an instance runs on
#: one lane, so that 10,000 instances make 313 blocks over all 132 SMs of
#: an H100 (4 warps a block would leave 53 of them idle).
SEG_WARPS = 4
#: The entry point's path codes (``enum Path``, csrc/solver.cuh).
PATH_CODES = {"warp": 0, "segment": 1}
#: ``SolverParams.solver`` (``enum Solver``, csrc/solver.cuh).
SOLVER_CODES = {SolverType.GAUSS_NEWTON: 0, SolverType.LEVENBERG_MARQUARDT: 1,
                SolverType.DOGLEG: 2}


class FusedPlan(NamedTuple):
    """What the fused path fixes when it is built: the parameter layout,
    the residual count and the diag(JᵀJ) coloring of the example, and on
    the card a residual without a hand-written family its generated one."""
    spec: mf.TangentSpec
    n_res: int
    coloring: DiagColoring | None
    generated: GeneratedFamily | None = None


def coloring_kind(coloring: DiagColoring | None) -> str | None:
    """K2's name of a coloring: "identity", "multi" (any other coloring,
    one color included) or ``None``."""
    if coloring is None:
        return None
    return "identity" if coloring.identity else "multi"


def warp_values(P: int, d: int, n_res: int) -> int:
    """Values of shared memory a warp of K2's warp kernel holds for one
    instance: x and best_x (P each), twelve tangent vectors (D each) and
    two residual vectors."""
    return 2 * P + 12 * d + 2 * n_res


def warp_state_values(P: int, d: int, n_res: int) -> int:
    """Values of a generated family's warp state in K2's warp kernel:
    :func:`warp_values` rounded up to a multiple of 4, so that the
    family's scratch after it (``GeneratedFamily.scratch``) starts 16-byte
    aligned (csrc/solver_warp.cuh, ``warp_stride``)."""
    return -(-warp_values(P, d, n_res) // 4) * 4


def register_family(residual_fn, family: int, accepts=None) -> None:
    """Let K2 solve ``residual_fn`` on the card with its hand-written
    family ``family`` (an id of ``enum Family``, csrc/solver.cuh), on the
    instances for which ``accepts(x_example, spec, data_example)`` holds
    (every instance when ``None``)."""
    if family not in FAMILY_IDS:
        raise ValueError(f"register_family: K2 has no family {family}")
    FAMILIES[residual_fn] = Family(family, accepts)


def k2_envelope(residual_fn, x_example, data_example=None
                ) -> tuple[int | None, GeneratedFamily | None, str]:
    """K2's family for this residual at one instance's example, from the
    example alone (no card needed): (the family id, the generated family or
    ``None``, "") — a hand-written family that accepts the instance first,
    else one generated from the trace (``residual_codegen.
    generated_family``) — or (``None``, ``None``, the reason)."""
    fam = FAMILIES.get(residual_fn)
    if fam is not None:
        spec = mf.tangent_spec(x_example)
        if fam.accepts is not None and not fam.accepts(x_example, spec,
                                                       data_example):
            return None, None, (f"K2 family {fam.id} does not take this "
                                "instance")
        return fam.id, None, ""
    gen, why = generated_family(residual_fn, x_example, data_example)
    if gen is None:
        return None, None, f"no K2 family can be generated: {why}"
    return GENERATED, gen, ""


def k2_table_bytes(n_colors: int, d: int, n_res: int, itemsize: int) -> int:
    """Shared memory a block of K2's register kernel holds for a
    multi-color coloring's tables (``launch_seg_family``,
    csrc/solver_seg.cuh): C·d probe entries and C·n_res·d recovery
    entries."""
    return n_colors * d * (1 + n_res) * itemsize


def k2_refusal(family: int, spec: mf.TangentSpec, n_res: int,
               coloring: DiagColoring | None) -> str:
    """Why K2 cannot run family ``family`` at this layout, residual count
    and coloring on the card, from shapes alone ("" when it can): a shape
    or coloring it is not built for (:func:`k2_supports`), or on the
    register kernel (max(P, D, n_res) ≤ 64) a multi-color coloring whose
    tables exceed a block's shared memory (:func:`k2_table_bytes`; the
    warp kernel reads them from device memory)."""
    kind = coloring_kind(coloring)
    if not k2_supports(family, spec.dims, n_res, kind, spec.params):
        return (f"K2 family {family} is not built for (P, D, n_res) = "
                f"({spec.params}, {spec.dims}, {n_res}) with coloring "
                f"{kind!r}")
    if kind == "multi" and max(spec.params, spec.dims, n_res) <= SEG_MAX:
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        nbytes = k2_table_bytes(coloring.n_colors, spec.dims, n_res,
                                itemsize)
        if nbytes > _MAX_SMEM:
            return (f"a coloring of {coloring.n_colors} colors whose tables "
                    f"({nbytes} bytes) exceed a block's shared memory "
                    f"({_MAX_SMEM} bytes)")
    return ""


def fused_envelope(options: Options, mode: str, x_example,
                   n_res: int | None = None, *, residual_fn,
                   data_example=None) -> tuple[FusedPlan | None, str]:
    """:func:`fused_plan` and the reason it gives ``None`` ("" when it
    plans the configuration)."""
    o = options
    if o.solver_type not in SOLVER_CODES:
        return None, f"solver type {o.solver_type.name}"
    if mode != "residuals":
        return None, f"mode {mode!r}"
    for flag, bad in (("hessian.save_last", o.hessian.save_last),
                      ("hessian.carry_system", o.hessian.carry_system),
                      ("check_final_cost", o.check_final_cost),
                      ("log.enable", o.log.enable),
                      ("max_duration_ms", o.max_duration_ms > 0),
                      ("stop_callback", o.stop_callback is not None
                       or o.stop_callback2 is not None),
                      ("hessian.check_min_H_diag",
                       o.hessian.check_min_H_diag > 0)):
        if bad:
            return None, f"option {flag}"
    leaves = [torch.as_tensor(l) for l in pytree.tree_leaves(x_example)]
    if not leaves or any(not l.is_floating_point() for l in leaves) \
            or any(l.dtype != leaves[0].dtype for l in leaves):
        return None, "parameters that are not tensors of one float dtype"
    device = leaves[0].device.type
    spec = mf.tangent_spec(x_example)
    if spec.dims == 0 or device not in ("cpu", "cuda"):
        return None, f"no tangent dimension or device {device}"
    fam_id, generated = None, None
    if device == "cuda":
        if spec.dtype not in (torch.float32, torch.float64):
            return None, f"parameters of type {spec.dtype}"
        fam_id, generated, why = k2_envelope(residual_fn, x_example,
                                             data_example)
        if fam_id is None:
            return None, why
    if n_res is None:
        n_res = (generated.n_res if generated is not None else
                 num_residuals(residual_fn, x_example, data_example))
    if n_res == 0:
        return None, "no residuals"
    itemsize = torch.empty((), dtype=spec.dtype).element_size()
    # (a generated family's state and scratch: refused when it is traced)
    if device == "cuda" and warp_values(spec.params, spec.dims,
                                        n_res) * itemsize > _MAX_SMEM:
        return None, "an instance larger than a warp's shared memory"
    coloring = None
    if o.hessian.diag_coloring == "auto":
        coloring = detect_diag_coloring(residual_fn, x_example, data_example,
                                        spec, n_res, spec.dims, spec.dtype)
    if device == "cuda":
        why = k2_refusal(fam_id, spec, n_res, coloring)
        if why:
            return None, why
    return FusedPlan(spec, n_res, coloring, generated), ""


def fused_plan(options: Options, mode: str, x_example, n_res: int | None = None,
               *, residual_fn, data_example=None) -> FusedPlan | None:
    """The fused path's plan on the device of ``x_example``, or ``None``
    when the configuration lies outside its envelope
    (:func:`fused_envelope` also says why).

    The envelope is everything ``tinyopt_tpu``'s ``fused_supported``
    requires (residuals mode, GN/LM/DogLeg, carry_system=False, no
    save_last, logging, callbacks, timeout, check_final_cost or min-H-diag
    check, same-dtype float parameters — registered manifold leaves
    included —, a non-empty residual), with any coloring
    ``detect_diag_coloring`` returns.  ``log.print_failure`` is inside it,
    as in the JAX envelope: the fused path prints nothing.  On a CUDA
    device also float32/float64, a K2 family for the residual — a
    registered one (:func:`register_family`) that accepts the instance, or
    one generated from its trace (:func:`k2_envelope`) —, a per-instance
    footprint that fits one warp's shared memory, and a shape and coloring
    K2 is built for whose tables fit a block's shared memory
    (:func:`k2_refusal`).  Decided before any launch: nothing after it
    falls back.
    """
    return fused_envelope(options, mode, x_example, n_res,
                          residual_fn=residual_fn,
                          data_example=data_example)[0]


def fused_supported(options: Options, mode: str, x_example,
                    n_res: int | None = None, *, residual_fn=None,
                    data_example=None) -> bool:
    """Whether the fused whole-solve path covers this configuration on the
    device of ``x_example`` (see :func:`fused_plan`)."""
    return residual_fn is not None and fused_plan(
        options, mode, x_example, n_res, residual_fn=residual_fn,
        data_example=data_example) is not None


class K2Plan(NamedTuple):
    """How K2 runs one call (the plan arguments of ``tinyopt_solver_f32/f64``).

    ``path``: "segment" (``solver_seg_kernel``, csrc/solver_seg.cuh: S lanes
    an instance — one for Powell's and Wood's families and the generated
    ones —, E entries of every vector a lane, all state in registers; for
    the SE3 family ``solver_se3_kernel``, csrc/solver_se3.cuh: S lanes, E
    points a lane, the pose-side state whole in each lane; a persistent
    grid, so the entry point launches at most as many blocks as fit the
    card) or "warp" (``solver_kernel``, csrc/solver_warp.cuh: one warp an
    instance, state — and a generated family's scratch — in
    ``smem_bytes`` of shared memory a block; S = 32).
    ``warps`` a block; ``grid``: the blocks that give every instance a
    segment or a warp of its own."""
    path: str
    S: int
    E: int
    warps: int
    grid: int
    smem_bytes: int


def k2_supports(family: int, d: int, n_res: int, coloring: str | None,
                P: int | None = None) -> bool:
    """Whether K2 is built for ``family`` at these widths with this
    coloring (K2's envelope; arguments as :func:`k2_launch_plan`'s): a
    coloring of the family's (``SEG_COLORINGS``), its shape (``FIXED_SHAPES``;
    Jennrich–Sampson d = 2; SE3 P = 7, D = 6 and 3 residuals a point; P = D
    for a Euclidean family); a generated family (``GENERATED``) at P ≥ D —
    P > D on manifold parameters, whose retraction it holds — and any
    width, on either kernel, with every coloring (the identity with n_res ≥
    d).  Whether a warp's state fits shared memory is the plan's to say
    (:func:`k2_launch_plan`).  An id that is no family of K2's raises."""
    P = d if P is None else P
    if family not in FAMILY_IDS:
        raise ValueError(f"k2_supports: unknown residual family {family}")
    if coloring not in SEG_COLORINGS[family]:
        return False
    if family in FIXED_SHAPES and (d, n_res) != FIXED_SHAPES[family]:
        return False
    if family == 1 and d != 2:
        return False
    if family == 2:
        return (P, d) == (SE3_P, SE3_D) and n_res % 3 == 0
    if family == GENERATED:
        return P >= d and (coloring != "identity" or n_res >= d)
    return P == d


@functools.lru_cache(maxsize=256)
def k2_launch_plan(B: int, d: int, n_res: int, itemsize: int, family: int,
                   coloring: str | None, solver: int = 1,
                   P: int | None = None, scratch: int = 0) -> K2Plan:
    """Pick K2's kernel and geometry from the shapes and the solver alone.

    ``d``: the tangent width D (steps, g); ``P``: the width of the flat
    parameters (``None``: d, Euclidean; 7 for the SE3 family, whose D is
    6); ``family``: an id of ``enum Family``; ``coloring``: "identity" (the
    closed-form step), "multi" (Curtis–Powell–Reid probes) or ``None``
    (per-dim diag sweeps and PCG); ``solver``: a code of ``SOLVER_CODES``.
    Raises for a configuration outside :func:`k2_supports`.
    max(P, D, n_res) ≤ 64 takes the register kernel, E = SEG_E[family]
    entries a lane, on segments of S = the least power of two (2 to 32)
    with S·E ≥ max(P, D, n_res), for every solver, 4 warps a block; a
    family of fixed shape (Powell's, Wood's) runs one instance a thread
    (S = 1, E = max(d, n_res)), one warp a block, and so does a generated
    family (``GENERATED``, every coloring, E = max(P, D, n_res)); the SE3
    family (K ≤ 21
    points) E = ``SE3_POINTS[itemsize]`` points a lane on the least power
    of two of lanes S (from 1) with S·E ≥ K, one warp a block at S = 1,
    else 4.
    Larger shapes take the warp kernel, one warp an instance, with up to 4
    warps a block while their shared memory fits 48 KB: each warp's
    :func:`warp_values`, or for a generated family
    :func:`warp_state_values` and its ``scratch`` (values,
    ``GeneratedFamily.scratch``); a warp past 227 KB raises."""
    P = d if P is None else P
    if itemsize not in (4, 8):
        raise ValueError(f"k2_launch_plan: itemsize {itemsize}")
    if solver not in SOLVER_CODES.values():
        raise ValueError(f"k2_launch_plan: solver code {solver}")
    if not k2_supports(family, d, n_res, coloring, P):
        raise ValueError(f"k2_launch_plan: K2 is not built for family "
                         f"{family} at (P, D, n_res) = ({P}, {d}, {n_res}) "
                         f"with coloring {coloring!r}")
    m = max(P, d, n_res)
    if m <= SEG_MAX:
        if family == 2:
            E, S, m = SE3_POINTS[itemsize], 1, n_res // 3   # E points a lane
        elif family == GENERATED:
            E, S = m, 1
        else:
            E = SEG_E[family]
            S = 1 if family in FIXED_SHAPES else 2
        while S * E < m:
            S *= 2
        per_warp = 32 // S
        warps = max(1, min(1 if S == 1 else SEG_WARPS, -(-B // per_warp)))
        return K2Plan("segment", S, E, warps,
                      max(1, -(-B // (warps * per_warp))), 0)
    per_warp = (warp_state_values(P, d, n_res) + scratch
                if family == GENERATED else warp_values(P, d, n_res)) * itemsize
    if per_warp > _MAX_SMEM:
        raise ValueError(f"k2_launch_plan: a warp's state ({per_warp} bytes)"
                         f" exceeds a block's shared memory ({_MAX_SMEM})")
    warps = 4
    while warps > 1 and warps * per_warp > _DEFAULT_SMEM:
        warps //= 2
    return K2Plan("warp", 32, -(-m // 32), warps, max(1, -(-B // warps)),
                  warps * per_warp)


def k2_params(family: int, opts: Options, plan: FusedPlan):
    """K2's ``SolverParams`` for a solver: everything but the batch size,
    so a solver builds it once.  ``fam_m``: Jennrich–Sampson's residuals,
    the SE3 family's points, a generated family's P (its library checks
    it)."""
    from .. import _build
    lm = opts.lm
    d = plan.spec.dims
    return _build.SolverParams(
        d=d, n_res=plan.n_res, family=family,
        fam_m={1: plan.n_res, 2: plan.n_res // 3,
               GENERATED: plan.spec.params}.get(family, 0),
        solver=SOLVER_CODES[opts.solver_type],
        coloring=COLORING_CODES[coloring_kind(plan.coloring)],
        n_colors=0 if plan.coloring is None else plan.coloring.n_colors,
        max_iters_total=opts.max_iters + 1, cap=history_cap(opts),
        max_consec_failures=opts.max_consec_failures,
        max_total_failures=opts.max_total_failures,
        cg_iters=opts.hessian.cg_iters or d,
        use_quality=int(opts.use_step_quality_approx),
        use_squared_norm=int(opts.cost.use_squared_norm),
        downscale_by_2=int(opts.cost.downscale_by_2),
        normalize=int(opts.cost.normalize),
        min_error=opts.min_error, min_rerr_dec=opts.min_rerr_dec,
        min_step_norm2=opts.min_step_norm2,
        min_grad_norm2=opts.min_grad_norm2,
        damping_init=lm.damping_init, lam_lo=lm.damping_range[0],
        lam_hi=lm.damping_range[1], good_factor=lm.good_factor,
        bad_factor=lm.bad_factor, grad_clipping=opts.grad_clipping)


def color_tables(coloring: DiagColoring, dtype, device):
    """The coloring's probes (C, D) and recovery (C·n_res, D) as tensors
    of the solver's type on ``device``: K2's multi-color inputs and the
    twin's constants."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device).contiguous()
                 for a in (coloring.probes, coloring.recovery))


def history_cap(opts: Options) -> int:
    """Slots of the history rows: one an iteration, ``max_iters`` + 1 (the
    rollback slot; the fused path has no check_final_cost), 0 without
    ``save_history``."""
    return opts.max_iters + 1 if opts.save_history else 0


def fused_solve_plain(residual_fn, opts: Options, x0: torch.Tensor, data,
                      plan: FusedPlan):
    """The plain twin of K2 on flat parameters ``x0`` (B, P).

    Batch-native: per-instance (B,) state, active instances updated by
    selects, the retry loop running while any instance retries — the
    per-instance results of the kernel's one-warp-per-instance loop.  Any
    residual and any registered manifold: it linearizes δ ↦ r(x ⊞ δ) at
    δ = 0 with ``torch.func`` and retracts accepted steps through
    ``plan.spec`` (the JAX kernel's ``ret_flat``)."""
    B = x0.shape[0]
    spec = plan.spec
    d = spec.dims
    dtype, dev = x0.dtype, x0.device
    n_res, coloring = plan.n_res, plan.coloring
    is_dl = opts.solver_type == SolverType.DOGLEG
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    lam_sched = is_lm or is_dl              # λ-scheduled solvers
    bad_step = tr_bad_step if is_dl else lm_bad_step
    mcf, mtf = opts.max_consec_failures, opts.max_total_failures
    max_tries = mcf if mcf > 0 else 255
    cg_iters = opts.hessian.cg_iters or d
    max_iters_total = opts.max_iters + 1        # +1 rollback slot
    cap = history_cap(opts)
    feps = float_epsilon(dtype)
    noise = 8.0 * torch.finfo(dtype).eps
    closed_form = coloring is not None and coloring.n_colors == 1
    if coloring is not None and not coloring.identity:
        probes, recovery = color_tables(coloring, dtype, dev)
    r1 = instance_residuals(residual_fn, spec, data is not None)
    extra = () if data is None else (data,)
    G = torch.func.vmap(
        lambda xv, dv, *dd: r1(mf.retract_flat(xv, dv, spec), *dd))

    def col(v):
        return v[:, None]

    def finite(v):
        return torch.all(torch.isfinite(v), dim=-1)

    def linearize_at(x):
        """(r, jvp_fn, vjp_fn) of δ ↦ r(x ⊞ δ) at δ = 0."""
        zero = torch.zeros((B, d), dtype=dtype, device=dev)

        def Gx(dm):
            return G(x, dm, *extra)
        r, vjp = torch.func.vjp(Gx, zero)
        return (r, lambda p: torch.func.jvp(Gx, (zero,), (p,))[1],
                lambda q: vjp(q)[0])

    def accumulate(r, jvp_fn, vjp_fn):
        g = vjp_fn(r)
        if coloring is not None and coloring.identity:
            Jp = jvp_fn(torch.ones((B, d), dtype=dtype, device=dev))
            diagH = (Jp * Jp)[:, :d]
        elif coloring is not None:
            # Curtis-Powell-Reid: one jvp of each color's probe row, the
            # squares, then diag_j = sum over the recovery's rows, in
            # ascending order, of sq_row * recovery[row, j] (the JAX
            # kernel's one exact contraction, written out as the kernel
            # adds it)
            diagH = torch.zeros((B, d), dtype=dtype, device=dev)
            for c in range(coloring.n_colors):
                Jp = jvp_fn(probes[c:c + 1].expand(B, d))
                sq = Jp * Jp
                for i in range(n_res):
                    diagH = diagH + sq[:, i:i + 1] * recovery[c * n_res + i]
        else:
            diagH = torch.zeros((B, d), dtype=dtype, device=dev)
            for j in range(d):
                e_j = torch.zeros((1, d), dtype=dtype, device=dev)
                e_j[0, j] = 1.0
                Jej = jvp_fn(e_j.expand(B, d))
                diagH = diagH + col(torch.sum(Jej * Jej, dim=-1)) * e_j
        err = torch.sum(r * r, dim=-1)
        if not opts.cost.use_squared_norm:
            err = torch.sqrt(err)
        if opts.cost.downscale_by_2:
            err = 0.5 * err
        if opts.cost.normalize:
            err = err / max(n_res, 1)
        if opts.grad_clipping > 0:
            g = torch.clamp(g, -opts.grad_clipping, opts.grad_clipping)
        return diagH, g, err

    def solve(jvp_fn, vjp_fn, diagH, g, dampl):
        """(H + diag(dampl)) dx = −g: closed form when the coloring has
        one color, else Jacobi-PCG through Jᵀ(J p)."""
        dinv = jacobi_inverse(diagH + dampl)
        if closed_form:
            # one color: H = JᵀJ diagonal, the closed-form damped step
            return -g * dinv
        return pcg_core(lambda p: vjp_fn(jvp_fn(p)) + dampl * p, dinv, -g,
                        cg_iters)

    def damping(diagH):
        return torch.where(diagH == 0, torch.ones_like(diagH), diagH)

    def propose_dogleg(jvp_fn, vjp_fn, diagH, g, lam):
        """The JAX kernel's rowwise dogleg (pallas_solver.py:361-445): the
        GN step, gᵀHg by one more Jᵀ(J g), then ``dogleg_core``, whose
        damped solves run when any instance needs them."""
        dx_gn = solve(jvp_fn, vjp_fn, diagH, g, torch.zeros_like(diagH))
        gHg = torch.sum(g * vjp_fn(jvp_fn(g)), dim=-1)
        damp = damping(diagH)

        def solve_reg(lam_eff):
            dx = solve(jvp_fn, vjp_fn, diagH, g, damp * col(lam_eff))
            return dx, finite(dx)

        return dogleg_core(g, lam, dx_gn, finite(dx_gn), gHg, solve_reg)

    def propose(jvp_fn, vjp_fn, diagH, g, lam):
        """Damped (LM) or undamped (GN) step, or the dogleg."""
        if is_dl:
            return propose_dogleg(jvp_fn, vjp_fn, diagH, g, lam)
        dampl = (damping(diagH) * col(lam) if is_lm
                 else torch.zeros_like(diagH))
        dx = solve(jvp_fn, vjp_fn, diagH, g, dampl)
        return dx, finite(dx)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    codes = {c: torch.tensor(int(c), dtype=_I32, device=dev)
             for c in StopReason}
    code = codes.__getitem__

    x, best_x = x0.clone(), x0.clone()
    best_cost, final_rerr = full(float("inf")), full(float("inf"))
    lm = lm_init(opts, dtype, B, dev)
    last_dx = torch.zeros((B, d), dtype=dtype, device=dev)
    g_out = torch.zeros_like(last_dx)
    has_last = full(False, torch.bool)
    it, nfail, nconsec, stop, best_nres = (full(0, _I32) for _ in range(5))
    errs = torch.zeros((B, cap), dtype=dtype, device=dev)
    deltas2 = torch.zeros_like(errs)
    succ = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    num_hist = full(0, _I32)
    slots = torch.arange(cap, device=dev)

    while True:
        act = (stop == int(StopReason.NONE)) & (it < max_iters_total)
        if not bool(act.any()):
            break
        r_lin, jvp_fn, vjp_fn = linearize_at(x)
        diagH, g, err = accumulate(r_lin, jvp_fn, vjp_fn)

        # --- propose, retry with λ escalation (optimizer.h:356-399) ---
        dx = torch.zeros_like(g)
        ok, give_up = full(False, torch.bool), full(False, torch.bool)
        lm_t, nf, nc = lm, nfail, nconsec
        while True:
            upd = act & (~ok) & (~give_up) & (nc <= max_tries)
            if not bool(upd.any()):
                break
            dx_new, ok_new = propose(jvp_fn, vjp_fn, diagH, g, lm_t.lam)
            failed = (upd & ~ok_new).to(_I32)
            nf2, nc2 = nf + failed, nc + failed
            gu_new = (~ok_new) & (mcf > 0) & (nc2 >= mcf)
            if lam_sched:
                lm_t = where_tree(upd & (~ok_new) & (~gu_new),
                                   bad_step(lm_t, opts), lm_t)
            dx = torch.where(col(upd & ok_new), dx_new, dx)
            ok = torch.where(upd, ok_new, ok)
            nf = torch.where(upd, nf2, nf)
            nc = torch.where(upd, nc2, nc)
            give_up = torch.where(upd, give_up | gu_new, give_up)
        solved = ok

        # --- early failure routing ---
        err_bad = (~torch.isfinite(err)) | ~finite(g)
        stop_early = torch.where(
            err_bad, code(StopReason.SYSTEM_HAS_NAN_OR_INF),
            torch.where(solved, code(StopReason.NONE),
                        code(StopReason.SOLVER_FAILED)))
        dx_norm2 = torch.sum(dx * dx, dim=-1)
        stop_early = torch.where((stop_early == 0) & ~torch.isfinite(dx_norm2),
                                 code(StopReason.SYSTEM_HAS_NAN_OR_INF),
                                 stop_early)
        early_fail = stop_early != 0

        # --- accept / reject (optimizer.h:427-459) ---
        is_good = (err - best_cost) < 0
        rel_derr = torch.where((best_cost > feps) & torch.isfinite(best_cost),
                               (best_cost - err) / best_cost,
                               torch.zeros_like(err))
        first_eval = ~torch.isfinite(best_cost)
        good = is_good | first_eval
        if lam_sched:
            # DogLeg ignores the step quality (a trust radius grows on
            # every accepted step)
            quality = (rel_derr if opts.use_step_quality_approx and not is_dl
                       else torch.zeros_like(err))
            apply_good = act & (~early_fail) & good & (~first_eval)
            apply_bad = act & (~early_fail) & (~good)
            lm_t = where_tree(
                apply_good, lm_good_step(lm_t, quality, opts),
                where_tree(apply_bad, bad_step(lm_t, opts), lm_t))
        accepted = (~early_fail) & good
        rejected = (~early_fail) & (~good)
        rej = rejected.to(_I32)
        nconsec_n = torch.where(accepted, torch.zeros_like(nc), nc + rej)
        nfail_n = nf + rej
        budget_stop = torch.where(
            rejected & (mcf > 0) & (nconsec_n >= mcf),
            code(StopReason.MAX_CONSEC_NO_DECR),
            torch.where(rejected & (mtf > 0) & (nfail_n >= mtf),
                        code(StopReason.MAX_NO_DECR), code(StopReason.NONE)))
        budget_fail = (stop_early == 0) & (budget_stop != 0)

        # --- stop cascade: first match in MIN_ERROR..MIN_GRAD_NORM order ---
        grad_norm2 = torch.sum(g * g, dim=-1)
        cascade = torch.zeros_like(stop)
        for enabled, pred, c in (
                (opts.min_error > 0, lambda: err < opts.min_error,
                 StopReason.MIN_ERROR),
                (opts.min_rerr_dec > 0,
                 lambda: (rel_derr > noise) & (rel_derr < opts.min_rerr_dec),
                 StopReason.MIN_REL_ERROR),
                (opts.min_step_norm2 > 0,
                 lambda: dx_norm2 < opts.min_step_norm2,
                 StopReason.MIN_DELTA_NORM),
                (opts.min_grad_norm2 > 0,
                 lambda: grad_norm2 < opts.min_grad_norm2,
                 StopReason.MIN_GRAD_NORM)):
            if enabled:
                cascade = torch.where((cascade == 0) & pred(), code(c),
                                      cascade)
        stop_n = torch.where(stop_early != 0, stop_early,
                             torch.where(budget_stop != 0, budget_stop,
                                         cascade))

        # --- history: slot `it` of an active instance that did not fail
        # early; succ records is_good, not the auto-accepted `good` ---
        if cap:
            rec = act & (~early_fail)
            at = col(rec) & (slots[None, :] == col(it))
            errs = torch.where(at, col(err), errs)
            deltas2 = torch.where(at, col(dx_norm2), deltas2)
            succ = torch.where(at, col(is_good), succ)
            num_hist = torch.where(rec, it + 1, num_hist)

        # --- apply / rollback / probe (optimizer.h:266-299) ---
        returned_dx = (~early_fail) & (~budget_fail)
        success = act & accepted & returned_dx
        fail = ~success
        probe = act & fail & (~has_last) & returned_dx
        roll = act & fail & has_last
        x_base = torch.where(col(roll), best_x, x)
        applied = torch.where(col((success | probe) & (cascade == 0)
                                  & (it + 1 < max_iters_total)),
                              dx, torch.zeros_like(dx))
        x_new = mf.retract_flat(x_base, applied, spec)
        best_x = torch.where(col(success), x, best_x)
        last_dx = torch.where(col(success | probe), dx, last_dx)
        has_last_n = torch.where(success, torch.ones_like(has_last),
                                 torch.where(has_last,
                                             torch.zeros_like(has_last),
                                             probe))
        x = x_new
        best_cost = torch.where(act & accepted, err, best_cost)
        best_nres = torch.where(act & accepted, full(n_res, _I32), best_nres)
        final_rerr = torch.where(act & accepted, rel_derr, final_rerr)
        lm = where_tree(act, lm_t, lm)
        has_last = torch.where(act, has_last_n, has_last)
        it = torch.where(act, it + 1, it)
        nfail = torch.where(act, nfail_n, nfail)
        nconsec = torch.where(act, nconsec_n, nconsec)
        stop = torch.where(act, stop_n, stop)
        g_out = torch.where(col(act), g, g_out)

    stop = torch.where(stop == int(StopReason.NONE),
                       code(StopReason.MAX_ITERS), stop)
    return x, Output(
        final_cost=Cost(cost=best_cost, num_residuals=best_nres,
                        inlier_ratio=torch.ones((B,), dtype=torch.float32,
                                                device=dev)),
        final_rerr_dec=final_rerr, stop_reason=stop, num_iters=it,
        num_failures=nfail, num_consec_failures=nconsec,
        duration_ms=torch.zeros((B,), dtype=torch.float32, device=dev),
        final_grad=g_out, final_hessian=None, errs=errs, deltas2=deltas2,
        successes=succ, num_hist=num_hist, final_lambda=lm.lam)


def se3_gram_plain(points: torch.Tensor, q: torch.Tensor | None = None):
    """H = JᵀJ (..., 6, 6) of the SE3 family's residual r_k = R p_k + t −
    q̂_k at a pose, for points (..., K, 3), where J_k = R [I, −[p_k]×] is
    the tangent Jacobian through the right retraction (tangent ρ, ω).

    With ``q`` ``None``, RᵀR = I and H is what K2's SE3 kernel builds
    once an instance (csrc/solver_se3.cuh): [[K·I, −[c]×], [[c]×, tr(M)·I
    − M]], c = Σ p_k, M = Σ p_k p_kᵀ, formed as the kernel forms it, Aᵀ
    diag(K·I, tr(C)·I − C) A with the centroid c̄ = c / K, the centred
    scatter C = Σ (p_k − c̄)(p_k − c̄)ᵀ and A = [[I, −[c̄]×], [0, I]].
    With a quaternion ``q`` (..., 4),
    wxyz, H = Σ A_kᵀ RᵀR A_k, A_k = [I, −[p_k]×], R = R(q) as SO3.matrix
    builds it: the same sum where the stored quaternion is off unit norm.
    A plain version for the tests."""
    K = points.shape[-2]
    eye = torch.eye(3, dtype=points.dtype, device=points.device)

    def skew(v):
        z = torch.zeros_like(v[..., 0])
        return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                            torch.stack([v[..., 2], z, -v[..., 0]], -1),
                            torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)

    if q is None:
        cb = points.mean(-2)
        e = points - cb[..., None, :]
        C = torch.einsum("...ki,...kj->...ij", e, e)
        tr = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)
        # Aᵀ diag(K·I, tr(C)·I − C) A block by block, symmetric as formed
        n2 = (cb * cb).sum(-1)
        ww = K * (n2[..., None, None] * eye
                  - cb[..., :, None] * cb[..., None, :])
        top = torch.cat([K * eye.expand(C.shape), -K * skew(cb)], -1)
        bot = torch.cat([K * skew(cb), ww + (tr[..., None, None] * eye - C)],
                        -1)
        return torch.cat([top, bot], -2)
    from ..manifolds import SO3
    R = SO3(q).matrix()
    A = torch.cat([eye.expand(points.shape[:-1] + (3, 3)), -skew(points)],
                  -1)
    return torch.einsum("...kia,...ij,...kjb->...ab", A,
                        R.transpose(-1, -2) @ R, A)


def _kernel_outputs(B: int, P: int, d: int, cap: int, dtype, dev,
                    zero_history: bool = False):
    """Every tensor K2 writes, as disjoint views of two new buffers: one of
    the solver's type (x (B, P) and g (B, D), then cost, rerr, λ, then the
    (B, cap) history rows errs and deltas2) and one of int32 (six
    counters, then the float32 inlier ratio and duration in the next 2·B
    entries, then the (B, cap) bool successes in the bytes after them).
    The kernel writes every entry, history slots past ``num_hist`` as 0 /
    False — unless ``zero_history``: the one-lane instances (S = 1) of
    ``solver_seg_kernel`` write only the slots they fill, and the rows are
    zeroed here, one coalesced memset each buffer.  Returns (x, Output, the SolverIO output
    pointers)."""
    f = torch.empty(B * (P + d + 3 + 2 * cap), dtype=dtype, device=dev)
    i = torch.empty(8 * B + -(-B * cap // 4), dtype=_I32, device=dev)
    if zero_history and cap:
        f[B * (P + d + 3):].zero_()
        i[8 * B:].zero_()
    x = f[:B * P].view(B, P)
    g = f[B * P:B * (P + d)].view(B, d)
    cost, rerr, lam = f[B * (P + d):B * (P + d + 3)].view(3, B)
    errs, deltas2 = f[B * (P + d + 3):].view(2, B, cap)
    stop, it, nfail, nconsec, nres, nhist = i[:6 * B].view(6, B)
    inlier, duration = i[6 * B:8 * B].view(torch.float32).view(2, B)
    succ = i[8 * B:].view(torch.uint8)[:B * cap].view(torch.bool).view(B, cap)
    out = Output(
        final_cost=Cost(cost=cost, num_residuals=nres, inlier_ratio=inlier),
        final_rerr_dec=rerr, stop_reason=stop, num_iters=it,
        num_failures=nfail, num_consec_failures=nconsec,
        duration_ms=duration, final_grad=g, final_hessian=None,
        errs=errs, deltas2=deltas2, successes=succ, num_hist=nhist,
        final_lambda=lam)
    ptrs = dict(x=x, cost=cost, rerr=rerr, lam=lam, g=g, stop=stop,
                iters=it, nfail=nfail, nconsec=nconsec, nres=nres,
                nhist=nhist, inlier=inlier, duration=duration, errs=errs,
                deltas2=deltas2, succ=succ)
    return x, out, {k: v.data_ptr() for k, v in ptrs.items()}


def _family_data(family: int, data, B: int, P: int, dtype, dev,
                 generated: GeneratedFamily | None = None) -> tuple:
    """K2's data tensors of a family, from the batch's data: the prior's y
    and inv_std (B, d); the SE3 family's points and targets (B, K, 3); a
    generated family's data leaves packed into one (B, Q) row an instance
    (none without data); none for Jennrich-Sampson, Powell and Wood."""
    if family == GENERATED:
        packed = generated.pack_data(data, B, dtype, dev)
        return () if packed is None else (packed,)
    if family in (1, 3, 4):
        if data is not None:
            raise ValueError(f"K2 family {family}: x is (B, d), no data")
        return ()
    if family == 0:
        ts = tuple(t.to(dtype).contiguous() for t in (data.y, data.inv_std))
        want = (B, P)
    else:
        ts = tuple(t.to(dtype).contiguous()
                   for t in (data.points, data.targets))
        want = (B, ts[0].shape[1] if ts[0].dim() == 3 else -1, 3)
    for t in ts:
        if tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"K2 family {family}: data must be {want} on "
                             f"{dev}; got {tuple(t.shape)} on {t.device}")
    return ts


def generated_instance(generated: GeneratedFamily, dtype, dogleg: bool,
                       hist: bool, coloring: str | None):
    """``_build.GenInstance`` of a generated family's K2 instance: type,
    dogleg, history, coloring, and the path of its widths (the warp kernel
    past max(P, D, n_res) = 64, as :func:`k2_launch_plan` plans it)."""
    from .. import _build
    wide = max(generated.p, generated.d, generated.n_res) > SEG_MAX
    return _build.GenInstance(
        "float" if dtype == torch.float32 else "double", dogleg, hist,
        COLORING_CODES[coloring], _build.GEN_WARP if wide
        else _build.GEN_SEGMENT)


@functools.lru_cache(maxsize=64)
def generated_library(generated: GeneratedFamily, dtype, dogleg: bool,
                      hist: bool, coloring: str | None):
    """The library of a generated family's K2 instance
    (:func:`generated_instance`), built at its first use (``_build.
    generated_library``) and kept for the process."""
    from .. import _build
    return _build.generated_library(generated, generated_instance(
        generated, dtype, dogleg, hist, coloring))


def fused_solve_cuda(family: int, opts: Options, x0: torch.Tensor, data,
                     plan: FusedPlan, params=None, tables=None):
    """Launch K2 on flat parameters ``x0`` (B, P), a CUDA tensor, as
    :func:`k2_launch_plan` of the shapes says.  ``params``: the solver's
    :func:`k2_params`; ``tables``: a multi-color plan's
    :func:`color_tables` on the device (each built here when not given).
    A generated family (``GENERATED``, ``plan.generated``) launches from
    its own library (:func:`generated_library`), emitted for the batch
    (``GeneratedFamily.at_batch``: below ``residual_codegen.BATCH`` torch
    sums the twin's tensors in another geometry)."""
    from .. import _build

    if x0.dtype not in (torch.float32, torch.float64) or x0.dim() != 2:
        raise ValueError(f"K2: unsupported x0 {x0.dtype} {tuple(x0.shape)}")
    kind = coloring_kind(plan.coloring)
    B, P = x0.shape
    d = plan.spec.dims
    dtype, dev = x0.dtype, x0.device
    if P != plan.spec.params:
        raise ValueError(f"K2: x0 is (B, {P}), the plan's parameters "
                         f"(B, {plan.spec.params})")
    if (family == GENERATED) != (plan.generated is not None):
        raise ValueError("K2: the generated family is the plan's own")
    if params is None:
        params = k2_params(family, opts, plan)
    kp = k2_launch_plan(B, d, plan.n_res, x0.element_size(), family, kind,
                        params.solver, P, 0 if plan.generated is None
                        else plan.generated.scratch)
    table_ptrs = (None, None)
    if kind == "multi":
        if tables is None:
            tables = color_tables(plan.coloring, dtype, dev)
        C, n = plan.coloring.n_colors, plan.n_res
        if any(t.dtype != dtype or t.device != dev or not t.is_contiguous()
               for t in tables) or tuple(tables[0].shape) != (C, d) \
                or tuple(tables[1].shape) != (C * n, d):
            raise ValueError(f"K2: color tables must be ({C}, {d}) and "
                             f"({C * n}, {d}) {dtype} on {dev}")
        table_ptrs = tuple(t.data_ptr() for t in tables)
    x0 = x0.contiguous()
    data_ts = _family_data(family, data, B, P, dtype, dev, plan.generated)
    data_ptrs = [t.data_ptr() for t in data_ts] + [None] * (2 - len(data_ts))
    if params.d != d or params.family != family:
        raise ValueError(f"K2: parameters for d = {params.d}, family "
                         f"{params.family}; got d = {d}, family {family}")
    se3 = family == 2 and kp.path == "segment"
    x_out, out, ptrs = _kernel_outputs(B, P, d, params.cap, dtype, dev,
                                       zero_history=kp.S == 1 and not se3)
    io = _build.SolverIO(x0=x0.data_ptr(), data0=data_ptrs[0],
                         data1=data_ptrs[1], **ptrs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if family == GENERATED:
        gen = plan.generated.at_batch(B)
        lib = generated_library(gen, dtype,
                                params.solver == SOLVER_CODES[SolverType.DOGLEG],
                                params.cap > 0, kind)
        with torch.cuda.device(dev):
            err = lib.tinyopt_gen_solver(ctypes.byref(params), ctypes.byref(io),
                                         *table_ptrs, B, kp.S, kp.E, kp.warps,
                                         kp.grid, kp.smem_bytes, stream)
        _build.check(err, f"K2 solver kernel (generated family {gen.hash})",
                     lib)
        fused_solve.launches += 1
        fused_solve.generated_launches += 1
        if kp.path == "warp":
            fused_solve.warp_launches += 1
        return x_out, out
    lib = _build.load()
    fn = lib.tinyopt_solver_f32 if dtype == torch.float32 \
        else lib.tinyopt_solver_f64
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(params), ctypes.byref(io), *table_ptrs, B,
                 PATH_CODES[kp.path], kp.S, kp.E, kp.warps, kp.grid,
                 kp.smem_bytes, stream)
    _build.check(err, "K2 solver kernel")
    fused_solve.launches += 1
    if se3:
        fused_solve.se3_launches += 1
    elif kp.S == 1:
        fused_solve.lane_launches += 1
    if kp.path == "warp":
        fused_solve.warp_launches += 1
    return x_out, out


def fused_solve(residual_fn, opts: Options, x0: torch.Tensor, data,
                plan: FusedPlan, params=None, tables=None):
    """The fused whole solve on flat ``x0`` (B, P): the plain twin for a
    CPU tensor, K2 for a CUDA tensor (counted in ``fused_solve.launches``;
    ``params``: the solver's :func:`k2_params`, ``tables``: its
    :func:`color_tables`, else each built for the call) — the residual's
    hand-written family, or the plan's generated one."""
    if x0.device.type == "cpu":
        return fused_solve_plain(residual_fn, opts, x0, data, plan)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_solve: no kernel for device {x0.device}")
    if plan.generated is not None:
        return fused_solve_cuda(GENERATED, opts, x0, data, plan, params,
                                tables)
    if residual_fn not in FAMILIES:
        raise ValueError(
            "fused_solve: K2 has no device family for this residual "
            "function (register_family, or a generated one in the plan); "
            "check fused_plan first")
    return fused_solve_cuda(FAMILIES[residual_fn].id, opts, x0, data, plan,
                            params, tables)


#: Number of K2 launches in this process, and of those the one-lane
#: instances' (S = 1: Powell's and Wood's families), the generated
#: families' (from their own libraries, on either kernel), the SE3
#: family's register kernel's (``solver_se3_kernel``) and the warp
#: kernel's (``solver_kernel``, max(P, d, n_res) > 64, a generated family's
#: included); reset freely by callers.
fused_solve.launches = 0
fused_solve.lane_launches = 0
fused_solve.generated_launches = 0
fused_solve.se3_launches = 0
fused_solve.warp_launches = 0


def fused_batched_solver(residual_fn, options: Options, x_example,
                         data_example=None, *, plan: FusedPlan | None = None):
    """Build ``solve(x0_batch[, data_batch]) -> (x_opt_batch, Output)`` for
    the fused path; raises outside its envelope (:func:`fused_plan`)."""
    if plan is None:
        plan, why = fused_envelope(options, "residuals", x_example,
                                   residual_fn=residual_fn,
                                   data_example=data_example)
        if plan is None:
            raise ValueError(
                "fused_batched_solver: configuration not supported (see "
                "fused_plan: residuals mode, GN/LM/DogLeg, carry_system="
                "False, no save_last/logging/callbacks; on CUDA a registered"
                " or a generated residual family built for the coloring): "
                + why)

    family = (GENERATED if plan.generated is not None
              else getattr(FAMILIES.get(residual_fn), "id", None))
    params = None if family is None else k2_params(family, options, plan)
    # a multi-color plan's tables, uploaded once a solver
    tables = None
    leaf = pytree.tree_leaves(x_example)[0]
    if coloring_kind(plan.coloring) == "multi" and leaf.device.type == "cuda":
        tables = color_tables(plan.coloring, plan.spec.dtype, leaf.device)
    if plan.generated is not None:
        # the family's library, built at the solver's first use
        generated_library(plan.generated, plan.spec.dtype,
                          options.solver_type == SolverType.DOGLEG,
                          options.save_history, coloring_kind(plan.coloring))

    def solve(x0_batch, data_batch=None):
        x0 = mf.flatten_batch(x0_batch, plan.spec)
        x, out = fused_solve(residual_fn, options, x0, data_batch, plan,
                             params, tables)
        return mf.unflatten(x, plan.spec), out

    return solve
