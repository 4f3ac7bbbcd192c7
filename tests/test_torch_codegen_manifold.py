"""K2's generated families on manifold parameters
(``ops/residual_codegen.py``): the emitted residual, the jvp and vjp of
δ ↦ r(x ⊞ δ) at 0 and the retraction of ``chip_smoke.py`` phase 22's
residuals (``tests/torch_manifold_cases.py``: SO3, SE3, SE23 and SEn3
leaves, a batched SO3 leaf, a {SE3, bias} pytree and the point-to-point
ICP residual with and without Huber whitening), compiled by g++ and held
to ``torch.func`` and ``manifold.retract_flat``; the refusals at the
envelope's edges; K2's plan at P ≠ D; and, on the card (``cuda``),
generated K2 on manifold parameters against its twin.

Tolerances are tests/test_torch_codegen.py's: float64 to 1e-12 relative to
the largest value, float32 to 1e-5 (the host's libm and ascending sums).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu_torch as to
import torch_manifold_cases as cases
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.diff.auto import instance_residuals
from tinyopt_tpu_torch.manifolds import SE3, SO3
from tinyopt_tpu_torch.models.se3_refinement import se3_residual
from tinyopt_tpu_torch.ops import cuda_solver, residual_codegen

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _example(x0, data):
    return (pytree.tree_map(lambda a: a[0], x0),
            pytree.tree_map(lambda a: a[0], data))


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """A family's emitted source compiled by g++ into a host library
    (``K2G_HOST_ENTRY``: ``k2g_residual`` / ``k2g_jvp`` / ``k2g_vjp`` /
    ``k2g_retract`` of the traced type), loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emitted C++ on the host")
    root = tmp_path_factory.mktemp("k2gen_manifold")
    built = {}

    def build(family):
        if family.hash not in built:
            d = root / family.hash
            d.mkdir()
            (d / "family.h").write_text(family.source)
            (d / "family.cpp").write_text(
                '#define K2G_HOST_ENTRY\n#include "family.h"\n')
            so = d / "family.so"
            proc = subprocess.run(
                [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(so),
                 str(d / "family.cpp")], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[-4000:]
            built[family.hash] = ctypes.CDLL(str(so))
        return built[family.hash]
    return build


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", cases.NAMES)
def test_emitted_functions_match_torch_func(name, dtype, host_build):
    """The emitted residual, jvp of a seeded tangent, vjp of a seeded
    cotangent and retraction by a seeded step, compiled by g++, against
    ``torch.func`` through ``manifold.retract_flat`` and against
    ``retract_flat`` itself, on the same flat instance; the family's
    widths, its kP and kManifold, and the retraction by 0 is x."""
    fn = cases.residual(name)
    x0, data = cases.inputs(name, 1, 3, dtype=dtype)
    x_ex, d_ex = _example(x0, data)
    fam, why = residual_codegen.generated_family(fn, x_ex, d_ex)
    assert fam is not None, why
    P, D, n_res = cases.WIDTHS[name]
    assert (fam.p, fam.d, fam.n_res, fam.dtype) == (P, D, n_res, dtype)
    assert f"kP = {P}, kD = {D}, kNRes = {n_res}" in fam.source
    assert "kManifold = true" in fam.source
    assert all(v > 0 for v in fam.ops.values())
    lib = host_build(fam)
    spec = mf.tangent_spec(x_ex)
    xv = mf.flatten_batch(x0, spec)[0].contiguous()
    r1 = instance_residuals(fn, spec, True)

    def at(dd):
        return r1(mf.retract_flat(xv, dd, spec), d_ex)
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.normal(size=D), dtype=dtype)
    q = torch.as_tensor(rng.normal(size=n_res), dtype=dtype)
    dx = torch.as_tensor(0.3 * rng.normal(size=D), dtype=dtype)
    z = torch.zeros(D, dtype=dtype)
    ref = (r1(xv, d_ex), torch.func.jvp(at, (z,), (p,))[1],
           torch.func.vjp(at, z)[1](q)[0], mf.retract_flat(xv, dx, spec))
    row = fam.pack_data(data, 1, dtype, torch.device("cpu"))
    ptr = (lambda t: ctypes.c_void_p(t.data_ptr()))
    got = [torch.empty(n, dtype=dtype) for n in (n_res, n_res, D, P)]
    lib.k2g_residual(ptr(xv), ptr(row), ptr(got[0]))
    lib.k2g_jvp(ptr(xv), ptr(row), ptr(p), ptr(got[1]))
    lib.k2g_vjp(ptr(xv), ptr(row), ptr(q), ptr(got[2]))
    lib.k2g_retract(ptr(xv), ptr(dx), ptr(got[3]))
    for what, g, r in zip(("residual", "jvp", "vjp", "retraction"), got,
                          ref):
        scale = max(r.abs().max().item(), 1e-300)
        err = (g - r).abs().max().item() / scale
        assert err <= TOL[dtype], f"{name} {dtype} {what}: {err:.3e}"
    same = torch.empty(P, dtype=dtype)
    lib.k2g_retract(ptr(xv), ptr(z), ptr(same))
    assert torch.equal(same, xv), f"{name}: x (+) 0 is not x"


def test_euclidean_family_keeps_its_widths(host_build):
    """A Euclidean family states kP = kD and kManifold false, and its
    emitted retraction adds."""
    fam, why = residual_codegen.generated_family(
        lambda v: torch.cat([v * v - 2.0, v]), torch.tensor([0.5, 1.5, -1.0],
                                                           dtype=torch.float64))
    assert fam is not None, why
    assert (fam.p, fam.d, fam.n_res) == (3, 3, 6)
    assert "kP = 3, kD = 3, kNRes = 6" in fam.source
    assert "kManifold = false" in fam.source
    lib = host_build(fam)
    x = torch.tensor([0.5, 1.5, -1.0], dtype=torch.float64)
    dx = torch.tensor([0.25, -2.0, 1e-3], dtype=torch.float64)
    out = torch.empty(3, dtype=torch.float64)
    lib.k2g_retract(ctypes.c_void_p(x.data_ptr()),
                    ctypes.c_void_p(dx.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()))
    assert torch.equal(out, x + dx)


def test_refusals_at_the_envelope_edges():
    """Refused with their reasons: an op outside the table, mixed dtypes
    in a mixed pytree; no longer refused: past max(P, D, n_res) = 64 (an
    SE3 pose with 22 points, 66 residuals: the warp form), a manifold
    leaf, a batched one, a mixed pytree."""
    gf = residual_codegen.generated_family
    fn = cases.residual("icp_plain")
    x0, data = cases.inputs("icp_plain", 1, 2)
    wide = type(data)(torch.cat([data.points, data.points[:, :6]], 1),
                      torch.cat([data.targets, data.targets[:, :6]], 1))
    fam, why = gf(fn, *_example(x0, wide))
    assert fam is not None and fam.warp and (fam.p, fam.d, fam.n_res) == (
        7, 6, 66), why
    fam, why = gf(lambda R: torch.erf(R.log()), SO3.identity(torch.float64))
    assert fam is None and "aten.erf" in why and "OP_TABLE" in why
    fam, why = gf(lambda x: torch.cat([x["T"].log(), x["b"].double()]),
                  {"T": SE3.identity(torch.float64), "b": torch.zeros(2)})
    assert fam is None and "mixed dtypes" in why
    for x in (SO3.identity(torch.float64),
              SO3.identity(torch.float64, batch=(3,)),
              {"T": SE3.identity(torch.float64),
               "b": torch.zeros(2, dtype=torch.float64)}):
        fam, why = gf(lambda v: torch.cat([a.reshape(-1) for a in
                                           pytree.tree_leaves(v)]) - 0.5, x)
        assert fam is not None, why
        spec = mf.tangent_spec(x)
        assert (fam.p, fam.d) == (spec.params, spec.dims)


class _Angle:
    """An angle stored as itself: a manifold whose stored width equals its
    tangent width (1)."""

    def __init__(self, theta):
        self.theta = theta


pytree.register_pytree_node(
    _Angle, lambda a: ([a.theta], None), lambda v, _: _Angle(*v),
    serialized_type_name="test_torch_codegen_manifold._Angle")
mf.register_manifold(_Angle, mf.Manifold(
    dims=lambda a: int(a.theta.numel()),
    retract=lambda a, d: _Angle(torch.atan2(torch.sin(a.theta + d),
                                            torch.cos(a.theta + d)))))


def test_manifold_of_equal_widths_is_refused_in_the_plan():
    """A registered manifold whose P equals its D is refused with its
    reason by the emitter and by K2's envelope, before any build (K2's
    GeneratedFamily holds a manifold's x only at P > D)."""
    x = _Angle(torch.tensor([0.3], dtype=torch.float64))
    fam, why = residual_codegen.generated_family(
        lambda a: torch.sin(a.theta) - 0.5, x)
    assert fam is None
    assert "stored width equals its tangent width (1)" in why
    fam_id, gen, why = cuda_solver.k2_envelope(
        lambda a: torch.sin(a.theta) - 0.5, x, None)
    assert fam_id is None and gen is None
    assert "stored width equals its tangent width (1)" in why


@pytest.mark.parametrize("P,D,n_res,coloring", [
    (7, 6, 6, None), (9, 8, 8, "identity"), (16, 12, 15, None),
    (10, 9, 9, None), (7, 6, 48, None), (64, 63, 2, None),
    (8, 6, 64, "multi")])
def test_k2_plan_at_p_above_d(P, D, n_res, coloring):
    """``k2_supports`` and ``k2_launch_plan`` of a generated family at P ≠
    D: one instance a thread, E = max(P, D, n_res), one warp a block."""
    G = cuda_solver.GENERATED
    assert cuda_solver.k2_supports(G, D, n_res, coloring, P)
    for itemsize in (4, 8):
        for solver in (0, 1, 2):
            kp = cuda_solver.k2_launch_plan(10_000, D, n_res, itemsize, G,
                                            coloring, solver, P)
            assert (kp.path, kp.S, kp.E, kp.warps, kp.smem_bytes) == (
                "segment", 1, max(P, D, n_res), 1, 0)
            assert kp.grid == -(-10_000 // 32)


@pytest.mark.parametrize("P,D,n_res", [(65, 60, 6), (5, 6, 6),
                                       (7, 6, 66)])
def test_k2_refuses_p_past_its_edges(P, D, n_res):
    """P below D: refused, and the plan raises; P past 64 and 66
    residuals: the warp kernel's plan (K2-a), S = 32, E = 3."""
    G = cuda_solver.GENERATED
    if P < D:
        assert not cuda_solver.k2_supports(G, D, n_res, None, P)
        with pytest.raises(ValueError, match="not built for"):
            cuda_solver.k2_launch_plan(3, D, n_res, 4, G, None, 1, P)
        return
    assert cuda_solver.k2_supports(G, D, n_res, None, P)
    kp = cuda_solver.k2_launch_plan(3, D, n_res, 4, G, None, 1, P)
    assert (kp.path, kp.S, kp.E) == ("warp", 32, 3)


def test_hand_written_se3_family_keeps_precedence():
    """``se3_residual`` on an SE3 pose still takes the hand-written SE3
    family (2, ``solver_se3_kernel``); a residual of the same map written
    with ``icp_residual`` takes a generated family of P = 7, D = 6."""
    x0, data = cases.inputs("icp_plain", 2, 4)
    x_ex, d_ex = _example(x0, data)
    assert cuda_solver.k2_envelope(se3_residual, x_ex, d_ex) == (2, None, "")
    fid, fam, why = cuda_solver.k2_envelope(cases.residual("icp_plain"),
                                            x_ex, d_ex)
    assert fid == cuda_solver.GENERATED and (fam.p, fam.d, fam.n_res) == (
        7, 6, 48), why
    opts = to.Options(hessian=to.HessianOptions(
        solver="fused", save_last=False, carry_system=False))
    plan = cuda_solver.fused_plan(opts, "residuals", x_ex,
                                  residual_fn=se3_residual, data_example=d_ex)
    assert plan.generated is None
    params = cuda_solver.k2_params(cuda_solver.GENERATED, opts,
                                   cuda_solver.FusedPlan(
                                       plan.spec, 48, None, fam))
    assert (params.d, params.fam_m, params.n_res) == (6, 7, 48)


# ---- on the card ----

def _card_opts(name):
    """``bench_se3``'s options on "fused" (chip_smoke.py phase 22)."""
    return to.Options(max_iters=10, max_consec_failures=3,
                      hessian=to.HessianOptions(solver="fused",
                                                save_last=False,
                                                carry_system=False))


def _card_case(name, dtype, B, seed):
    dev = torch.device("cuda")
    x0, data = cases.inputs(name, B, seed, dtype=dtype)
    x0, data = (pytree.tree_map(lambda a: a.to(dev), t) for t in (x0, data))
    opts = _card_opts(name)
    x_ex, d_ex = _example(x0, data)
    plan = cuda_solver.fused_plan(opts, "residuals", x_ex,
                                  residual_fn=cases.residual(name),
                                  data_example=d_ex)
    assert plan is not None and plan.generated is not None
    return cases.residual(name), opts, x0, data, plan


@pytest.fixture(scope="module")
def card_libraries():
    """Every generated library the card tests launch, built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    from tinyopt_tpu_torch import _build
    items = []
    for name in cases.NAMES:
        for dtype in (torch.float32, torch.float64):
            _, opts, _, _, plan = _card_case(name, dtype, 2, 5)
            items.append((plan.generated, _build.GenInstance(
                "float" if dtype == torch.float32 else "double", False,
                opts.save_history, cuda_solver.COLORING_CODES[
                    cuda_solver.coloring_kind(plan.coloring)])))
    return _build.build_generated(items)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", cases.NAMES)
@pytest.mark.parametrize("B", [1, 33, 1000])
def test_generated_k2_on_manifolds_matches_twin_on_gpu(name, dtype, B,
                                                       card_libraries):
    """Generated K2 on manifold parameters against its twin on the card,
    per instance: equal stop reasons, iterations within 1, x within rtol
    1e-5 (float32) / 1e-10 (float64); one generated launch."""
    fn, opts, x0, data, plan = _card_case(name, dtype, B, 5)
    xf = mf.flatten_batch(x0, plan.spec)
    before = cuda_solver.fused_solve.generated_launches
    xg, outg = cuda_solver.fused_solve(fn, opts, xf, data, plan)
    assert cuda_solver.fused_solve.generated_launches == before + 1
    xr, outr = cuda_solver.fused_solve_plain(fn, opts, xf, data, plan)
    assert torch.equal(outg.stop_reason, outr.stop_reason)
    assert (outg.num_iters - outr.num_iters).abs().max().item() <= 1
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(xg, xr, rtol=rtol, atol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["se3_prior", "se3_bias", "so3_cycle",
                                  "se23_prior", "sen3_prior", "icp_huber"])
def test_batched_optimize_on_each_manifold_on_gpu(name, card_libraries):
    """The public entry on the card, one manifold kind a case:
    batched_optimize with solver="fused" launches generated K2 once, K1
    and K2's warp kernel never, and returns finite parameters of the
    caller's pytree."""
    from tinyopt_tpu_torch.ops import cuda_cg
    fn, opts, x0, data, _ = _card_case(name, torch.float32, 500, 7)
    cuda_cg.cg_solve.launches = 0
    fs = cuda_solver.fused_solve
    before = (fs.launches, fs.generated_launches, fs.warp_launches)
    x, out = to.batched_optimize(x0, fn, opts, data_batch=data)
    torch.cuda.synchronize()
    assert cuda_cg.cg_solve.launches == 0
    assert (fs.launches - before[0], fs.generated_launches - before[1],
            fs.warp_launches - before[2]) == (1, 1, 0)
    assert pytree.tree_structure(x) == pytree.tree_structure(x0)
    assert all(bool(torch.all(torch.isfinite(a)))
               for a in pytree.tree_leaves(x))
