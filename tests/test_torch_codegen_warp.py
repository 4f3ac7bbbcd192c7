"""The warp form of K2's generated families (``ops/residual_codegen.py``):
past max(P, D, n_res) = 64 the residual, its jvp and its vjp are emitted
for one warp — each op a lane-strided loop over its entries, a sync after
it, the arrays in a per-warp scratch — and run by K2's warp kernel
(``csrc/solver_warp.cuh``).

On the CPU the warp form, compiled by g++ with its 32 lanes run one after
another, is held bit for bit to the register form of the same trace and
to ``torch.func`` at ``tests/test_torch_codegen.py``'s tolerances (the host
adds torch's CUDA sums in their card order, which torch on the CPU does
not), at the widths of ``chip_smoke.py`` phase 23 (the robust and the
plain point-to-point SE3 fit at 128 points, the banded residual at d =
128, the Huber curve fit at 256 samples) and on the small cases of
``tests/test_torch_codegen.py``; K2's warp plan and refusals from shapes
alone.  On the card (``cuda``) the warp libraries against the twin.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.diff.auto import instance_residuals
from tinyopt_tpu_torch.manifolds import SE3
from tinyopt_tpu_torch.models import curve_fit
from tinyopt_tpu_torch.models.icp import icp_residual
from tinyopt_tpu_torch.models.se3_refinement import SE3RefinementData
from tinyopt_tpu_torch.ops import cuda_solver, residual_codegen

from test_torch_codegen import CASES, _case, _example

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
#: phase 23's Huber threshold on a point's distance and displaced targets
TH, OUTLIERS = 0.05, 24


def icp_huber(T, d):
    """The robust point-to-point SE3 fit (models/icp.icp_residual)."""
    return icp_residual(T, d.points, d.targets, robust_th=TH)


def icp_plain(T, d):
    return icp_residual(T, d.points, d.targets)


def icp_poses(Ts, d):
    """Six SE3 poses an instance, each fit to its own points: P = 42 > 32
    stored values, so the manifold apply writes entries past a warp's
    lanes."""
    return torch.cat([icp_residual(T, d.points[k], d.targets[k])
                      for k, T in enumerate(Ts)])


def banded(x, y):
    """tests/test_fused.py:143's banded residual with data."""
    return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


def wide_case(name, dtype, B=1, seed=0, n=None):
    """(residual, x0 batch, data batch) of a wide case at phase 23's widths
    (``n``: the points, the dims or the samples instead), drawn with numpy
    from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    if name in ("icp_huber", "icp_plain"):
        n = n or 128
        pts = rng.uniform(-1, 1, (B, n, 3))
        w = rng.uniform(-0.5, 0.5, (B, 6))
        pose = SE3.exp(t(w))
        tgt = (torch.einsum("bij,bkj->bki", pose.rotation.matrix(), t(pts))
               + pose.translation[:, None, :])
        tgt = tgt + 1e-3 * t(rng.normal(size=(B, n, 3)))
        if name == "icp_huber":
            k = min(OUTLIERS * n // 128, n)
            tgt[:, :k] += 0.5 * t(rng.normal(size=(B, k, 3)))
        x0 = SE3.exp(t(w + 0.1 * rng.normal(size=(B, 6))))
        return ({"icp_huber": icp_huber, "icp_plain": icp_plain}[name], x0,
                SE3RefinementData(t(pts), tgt))
    if name == "icp_poses":
        K, n = 6, n or 6
        pts = rng.uniform(-1, 1, (B, K, n, 3))
        w = rng.uniform(-0.5, 0.5, (B, K, 6))
        tgt = []
        for k in range(K):
            pose = SE3.exp(t(w[:, k]))
            tgt.append(torch.einsum("bij,bkj->bki", pose.rotation.matrix(),
                                    t(pts[:, k]))
                       + pose.translation[:, None, :])
        tgt = torch.stack(tgt, 1) + 1e-3 * t(rng.normal(size=(B, K, n, 3)))
        x0 = tuple(SE3.exp(t(w[:, k] + 0.1 * rng.normal(size=(B, 6))))
                   for k in range(K))
        return icp_poses, x0, SE3RefinementData(t(pts), tgt)
    if name == "banded":
        n = n or 128
        return (banded, t(1 + 0.3 * rng.normal(size=(B, n))),
                t(rng.normal(size=(B, n))))
    if name == "curve_huber":
        n = n or 256
        tt = np.linspace(0.0, 2.0, n)
        y = 1.7 * np.exp(0.8 * tt) + 0.05 * rng.normal(size=(B, n))
        y[:, ::4] += (rng.uniform(3, 12, (B, len(tt[::4])))
                      * rng.choice([-1, 1], (B, len(tt[::4]))))
        x0 = np.stack([rng.uniform(0.8, 1.2, B), rng.uniform(0.4, 0.6, B)], 1)
        return (curve_fit.huber_residuals, t(x0),
                curve_fit.CurveData(t(np.tile(tt, (B, 1))), t(y)))
    raise KeyError(name)


#: (P, D, n_res) of each wide case at phase 23's widths
WIDE = {"icp_huber": (7, 6, 384), "icp_plain": (7, 6, 384),
        "banded": (128, 128, 128), "curve_huber": (2, 2, 256),
        "icp_poses": (42, 36, 108)}


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a family's emitted source with g++ into a host library
    (``K2G_HOST_ENTRY``) and load it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emitted C++ on the host")
    root = tmp_path_factory.mktemp("k2gen_warp")
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


def _family(fn, x_ex, d_ex, warp):
    """The generated family of one form: the warp form (``warp``) or the
    register form, whatever the widths (``SEG_MAX`` moved for the trace)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(residual_codegen, "SEG_MAX", 0 if warp else 10 ** 9)
        fam, why = residual_codegen.generated_family(fn, x_ex, d_ex)
    assert fam is not None and fam.warp == warp, why
    return fam


def _check_forms(fn, x0, data, dtype, libs, fam):
    """The warp form (``libs[0]``) against the register form (``libs[1]``,
    bit for bit) and against torch.func (``TOL``) on the first instance:
    r, the jvp of a seeded tangent, the vjp of a seeded cotangent."""
    x_ex, d_ex = _example(x0, data)
    spec = mf.tangent_spec(x_ex)
    xv = mf.flatten_batch(pytree.tree_map(lambda a: a[:1], x0),
                          spec)[0].contiguous()
    r1 = instance_residuals(fn, spec, d_ex is not None)
    R = (lambda v: r1(v, d_ex)) if d_ex is not None else r1
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.normal(size=fam.d), dtype=dtype)
    q = torch.as_tensor(rng.normal(size=fam.n_res), dtype=dtype)
    z = torch.zeros((fam.d,), dtype=dtype)

    def at(dd):
        return R(mf.retract_flat(xv, dd, spec))
    ref = (R(xv), torch.func.jvp(at, (z,), (p,))[1],
           torch.func.vjp(at, z)[1](q)[0])
    row = None if data is None else fam.pack_data(
        pytree.tree_map(lambda a: a[:1], data), 1, dtype, torch.device("cpu"))
    ptr = (lambda t: None if t is None else ctypes.c_void_p(t.data_ptr()))
    sizes = (fam.n_res, fam.n_res, fam.d)
    for form, lib in zip(("warp_", ""), libs):
        got = [torch.full((n,), float("nan"), dtype=dtype) for n in sizes]
        getattr(lib, f"k2g_{form}residual")(ptr(xv), ptr(row), ptr(got[0]))
        getattr(lib, f"k2g_{form}jvp")(ptr(xv), ptr(row), ptr(p), ptr(got[1]))
        getattr(lib, f"k2g_{form}vjp")(ptr(xv), ptr(row), ptr(q), ptr(got[2]))
        if form == "warp_":
            warp = got
            continue
        for what, a, b in zip(("residual", "jvp", "vjp"), warp, got):
            assert torch.equal(a, b), f"{what}: warp form != register form"
    for what, g, r in zip(("residual", "jvp", "vjp"), warp, ref):
        scale = max(r.abs().max().item(), 1e-300)
        err = (g - r).abs().max().item() / scale
        assert err <= TOL[dtype], f"{what} {dtype}: {err:.3e}"


@pytest.fixture(scope="module")
def wide_families():
    """Each wide case's generated family as the plan traces it (the warp
    form) and in the register form, traced once."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            fn, x0, data = wide_case(name, dtype, seed=3)
            x_ex, d_ex = _example(x0, data)
            fid, auto, why = cuda_solver.k2_envelope(fn, x_ex, d_ex)
            assert fid == cuda_solver.GENERATED, why
            cache[name, dtype] = (fn, x0, data, auto,
                                  _family(fn, x_ex, d_ex, False))
        return cache[name, dtype]
    return get


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(WIDE))
def test_warp_form_at_full_width(name, dtype, host_build, wide_families):
    """Phase 23's residuals at their full widths: the generated family
    holds the warp form only, with a scratch, and its warp functions equal
    the register form's (traced here past ``SEG_MAX`` to hold them to) bit
    for bit and ``torch.func`` to ``TOL``."""
    fn, x0, data, auto, reg = wide_families(name, dtype)
    assert (auto.p, auto.d, auto.n_res) == WIDE[name]
    assert auto.warp and auto.scratch > 0 and auto.scratch % 4 == 0
    assert "warp_rows" in auto.source and " rows(" not in auto.source
    _check_forms(fn, x0, data, dtype, (host_build(auto), host_build(reg)),
                 auto)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", CASES)
def test_warp_form_of_the_small_cases(name, dtype, host_build):
    """tests/test_torch_codegen.py's cases (every op of the table) in the
    warp form (traced here below ``SEG_MAX``) against the register form:
    bit for bit, and ``torch.func`` to ``TOL``."""
    fn, x0, data = _case(name, dtype, seed=3)
    x_ex, d_ex = _example(x0, data)
    fam = _family(fn, x_ex, d_ex, True)
    _check_forms(fn, x0, data, dtype,
                 (host_build(fam), host_build(_family(fn, x_ex, d_ex, False))),
                 fam)


def test_scratch_is_reused_by_liveness():
    """The warp form's scratch holds only the arrays live at once: a chain
    of 40 ops over 200 values, each read by the next alone, takes two
    arrays' room, not forty."""
    def chain(x, y):
        r = y * x[0]
        for k in range(40):
            r = torch.cat([r[1:], r[:1]]) * (1.0 + 0.01 * k)
        return r
    x = torch.ones(1, dtype=torch.float64)
    fam, why = residual_codegen.generated_family(
        chain, x, torch.linspace(0.0, 1.0, 200, dtype=torch.float64))
    assert fam is not None and fam.warp, why
    assert fam.scratch <= 3 * 200, fam.scratch


@pytest.mark.parametrize("name", sorted(WIDE))
def test_k2_plan_of_a_wide_generated_family(name, wide_families):
    """K2's plan for a generated family past 64, from its shapes: the warp
    kernel (S = 32, E = ⌈max(P, D, n_res) / 32⌉), one warp an instance, up
    to 4 a block while they fit 48 KB, the shared memory a warp's state
    (rounded to 4 values) and the family's scratch; the coloring as
    detected ("multi", 2 colors, on the banded residual); the library's
    instance on the warp path."""
    G = cuda_solver.GENERATED
    opts = to.Options(hessian=to.HessianOptions(
        solver="fused", save_last=False, carry_system=False))
    for dtype in (torch.float32, torch.float64):
        fn, x0, data, gen, _ = wide_families(name, dtype)
        x_ex, d_ex = _example(x0, data)
        plan, why = cuda_solver.fused_envelope(
            opts, "residuals", x_ex, residual_fn=fn, data_example=d_ex)
        assert plan is not None and plan.n_res == gen.n_res, why
        kind = cuda_solver.coloring_kind(plan.coloring)
        if name == "banded":
            assert kind == "multi" and plan.coloring.n_colors == 2
        assert cuda_solver.k2_supports(G, gen.d, gen.n_res, kind, gen.p)
        assert cuda_solver.k2_refusal(G, plan.spec, gen.n_res,
                                      plan.coloring) == ""
        itemsize = 4 if dtype == torch.float32 else 8
        per = (cuda_solver.warp_state_values(gen.p, gen.d, gen.n_res)
               + gen.scratch) * itemsize
        m = max(WIDE[name])
        for B in (1, 3, 10_000):
            kp = cuda_solver.k2_launch_plan(B, gen.d, gen.n_res, itemsize, G,
                                            kind, 1, gen.p, gen.scratch)
            assert (kp.path, kp.S, kp.E) == ("warp", 32, math.ceil(m / 32))
            assert kp.smem_bytes == kp.warps * per <= cuda_solver._MAX_SMEM
            # 4 warps a block, halved while their state passes 48 KB
            assert kp.warps == next(w for w in (4, 2, 1)
                                    if w == 1 or w * per <= 48 * 1024)
            assert kp.grid * kp.warps >= B
        inst = cuda_solver.generated_instance(gen, dtype, False, False, kind)
        assert inst.path == 0 and inst.coloring == \
            cuda_solver.COLORING_CODES[kind]


def test_refusals_of_the_warp_path():
    """What stays outside K2 past 64, with its reason: the identity
    coloring with fewer residuals than dimensions and fewer parameters than
    tangent dimensions (``k2_supports``), a warp whose state and scratch
    exceed a block's shared memory (the trace, and the plan)."""
    G = cuda_solver.GENERATED
    assert not cuda_solver.k2_supports(G, 100, 80, "identity")
    assert not cuda_solver.k2_supports(G, 128, 128, None, 100)
    with pytest.raises(ValueError, match="not built for"):
        cuda_solver.k2_launch_plan(3, 128, 128, 4, G, None, 1, 100)

    def line(x, d):
        return x[0] * d.t + x[1] - d.y
    n = 30_000
    data = curve_fit.CurveData(torch.zeros(n), torch.zeros(n))
    fam, why = residual_codegen.generated_family(line, torch.ones(2), data)
    assert fam is None and "exceed a block's shared memory" in why
    with pytest.raises(ValueError, match="exceeds a block's shared memory"):
        cuda_solver.k2_launch_plan(3, 2, n, 4, G, None, 1)


# ---- on the card ----

def _card_opts(name, dogleg=False):
    """phase 23's options: bench_se3's for the ICP cells, the JAX suite's
    for the banded residual, phase 7's for the curve fit, on "fused"."""
    hk = dict(solver="fused", save_last=False, carry_system=False)
    if name.startswith("icp"):
        return to.Options(max_iters=8, max_consec_failures=0,
                          hessian=to.HessianOptions(**hk))
    if name == "curve_huber":
        return to.Options(max_iters=30, max_consec_failures=0,
                          hessian=to.HessianOptions(**hk))
    return to.Options(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
        solver_type=to.DogLeg if dogleg else to.LevenbergMarquardt,
        hessian=to.HessianOptions(cg_iters=8, **hk))


CARD_BATCHES = (1, 33, 257)


@pytest.fixture(scope="module")
def card_libraries():
    """The card test's libraries, each case's family at each batch
    (``GeneratedFamily.at_batch``: below 32 the sums of another geometry),
    built by nvcc processes started together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    from tinyopt_tpu_torch import _build
    dev = torch.device("cuda")
    items = []
    for name in sorted(WIDE):
        for dtype in (torch.float32, torch.float64):
            fn, x0, data = wide_case(name, dtype, seed=5)
            # planned on the card, as the test plans: the family is
            # generated for CUDA tensors only
            x_ex, d_ex = _example(pytree.tree_map(lambda a: a.to(dev), x0),
                                  pytree.tree_map(lambda a: a.to(dev), data))
            plan = cuda_solver.fused_plan(_card_opts(name), "residuals",
                                          x_ex, residual_fn=fn,
                                          data_example=d_ex)
            kind = cuda_solver.coloring_kind(plan.coloring)
            for B in CARD_BATCHES:
                gen = plan.generated.at_batch(B)
                items.append((gen, cuda_solver.generated_instance(
                    gen, dtype, False, False, kind)))
    return _build.build_generated(items)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WIDE))
@pytest.mark.parametrize("B", CARD_BATCHES)
def test_warp_generated_k2_matches_twin_on_gpu(name, dtype, B,
                                              card_libraries):
    """The warp library of each wide case against the twin on the card:
    one launch, on the warp kernel; equal stop reasons, iterations within
    1, x within rtol 1e-5 (float32) / 1e-10 (float64)."""
    dev = torch.device("cuda")
    fn, x0, data = wide_case(name, dtype, B=B, seed=5)
    x0 = pytree.tree_map(lambda a: a.to(dev), x0)
    data = pytree.tree_map(lambda a: a.to(dev), data)
    opts = _card_opts(name)
    x_ex, d_ex = _example(x0, data)
    plan = cuda_solver.fused_plan(opts, "residuals", x_ex, residual_fn=fn,
                                  data_example=d_ex)
    assert plan is not None and plan.generated is not None
    xf = mf.flatten_batch(x0, plan.spec)
    before = (cuda_solver.fused_solve.generated_launches,
              cuda_solver.fused_solve.warp_launches)
    xg, outg = cuda_solver.fused_solve(fn, opts, xf, data, plan)
    assert (cuda_solver.fused_solve.generated_launches,
            cuda_solver.fused_solve.warp_launches) == (before[0] + 1,
                                                       before[1] + 1)
    xr, outr = cuda_solver.fused_solve_plain(fn, opts, xf, data, plan)
    assert torch.equal(outg.stop_reason, outr.stop_reason)
    assert (outg.num_iters - outr.num_iters).abs().max().item() <= 1
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(xg, xr, rtol=rtol, atol=rtol)
