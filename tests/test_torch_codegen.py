"""The generated residual families of K2 (``ops/residual_codegen.py``):
the emitted C++ of the residual, its jvp and its vjp, compiled by g++ as a
host library and held to ``torch.func``; the emitter's refusals; the
generated family's launch plan and envelope from shapes alone; and, on the
card (``cuda``), generated K2 against its plain twin.

The emitted code runs here with the host's libm and ascending sums where
the card sums in warp order, so float64 is held to 1e-12 relative to the
largest value, float32 to 1e-5 (the float32 rounding of a few dozen
chained operations, exponentials and square roots of another libm).
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
from tinyopt_tpu_torch.losses.robust_norms import huber, robust_whiten
from tinyopt_tpu_torch.manifolds import SO3
from tinyopt_tpu_torch.models import curve_fit
from tinyopt_tpu_torch.models.problems import (PriorProblem,
                                               jennrich_sampson_residuals,
                                               prior_residual)
from tinyopt_tpu_torch.ops import cuda_solver, residual_codegen

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def robust_prior(x, data):
    """tests/test_fused.py:94's Huber-whitened prior."""
    r = (x - data.y) * data.inv_std
    return torch.func.vmap(lambda ri: robust_whiten(ri[None], huber, 0.5))(r)


def no_data(x):
    """tests/test_fused.py:187's residual closed over constants."""
    return torch.stack([x[0] * x[0] - 2.0, 0.5 * (x[0] - 1.0)])


def dict_params(x, data):
    """tests/test_fused.py:198's dict parameters and data."""
    return torch.cat([x["a"] - data["ta"], 2.0 * (x["b"] - data["tb"])])


def banded(x):
    """tests/test_fused.py:461's 2-color banded residual."""
    return torch.cat([x[:-1] - 0.5 * x[1:], x - 1.0])


def banded_data(x, y):
    """tests/test_fused.py:143's banded residual with data."""
    return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y


_W = ((0.5, -1.0, 2.0), (1.5, 0.25, -0.75))


def trig(x):
    """sin, cos, tanh, pow, abs, sign, rsqrt, a reciprocal, exp, log."""
    return torch.cat([torch.sin(x) * torch.cos(2.0 * x), torch.tanh(x) ** 3,
                      torch.abs(x) * torch.sign(x - 0.1),
                      torch.rsqrt(1.5 + x * x), 1.0 / (2.0 + x),
                      torch.exp(-x * x).pow(0.5), torch.log(2.0 + x)])


def linalg(x):
    """mv, mm of depth 3, dot, mean, permute, t and a sum keeping its dim,
    over a closed-over matrix."""
    w = torch.tensor(_W, dtype=x.dtype, device=x.device)
    a = x[:6].reshape(2, 3)
    return torch.cat([w @ x[:3], (a @ w.T).reshape(-1),
                      torch.dot(x[:3], x[3:6]).reshape(1), a.mean(dim=1),
                      a.permute(1, 0).reshape(-1) * 2.0,
                      a.t().sum(dim=0, keepdim=True).reshape(-1)])


def views(x):
    """unbind, split, stack, clamp on both sides and on one, where with a
    scalar, rsub and a sub with alpha."""
    a, b, c = x[:3].unbind()
    p, q = x[3:].split([1, 2])
    return torch.cat([torch.stack([a * b, b - c, 1.0 - c]),
                      torch.clamp(p, -0.5, 0.5),
                      torch.where(q > 0.0, q, 0.25 * q),
                      torch.sub(q, p, alpha=2.0), torch.clamp(q, min=-0.2),
                      torch.clamp(q, max=0.3)])


def _case(name, dtype, B=1, seed=0):
    """(residual, x0 batch, data batch or None) of a named case, drawn with
    numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    if name in ("exp", "huber", "geman_mcclure"):
        fn = {"exp": curve_fit.exp_residuals,
              "huber": curve_fit.huber_residuals,
              "geman_mcclure": curve_fit.geman_mcclure_residuals}[name]
        tt = np.linspace(0.0, 2.0, 60)
        y = 1.7 * np.exp(0.8 * tt) + 0.05 * rng.normal(size=(B, 60))
        y[:, ::4] += rng.uniform(3, 12, (B, 15)) * rng.choice([-1, 1], (B, 15))
        x0 = np.stack([rng.uniform(0.8, 1.2, B), rng.uniform(0.4, 0.6, B)], 1)
        return fn, t(x0), curve_fit.CurveData(t(np.tile(tt, (B, 1))), t(y))
    if name == "robust_prior":
        return robust_prior, t(rng.uniform(-1, 1, (B, 6))), PriorProblem(
            t(rng.uniform(-1, 1, (B, 6))), t(1 / rng.uniform(0.1, 1.1,
                                                             (B, 6))))
    if name == "prior":
        return prior_residual, t(rng.uniform(-1, 1, (B, 7))), PriorProblem(
            t(rng.uniform(-1, 1, (B, 7))), t(1 / rng.uniform(0.1, 1.1,
                                                             (B, 7))))
    if name == "no_data":
        return no_data, t(rng.uniform(0.5, 3.0, (B, 1))), None
    if name == "dict":
        return dict_params, {"a": t(rng.normal(size=(B, 3))),
                             "b": t(rng.normal(size=(B, 2)))}, {
            "ta": t(np.ones((B, 3))), "tb": t(np.full((B, 2), 0.5))}
    if name == "banded":
        return banded, t(1 + 0.3 * rng.normal(size=(B, 8))), None
    if name == "banded_data":
        return banded_data, t(np.zeros((B, 6))), t(rng.normal(size=(B, 6)))
    if name in ("trig", "linalg", "views"):
        return {"trig": trig, "linalg": linalg, "views": views}[name], t(
            rng.uniform(-0.9, 0.9, (B, 6))), None
    if name == "jennrich_sampson":
        return jennrich_sampson_residuals, t(rng.uniform(0.1, 0.45,
                                                         (B, 2))), None
    raise KeyError(name)


CASES = ("exp", "huber", "geman_mcclure", "robust_prior", "no_data", "dict",
         "banded", "banded_data", "prior", "jennrich_sampson", "trig",
         "linalg", "views")


def _example(x0, data):
    x_ex = pytree.tree_map(lambda a: a[0], x0)
    d_ex = None if data is None else pytree.tree_map(lambda a: a[0], data)
    return x_ex, d_ex


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a family's emitted source with g++ into a host library
    (``K2G_HOST_ENTRY``: ``k2g_residual`` / ``k2g_jvp`` / ``k2g_vjp`` of
    the traced type) and load it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emitted C++ on the host")
    root = tmp_path_factory.mktemp("k2gen")
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
@pytest.mark.parametrize("name", CASES)
def test_emitted_functions_match_torch_func(name, dtype, host_build):
    """The emitted residual, jvp of a seeded tangent and vjp of a seeded
    cotangent, compiled by g++, against ``torch.func`` on the same flat
    instance."""
    fn, x0, data = _case(name, dtype, seed=3)
    x_ex, d_ex = _example(x0, data)
    fam, why = residual_codegen.generated_family(fn, x_ex, d_ex)
    assert fam is not None, why
    assert fam.dtype == dtype and all(v > 0 for v in fam.ops.values())
    lib = host_build(fam)
    spec = mf.tangent_spec(x_ex)
    xv = mf.flatten_batch(x0, spec)[0].contiguous()
    r1 = instance_residuals(fn, spec, d_ex is not None)
    R = (lambda v: r1(v, d_ex)) if d_ex is not None else r1
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.normal(size=fam.d), dtype=dtype)
    q = torch.as_tensor(rng.normal(size=fam.n_res), dtype=dtype)
    z = torch.zeros_like(xv)
    ref = (R(xv), torch.func.jvp(lambda dd: R(xv + dd), (z,), (p,))[1],
           torch.func.vjp(lambda dd: R(xv + dd), z)[1](q)[0])
    row = fam.pack_data(data, 1, dtype, torch.device("cpu"))
    ptr = (lambda t: None if t is None else ctypes.c_void_p(t.data_ptr()))
    got = [torch.empty(fam.n_res, dtype=dtype),
           torch.empty(fam.n_res, dtype=dtype), torch.empty(fam.d,
                                                            dtype=dtype)]
    lib.k2g_residual(ptr(xv), ptr(row), ptr(got[0]))
    lib.k2g_jvp(ptr(xv), ptr(row), ptr(p), ptr(got[1]))
    lib.k2g_vjp(ptr(xv), ptr(row), ptr(q), ptr(got[2]))
    for what, g, r in zip(("residual", "jvp", "vjp"), got, ref):
        scale = max(r.abs().max().item(), 1e-300)
        err = (g - r).abs().max().item() / scale
        assert err <= TOL[dtype], f"{name} {dtype} {what}: {err:.3e}"


def test_curve_fit_family_layout():
    """The least-squares curve fit: d = 2, 60 residuals, a data row of t
    then y (120 values), 4 operations a residual, a deterministic source
    and hash, and the data packed row by row."""
    fn, x0, data = _case("exp", torch.float32, B=3)
    x_ex, d_ex = _example(x0, data)
    fam, _ = residual_codegen.generated_family(fn, x_ex, d_ex)
    assert (fam.d, fam.n_res, fam.q, fam.data_shapes) == (2, 60, 120,
                                                          ((60,), (60,)))
    assert fam.ops["residual"] == 4 * 60
    assert "kD = 2, kNRes = 60, kQ = 120" in fam.source
    again = residual_codegen._make(fn, x_ex, d_ex, torch.float32)
    assert again is not fam and again.source == fam.source
    assert again.hash == fam.hash
    row = fam.pack_data(data, 3, torch.float32, torch.device("cpu"))
    torch.testing.assert_close(row, torch.cat([data.t, data.y], 1))
    with pytest.raises(ValueError, match="data leaf"):
        fam.pack_data(curve_fit.CurveData(data.t[:2], data.y[:2]), 3,
                      torch.float32, torch.device("cpu"))
    # every call traces anew, to the same source; another dtype to another
    again, _ = residual_codegen.generated_family(fn, x_ex, d_ex)
    assert again is not fam and again.hash == fam.hash
    f64, _ = residual_codegen.generated_family(
        fn, x_ex.double(), curve_fit.CurveData(*(a.double() for a in d_ex)))
    assert f64 is not fam and f64.dtype == torch.float64


def test_refusals_give_their_reason():
    """Outside the generated envelope: an op outside the table, a warp
    whose state and scratch exceed a block's shared memory (past max(P, D,
    n_res) = 64, the warp form), a leaf that is no tensor, mixed dtypes,
    integer data, a value read back to the host (data-dependent control
    flow), a residual that does not run — each refused with its reason."""
    gf = residual_codegen.generated_family
    x = torch.tensor([0.3, 0.4])

    def atan(v):
        return torch.atan(v)
    fam, why = gf(atan, x)
    assert fam is None and "aten.atan" in why and "OP_TABLE" in why
    fam, why = gf(lambda v: v.repeat(33), x)
    assert fam is None and "aten.repeat" in why
    fam, why = gf(lambda v, t: v[0] * t - v[1], x, torch.zeros(30_000))
    assert fam is None and "exceed a block's shared memory" in why
    fam, why = gf(lambda p: p["a"] - 1.0, {"a": torch.zeros(2), "k": 3.0})
    assert fam is None and "not tensors" in why
    fam, why = gf(lambda p: torch.cat([p["a"], p["b"].float()]),
                  {"a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.float64)})
    assert fam is None and "mixed dtypes" in why
    fam, why = gf(lambda v, k: v * k, x, torch.tensor([1, 2]))
    assert fam is None and "data leaf of type torch.int64" in why

    def branchy(v):
        return v - 1.0 if float(v[0]) > 0 else v + 1.0
    fam, why = gf(branchy, x)
    assert fam is None and "_local_scalar_dense" in why

    def broken(v):
        raise RuntimeError("no")
    fam, why = gf(broken, x)
    assert fam is None and "does not run" in why
    fam, why = gf(lambda v: v[:0], x)
    assert fam is None and "no residuals" in why


def test_closed_over_constants_become_literals():
    """A closed-over tensor becomes a literal array up to MAX_CONST entries
    and a uniform one a scalar literal; a larger one is refused."""
    w = torch.linspace(1.0, 2.0, 5, dtype=torch.float64)
    fam, why = residual_codegen.generated_family(
        lambda v: w * v[0] - torch.full((5,), 3.0, dtype=torch.float64),
        torch.ones(1, dtype=torch.float64))
    assert fam is not None, why
    assert "1.25" in fam.source and "1.75" in fam.source
    big = torch.arange(300.0)

    def wide(v):
        return (big * v[0]).sum(dim=0, keepdim=True)
    fam, why = residual_codegen.generated_family(wide, torch.ones(1))
    assert fam is None and "constant of 300 entries" in why


@pytest.mark.parametrize("B", [1, 31, 33, 10_000])
@pytest.mark.parametrize("d,n_res,coloring", [
    (2, 60, None), (6, 6, "identity"), (1, 2, "multi"), (8, 15, "multi"),
    (5, 5, "identity"), (64, 64, None), (1, 64, None)])
def test_k2_plan_of_a_generated_family(B, d, n_res, coloring):
    """K2's plan for a generated family from its shapes alone: one instance
    a thread (S = 1, E = max(d, n_res)), one warp a block, a grid that
    covers the batch, for every solver and type; ``k2_supports`` admits
    it."""
    G = cuda_solver.GENERATED
    assert cuda_solver.k2_supports(G, d, n_res, coloring)
    for itemsize in (4, 8):
        for solver in (0, 1, 2):
            plan = cuda_solver.k2_launch_plan(B, d, n_res, itemsize, G,
                                              coloring, solver)
            assert plan.path == "segment" and plan.smem_bytes == 0
            assert (plan.S, plan.E, plan.warps) == (1, max(d, n_res), 1)
            assert plan.grid == math.ceil(B / 32)


def test_k2_supports_bounds_of_a_generated_family():
    """Past 64 (P too) a generated family takes K2's warp kernel, with any
    coloring (K2-a): S = 32, E = ⌈65 / 32⌉ = 3.  Fewer parameters than
    tangent dimensions or the identity with fewer residuals than
    dimensions, at any width: refused, and ``k2_launch_plan`` raises."""
    G = cuda_solver.GENERATED
    for args in [(65, 65, None), (2, 65, "multi"), (65, 2, None),
                 (6, 12, None, 65)]:
        assert cuda_solver.k2_supports(G, *args), args
        plan = cuda_solver.k2_launch_plan(3, args[0], args[1], 4, G, args[2],
                                          1, *args[3:])
        assert (plan.path, plan.S, plan.E) == ("warp", 32, 3), args
    for args in [(6, 4, "identity"), (6, 12, None, 5),
                 (100, 80, "identity"), (128, 128, None, 100)]:
        assert not cuda_solver.k2_supports(G, *args), args
        with pytest.raises(ValueError, match="not built for"):
            cuda_solver.k2_launch_plan(3, args[0], args[1], 4, G, args[2], 1,
                                       *args[3:])


def test_k2_envelope_from_the_example():
    """``k2_envelope`` on CPU examples: a hand-written family first, a
    generated one for the curve fits, the JAX suite's residuals and a
    residual on a manifold leaf, and the reason for a residual outside
    both."""
    fn, x0, data = _case("prior", torch.float32)
    assert cuda_solver.k2_envelope(fn, *_example(x0, data)) == (0, None, "")
    for name in ("exp", "huber", "geman_mcclure", "robust_prior", "no_data",
                 "dict", "banded"):
        fn, x0, data = _case(name, torch.float32)
        fid, fam, why = cuda_solver.k2_envelope(fn, *_example(x0, data))
        assert fid == cuda_solver.GENERATED and fam is not None, (name, why)
    fid, fam, why = cuda_solver.k2_envelope(lambda R: R.log(),
                                            SO3.identity())
    assert fid == cuda_solver.GENERATED and (fam.p, fam.d) == (4, 3), why
    fid, fam, why = cuda_solver.k2_envelope(lambda v: torch.atan(v), x0[0])
    assert fid is None and "aten.atan" in why


def test_fused_plan_refusal_reasons():
    """``fused_envelope`` gives the plan and "" inside the fused envelope,
    and ``None`` and what puts a configuration outside it."""
    fn, x0, data = _case("huber", torch.float32)
    x_ex, d_ex = _example(x0, data)
    ok = to.Options(hessian=to.HessianOptions(solver="fused", save_last=False,
                                              carry_system=False))
    plan, why = cuda_solver.fused_envelope(ok, "residuals", x_ex,
                                           residual_fn=fn, data_example=d_ex)
    assert plan is not None and why == ""
    plan, why = cuda_solver.fused_envelope(
        to.Options(hessian=to.HessianOptions(solver="fused")), "residuals",
        x_ex, residual_fn=fn, data_example=d_ex)
    assert plan is None and "save_last" in why
    assert cuda_solver.fused_envelope(
        ok, "numdiff", x_ex, residual_fn=fn, data_example=d_ex) == (
            None, "mode 'numdiff'")


class _Shifted:
    """A residual that reads a bound attribute (``delta``) and a
    closed-over tensor (``scale``) each time it runs: scale·(x − delta)."""

    def __init__(self, dtype, device="cpu"):
        self.delta = 0.5
        self.scale = torch.tensor([1.0, 2.0, 3.0], dtype=dtype,
                                  device=device)

    def residual(self, x):
        return self.scale * (x - self.delta)


def test_a_changed_closed_over_value_is_traced_again(host_build):
    """A residual's closed-over values are read when the solver is planned:
    after its attribute and its tensor change (in place), the next plan
    emits them, and the emitted residual agrees with the function's
    current values."""
    fit = _Shifted(torch.float64)
    x = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    first, why = residual_codegen.generated_family(fit.residual, x)
    assert first is not None, why
    fit.delta = 1.25
    fit.scale.mul_(7.0)
    second, why = residual_codegen.generated_family(fit.residual, x)
    assert second is not None, why
    assert second.hash != first.hash
    assert "1.25" in second.source and "1.25" not in first.source
    assert "21" in second.source
    lib = host_build(second)
    got = torch.empty(3, dtype=torch.float64)
    lib.k2g_residual(ctypes.c_void_p(x.data_ptr()), None,
                     ctypes.c_void_p(got.data_ptr()))
    torch.testing.assert_close(got, fit.residual(x), rtol=1e-12, atol=0)


def _band(width):
    """64 residuals of 64 parameters, each over ``width`` neighbours: a
    ``width``-color coloring."""
    def band(x):
        r = x * x
        for k in range(1, width):
            r = r + (0.5 / k) * torch.cat([x[k:], x.new_zeros(k)])
        return r
    return band


@pytest.mark.parametrize("dtype,fits,over", [(torch.float64, 6, 7),
                                             (torch.float32, 13, 14)])
def test_k2_refuses_color_tables_past_shared_memory(dtype, fits, over):
    """d = n_res = 64 with a wide band: a generated family and a
    multi-color coloring, planned for the card while the coloring's tables
    fit a block's shared memory (227 KB) and refused, with the reason,
    from one color more."""
    from tinyopt_tpu_torch.ops.coloring import detect_diag_coloring
    x = torch.linspace(0.1, 0.9, 64, dtype=dtype)
    spec = mf.tangent_spec(x)
    itemsize = x.element_size()
    for width, planned in ((fits, True), (over, False)):
        fn = _band(width)
        fam, why = residual_codegen.generated_family(fn, x)
        assert fam is not None and (fam.d, fam.n_res) == (64, 64), why
        col = detect_diag_coloring(fn, x, None, spec, 64, 64, dtype)
        assert col is not None and col.n_colors == width
        nbytes = cuda_solver.k2_table_bytes(width, 64, 64, itemsize)
        assert (nbytes <= cuda_solver._MAX_SMEM) == planned
        why = cuda_solver.k2_refusal(cuda_solver.GENERATED, spec, 64, col)
        if planned:
            assert why == ""
        else:
            assert f"{width} colors" in why and "shared memory" in why


def test_generated_entry_point_matches_its_declaration():
    """The generated family's C entry point takes as many arguments as
    ``_build`` declares, ``enum Family`` names kGenerated with the id the
    wrapper uses, and the family's instance macros are the ones
    csrc/solver_gen.cuh reads."""
    import inspect
    import re
    from tinyopt_tpu_torch import _build
    with open(f"{_build.CSRC}/solver_gen.cuh") as f:
        src = f.read()
    with open(f"{_build.CSRC}/solver.cuh") as f:
        hdr = f.read()
    params = re.search(r'extern "C" int tinyopt_gen_solver\(([^)]*)\)',
                       src).group(1)
    decl = inspect.getsource(_build._load_generated)
    declared = re.search(r"argtypes = \[([^\]]*)\]", decl).group(1)
    assert params.count(",") + 1 == declared.count(",") + 1 == 11
    assert int(re.search(r"kGenerated = (\d+)", hdr).group(1)) \
        == cuda_solver.GENERATED
    unit = _build._generated_unit(
        type("F", (), {"hash": "0" * 16})(),
        _build.GenInstance("float", True, False, 2, _build.GEN_WARP))
    for macro in ("K2G_T", "K2G_DL", "K2G_HIST", "K2G_COLOR", "K2G_PATH"):
        assert f"#define {macro} " in unit and macro in src
    assert "#define K2G_PATH 0" in unit
    assert set(_build.GEN_SOURCES) <= {
        s.rsplit("/", 1)[-1] for s in _build.sources()}


# ---- on the card ----

def _card_opts(name):
    """The options of a named case on the card: the curve fits' (phase 7,
    30 iterations) or tests/test_fused.py's (the dogleg for the banded
    residual with data)."""
    if name in ("exp", "huber", "geman_mcclure"):
        return to.Options(max_iters=30, max_consec_failures=0,
                          hessian=to.HessianOptions(solver="fused",
                                                    save_last=False,
                                                    carry_system=False))
    hk = dict(save_last=False, solver="fused", cg_iters=8,
              carry_system=False)
    return to.Options(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
        solver_type=to.DogLeg if name == "banded_data" else
        to.LevenbergMarquardt, hessian=to.HessianOptions(**hk))


CARD_CASES = ("exp", "huber", "geman_mcclure", "robust_prior", "no_data",
              "dict", "banded", "banded_data", "trig", "linalg", "views")


def _card_case(name, dtype, B, seed):
    """(residual, options, x0, data, plan) of a named case on the card."""
    dev = torch.device("cuda")
    fn, x0, data = _case(name, dtype, B=B, seed=seed)
    x0 = pytree.tree_map(lambda a: a.to(dev), x0)
    data = None if data is None else pytree.tree_map(lambda a: a.to(dev),
                                                     data)
    opts = _card_opts(name)
    x_ex, d_ex = _example(x0, data)
    plan = cuda_solver.fused_plan(opts, "residuals", x_ex, residual_fn=fn,
                                  data_example=d_ex)
    assert plan is not None and plan.generated is not None
    return fn, opts, x0, data, plan


@pytest.fixture(scope="module")
def card_libraries():
    """Every generated library the card tests launch, built together (one
    nvcc each, all started at once) before the first of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    from tinyopt_tpu_torch import _build
    items = []
    for name in CARD_CASES:
        for dtype in (torch.float32, torch.float64):
            _, opts, _, _, plan = _card_case(name, dtype, 2, 5)
            items.append((plan.generated, _build.GenInstance(
                "float" if dtype == torch.float32 else "double",
                opts.solver_type == to.DogLeg, opts.save_history,
                cuda_solver.COLORING_CODES[cuda_solver.coloring_kind(
                    plan.coloring)])))
    return _build.build_generated(items)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", CARD_CASES)
@pytest.mark.parametrize("B", [1, 33, 1000])
def test_generated_k2_matches_twin_on_gpu(name, dtype, B, card_libraries):
    """Generated K2 against its twin on the card, per instance: equal stop
    reasons, iterations within 1, x within rtol 1e-5 (float32) / 1e-10
    (float64); one generated launch."""
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
def test_generated_k2_follows_closed_over_cuda_values():
    """A residual closed over a CUDA tensor and a bound attribute, solved
    through batched_optimize on the card twice, its values changed in
    between: each solve one generated K2 launch, no K1, x within 1e-10 of
    the twin's on the current values and within 1e-6 of the current
    delta."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    from tinyopt_tpu_torch.ops import cuda_cg
    dev = torch.device("cuda")
    fit = _Shifted(torch.float64, dev)
    x0 = torch.zeros((64, 3), dtype=torch.float64, device=dev)
    for delta, factor in ((0.5, 1.0), (1.25, 3.0)):
        fit.delta = delta
        fit.scale.mul_(factor)
        cuda_cg.cg_solve.launches = 0
        before = cuda_solver.fused_solve.generated_launches
        opts = _card_opts("no_data")
        x, out = to.batched_optimize(x0, fit.residual, opts)
        torch.cuda.synchronize()
        assert cuda_cg.cg_solve.launches == 0
        assert cuda_solver.fused_solve.generated_launches == before + 1
        plan = cuda_solver.fused_plan(opts, "residuals", x0[0],
                                      residual_fn=fit.residual)
        xr, _ = cuda_solver.fused_solve_plain(fit.residual, opts, x0, None,
                                              plan)
        torch.testing.assert_close(x, xr, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(x, torch.full_like(x, delta), rtol=0,
                                   atol=1e-6)


@pytest.mark.cuda
def test_batched_optimize_generated_on_gpu(card_libraries):
    """The public entry on the card: batched_optimize with solver="fused"
    on the Huber curve fit launches generated K2 once and K1 never."""
    from tinyopt_tpu_torch.ops import cuda_cg
    fn, opts, x0, data, _ = _card_case("huber", torch.float32, 500, 7)
    cuda_cg.cg_solve.launches = 0
    before = (cuda_solver.fused_solve.launches,
              cuda_solver.fused_solve.generated_launches)
    x, out = to.batched_optimize(x0, fn, opts, data_batch=data)
    torch.cuda.synchronize()
    assert cuda_cg.cg_solve.launches == 0
    assert (cuda_solver.fused_solve.launches - before[0],
            cuda_solver.fused_solve.generated_launches - before[1]) == (1, 1)
    assert bool(torch.all(torch.isfinite(x)))
