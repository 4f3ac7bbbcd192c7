"""tinyopt_tpu_torch configuration: options, stop reasons, interop, and the
rule that the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu import stop_reasons as jsr

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import stop_reasons as tsr
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       prior_problem_from_numpy)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_fields(ref_cls, port_cls, path=""):
    rf = {f.name: f for f in dataclasses.fields(ref_cls)}
    pf = {f.name: f for f in dataclasses.fields(port_cls)}
    assert list(rf) == list(pf), f"{path}: field names/order differ"
    ref, port = ref_cls(), port_cls()
    for name in rf:
        rv, pv = getattr(ref, name), getattr(port, name)
        if dataclasses.is_dataclass(rv):
            _assert_same_fields(type(rv), type(pv), f"{path}.{name}")
        elif hasattr(rv, "name") and hasattr(rv, "value"):      # enum
            assert (rv.name, rv.value) == (pv.name, pv.value), name
        else:
            assert rv == pv, f"{path}.{name}: {rv!r} != {pv!r}"


def test_options_fields_and_defaults_match_reference():
    _assert_same_fields(jto.Options, to.Options, "Options")
    assert [(s.name, s.value) for s in jto.SolverType] == \
        [(s.name, s.value) for s in to.SolverType]
    assert to.HessianOptions().fused_block == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_for_dtype_matches_reference(dtype):
    import jax.numpy as jnp
    ref = jto.Options().for_dtype(getattr(jnp, dtype))
    port = to.Options().for_dtype(getattr(torch, dtype))
    for k in ("min_error", "min_rerr_dec", "min_step_norm2",
              "min_grad_norm2"):
        assert getattr(ref, k) == getattr(port, k)


def test_stop_reason_codes_and_descriptions():
    assert [(s.name, int(s)) for s in jsr.StopReason] == \
        [(s.name, int(s)) for s in tsr.StopReason]
    opts = jto.Options()
    for s in jsr.StopReason:
        assert jsr.stop_reason_description(int(s), opts, 1.0) == \
            tsr.stop_reason_description(int(s), opts, 1.0)


def test_options_from_reference_copies_nested_groups():
    ref = jto.Options(
        solver_type=jto.GaussNewton, max_iters=7, min_error=3e-5,
        save_history=False, max_consec_failures=2,
        hessian=jto.HessianOptions(solver="fused", cg_iters=5,
                                   carry_system=False, save_last=False,
                                   fused_block=512),
        lm=jto.LMOptions(damping_init=1e-2, damping_range=(1e-6, 1e6)),
        cost=jto.CostScalingOptions(downscale_by_2=True))
    port = options_from_reference(ref)
    assert isinstance(port, to.Options)
    assert port.solver_type is to.SolverType.GAUSS_NEWTON
    assert isinstance(port.hessian, to.HessianOptions)
    assert port.hessian == to.HessianOptions(
        solver="fused", cg_iters=5, carry_system=False, save_last=False,
        fused_block=512)
    assert port.lm == to.LMOptions(damping_init=1e-2,
                                   damping_range=(1e-6, 1e6))
    assert port.cost.downscale_by_2 and port.max_iters == 7
    assert port.min_error == 3e-5 and port.max_consec_failures == 2
    assert options_from_reference(jto.Options()) == to.Options()
    with pytest.raises(TypeError):
        options_from_reference({"max_iters": 3})


def test_prior_problem_from_numpy():
    rng = np.random.default_rng(0)
    y, s = rng.uniform(-1, 1, (3, 4)), rng.uniform(0.1, 1.1, (3, 4))
    p = prior_problem_from_numpy(y, 1 / s, device="cpu",
                                 dtype=torch.float64)
    np.testing.assert_array_equal(p.y.numpy(), y)
    np.testing.assert_array_equal(p.inv_std.numpy(), 1 / s)
    assert p.y.dtype == torch.float64 and p.y.device.type == "cpu"


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "import tinyopt_tpu_torch as to\n"
        "from tinyopt_tpu_torch.models.problems import (make_prior_batch,"
        " prior_residual)\n"
        "x, out = to.optimize(torch.tensor(1.0), lambda x: x * x - 2)\n"
        "data, x0 = make_prior_batch(4, 3, torch.float64, device='cpu')\n"
        "opts = to.Options(save_history=False, hessian=to.HessianOptions("
        "solver='fused', carry_system=False, save_last=False))\n"
        "to.batched_optimize(x0, prior_residual, opts, data_batch=data)\n"
        "import tinyopt_tpu_torch.models.nn\n"
        "from tinyopt_tpu_torch.models.icp import icp, make_icp_problem\n"
        "from tinyopt_tpu_torch.manifolds import SEn3\n"
        "p = make_icp_problem(2, 16, 20, device='cpu')\n"
        "icp(p.src, p.dst, n_outer=2)\n"
        "to.sparse_optimize(torch.ones(3), lambda x: x * x - 2)\n"
        "to.matfree_optimize(torch.ones(3), lambda x: x * x - 2)\n"
        "to.block_optimize(torch.ones(3, 1), lambda x: x * x - 2)\n"
        "to.lbfgs.optimize(torch.zeros(2),"
        " lambda x: torch.sum((x - 1) ** 2))\n"
        "import tinyopt_tpu_torch.ops.schur, tinyopt_tpu_torch.ops.schur_obs\n"
        "from tinyopt_tpu_torch.models.bundle_adjustment import ("
        "make_ba_problem, project)\n"
        "d, x0, _ = make_ba_problem(2, 6, device='cpu')\n"
        "to.schur_optimize((x0['poses'], x0['points']),"
        " lambda p, q, o: project(p, q[None])[0] - o, d.observations,"
        " d.mask, to.Options(max_iters=2))\n"
        "from tinyopt_tpu_torch.models.pose_graph import (make_pose_graph,"
        " pose_graph_optimize)\n"
        "pd, px0, _ = make_pose_graph(6, 2, noise=1e-3, device='cpu')\n"
        "_, pout = pose_graph_optimize(px0, pd)\n"
        "assert bool(pout.converged()), pout\n"
        "from tinyopt_tpu_torch.models.bundle_adjustment import ("
        "make_ba_problem_sparse)\n"
        "(so, sc, sm), sx0, _ = make_ba_problem_sparse(4, 12, 3, noise=1e-3,"
        " device='cpu')\n"
        "_, sout = to.schur_sparse_optimize((sx0['poses'], sx0['points']),"
        " lambda p, q, o: project(p, q[None])[0] - o, so, sc, sm,"
        " to.Options(max_iters=2))\n"
        "import tinyopt_tpu_torch.models.bal\n"
        "import tinyopt_tpu_torch.parallel, tinyopt_tpu_torch.parallel.dryrun\n"
        "from tinyopt_tpu_torch.parallel import pad_instances\n"
        "pad_instances([torch.ones(2), torch.ones(3)])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
        " if m.startswith('jax'))\n"
        "assert 'tinyopt_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


#: Public names of ported modules that the port does not have, by the
#: ROADMAP Queue 1 item that owes them (16: the window reduce, band
#: storage, planned reduce and landmark sort of the sparse-observation
#: Schur solver's TPU layout, which the port does not port).
OWED = {
    "ops.schur_obs": {16: [
        # window reduce, band storage, planned reduce, the landmark sort
        "band_to_tridiag", "banded_cov_plan", "banded_reduced_solve_band",
        "camera_sort_perm", "make_banded_window_chunk_loop",
        "make_landmark_marginal_pass_banded", "make_planned_segment_reduce",
        "make_planned_segment_reduce_multi", "make_reduce_pass_planned",
        "make_reduce_pass_window", "make_reduce_pass_window_banded",
        "make_window_chunk_loop", "obs_marginals_banded",
        "plan_window_reduce", "plan_window_reduce_banded",
        "plan_window_reduce_banded_multi", "plan_window_reduce_multi"]},
}


def _public_names(mod) -> set:
    """A module's ``__all__``, or else the classes and functions it defines
    and the package's submodules it holds under their own names."""
    import types
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    for n in dir(mod):
        o = getattr(mod, n)
        if n.startswith("_"):
            continue
        if isinstance(o, types.ModuleType):
            root = mod.__name__.split(".")[0]
            if o.__name__.startswith(root + ".") and \
                    o.__name__.rsplit(".", 1)[-1] == n:
                out.add(n)
        elif getattr(o, "__module__", None) == mod.__name__:
            out.add(n)
    return out


def test_public_names_match_reference():
    """Every public name of a module the port has is there in the port,
    but the names the port owes or leaves out (``OWED``); and no owed name
    is there already."""
    import importlib
    import importlib.util
    import pkgutil
    missing, early = {}, {}
    ported = [""] + [m.name[len("tinyopt_tpu_torch."):] for m in
                     pkgutil.walk_packages(to.__path__, "tinyopt_tpu_torch.")]
    for name in ported:
        ref_name = "tinyopt_tpu" + (f".{name}" if name else "")
        if importlib.util.find_spec(ref_name) is None:
            continue
        ref = importlib.import_module(ref_name)
        port = importlib.import_module(
            "tinyopt_tpu_torch" + (f".{name}" if name else ""))
        owed = {n for names in OWED.get(name, {}).values() for n in names}
        gone = sorted(n for n in _public_names(ref) - owed
                      if not hasattr(port, n))
        there = sorted(n for n in owed if hasattr(port, n))
        if gone:
            missing[name] = gone
        if there:
            early[name] = there
    assert not missing, missing
    assert not early, early
    # examples/custom_manifold.py calls to.register_manifold(...)
    assert to.register_manifold is to.manifold.register_manifold


def test_value_and_jacfwd_matches_reference():
    import jax.numpy as jnp
    from tinyopt_tpu.diff import value_and_jacfwd as jvj
    x = np.array([0.3, -1.2, 2.0])

    def f(v, lib):
        return lib.stack([v[0] * v[1], lib.sin(v[2]) + v[0] ** 2])
    yj, Jj = jvj(lambda v: f(v, jnp), jnp.asarray(x))
    yt, Jt = to.diff.value_and_jacfwd(lambda v: f(v, torch),
                                      torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-12)


def test_make_circle_matches_reference():
    import jax.numpy as jnp
    from tinyopt_tpu.models.problems import make_circle as jcircle
    from tinyopt_tpu_torch.models.problems import make_circle
    fj, xj = jcircle(n=12, noise=1e-3, seed=4)
    ft, xt = make_circle(n=12, noise=1e-3, seed=4, dtype=torch.float64,
                         device="cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    x = np.array([1.5, 6.5, 1.8])
    np.testing.assert_allclose(ft(torch.from_numpy(x)).numpy(),
                               np.asarray(fj(jnp.asarray(x))), rtol=1e-12)


def test_debug_nans_raises_at_the_operation(tmp_path):
    from tinyopt_tpu_torch.utils import block_ms, debug_nans, device_trace
    with pytest.raises(FloatingPointError, match="div"):
        with debug_nans():
            torch.zeros(2) / torch.zeros(2)
    with debug_nans(False):
        assert torch.isnan(torch.zeros(1) / torch.zeros(1)).all()
    with device_trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(p.suffix == ".json" for p in tmp_path.iterdir())
    assert block_ms(lambda: torch.ones(4).sum(), n=2) >= 0.0
