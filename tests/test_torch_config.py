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
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
        " if m.startswith('jax'))\n"
        "assert 'tinyopt_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
