"""Multi-device solving of tinyopt_tpu_torch (``parallel``: the mesh, the
padding, instance-sharded ``batched_optimize`` and block-sharded
``sharded_optimize``) against the JAX package on the CPU.

The port runs in 2 and 4 gloo ranks (``tests/torch_parallel_worker.py``,
spawned once a module and rank count); the JAX package on 2 and 4 of the 8
virtual CPU devices (``tests/conftest.py``), in float64, on the same
seed-made numpy inputs.  Solves are held to ``tests/test_fused.py:51``'s
tolerances (rtol 1e-5, iterations within 1, the same success and
convergence class); every rank's results equal rank 0's bit for bit; the
sharded port equals the unsharded port to the same tolerances.  The mesh,
the padding and the one-rank paths run in this process."""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import tinyopt_tpu as jto
from tinyopt_tpu.models import problems as jprob
from tinyopt_tpu.parallel import (batched_optimize as j_batched,
                                  make_block_system as j_block_system,
                                  make_mesh as j_make_mesh,
                                  masked_residuals as j_masked,
                                  pad_instances as j_pad,
                                  sharded_optimize as j_sharded)

import tinyopt_tpu_torch as to
import torch_parallel_worker as W
from tinyopt_tpu_torch.models.problems import PriorProblem, prior_residual
from tinyopt_tpu_torch.parallel import (batched_optimize, init_distributed,
                                        local_mesh, make_mesh,
                                        masked_residuals, pad_instances)

torch.set_num_threads(1)

SPAWN_S = 240                  # each spawn's time limit
DP_CASES = [f"dp_{st}_{s}" for st in ("lm", "dl") for s in ("fused", "cg")]
BLOCK_CASES = ["block_cholesky", "block_cg"]


def dp_inputs() -> dict:
    data, x0 = jprob.make_prior_batch(16, 5, jnp.float64, seed=3)
    bdata, bx0 = jprob.make_prior_batch(16, 6, jnp.float64, seed=4)
    return {"dp/y": np.array(data.y), "dp/inv_std": np.array(data.inv_std),
            "dp/x0": np.array(x0), "block/y": np.array(bdata.y),
            "block/inv_std": np.array(bdata.inv_std),
            "block/x0": np.array(bx0[0])}


def jax_dp(inp: dict, n: int) -> dict:
    """The JAX package's counterpart of every case on ``n`` devices."""
    devs = jax.devices()[:n]
    ref = {}
    data = jprob.PriorProblem(jnp.asarray(inp["dp/y"]),
                              jnp.asarray(inp["dp/inv_std"]))
    x0 = jnp.asarray(inp["dp/x0"])
    grid = j_make_mesh(batch=max(n // 2, 1), block=min(n, 2), devices=devs)
    for key in DP_CASES:
        _, st, solver = key.split("_")
        opts = jto.Options(
            max_iters=10, save_history=False,
            solver_type=jto.DogLeg if st == "dl" else jto.LevenbergMarquardt,
            hessian=jto.HessianOptions(solver=solver, cg_iters=5,
                                       carry_system=False, save_last=False))
        mesh, axis = ((grid, ("batch", "block")) if key == "dp_lm_fused"
                      else (Mesh(np.asarray(devs), ("batch",)), "batch"))
        x, out = j_batched(x0, jprob.prior_residual, opts, data_batch=data,
                           mesh=mesh, axis=axis)
        W.record(ref, key, jax.tree_util.tree_leaves(x), out)
    bdata = jprob.PriorProblem(jnp.asarray(inp["block/y"]),
                               jnp.asarray(inp["block/inv_std"]))
    bx0 = jnp.asarray(inp["block/x0"])
    blocks = Mesh(np.asarray(devs), ("block",))
    for key in BLOCK_CASES:
        opts = jto.Options(max_iters=10, hessian=jto.HessianOptions(
            solver=key.split("_")[1]))
        x, out = j_sharded(bx0, jprob.prior_residual, bdata, opts,
                           mesh=blocks, axis="block")
        W.record(ref, key, [x], out)
    k = n + 1
    with pytest.raises(ValueError) as e:
        j_block_system(jprob.prior_residual,
                       jprob.PriorProblem(bdata.y[:k], bdata.inv_std[:k]),
                       bx0, blocks, "block")
    ref["err/block"] = str(e.value)
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def dp(request, tmp_path_factory):
    """The port's ranks spawned once (they run while the JAX package
    computes its references), then both results."""
    n = request.param
    inp = dp_inputs()
    procs = W.spawn("dp", n, tmp_path_factory.mktemp(f"dp{n}"), inp)
    deadline = time.monotonic() + SPAWN_S
    try:
        ref = jax_dp(inp, n)
    except BaseException:
        W.kill(procs)
        raise
    return types.SimpleNamespace(n=n, ref=ref,
                                 ranks=W.collect(procs, deadline))


def test_ranks_agree_bit_for_bit(dp):
    W.same_on_every_rank(dp.ranks)


@pytest.mark.parametrize("case", DP_CASES + BLOCK_CASES)
def test_matches_reference(dp, case):
    W.parity(dp.ref, case, dp.ranks[0], case)


@pytest.mark.parametrize("case", DP_CASES + BLOCK_CASES)
def test_matches_unsharded_port(dp, case):
    W.parity(dp.ranks[0], f"plain/{case}", dp.ranks[0], case)


def test_indivisible_axes_raise(dp):
    res = dp.ranks[0]
    assert str(res["err/block"]) == dp.ref["err/block"]
    assert "not divisible by mesh axis 'batch'" in str(res["err/batched"])


# ---- in this process: one rank, the mesh and the padding ----

@pytest.fixture
def one_rank(tmp_path):
    init_distributed(device="cpu", init_method=f"file://{tmp_path}/store",
                     rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_one_rank(one_rank):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"batch": 1, "block": 1}
    assert mesh.size(("batch", "block")) == 1
    assert (mesh.index("batch"), mesh.index(("batch", "block"))) == (0, 0)
    assert local_mesh("x", device="cpu").shape == {"x": 1}
    assert make_mesh(batch=1, device="cpu").shape["batch"] == 1


def test_bad_factorization_raises(one_rank):
    with pytest.raises(ValueError, match=r"mesh 3x3 != 1 devices"):
        make_mesh(batch=3, block=3, device="cpu")
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        j_make_mesh(batch=3, block=3)


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        local_mesh("batch", device="cpu")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed(device="cuda", init_method=f"file://{tmp_path}/s",
                         rank=0, world_size=1)
    assert not dist.is_initialized()


def test_one_rank_mesh_is_the_unsharded_solve(one_rank):
    """A one-rank mesh gives the unsharded fused solve bit for bit (the
    card's phase 20a at a CPU size)."""
    inp = dp_inputs()
    data = PriorProblem(torch.as_tensor(inp["dp/y"]),
                        torch.as_tensor(inp["dp/inv_std"]))
    x0 = torch.as_tensor(inp["dp/x0"])
    opts = to.Options(save_history=False, hessian=to.HessianOptions(
        solver="fused", carry_system=False, save_last=False))
    got = batched_optimize(x0, prior_residual, opts, data_batch=data,
                           mesh=local_mesh("batch", device="cpu"))
    want = batched_optimize(x0, prior_residual, opts, data_batch=data)
    a, b = {}, {}
    W._record(a, "s", *got)
    W._record(b, "s", *want)
    W.same_on_every_rank([a, b])


def _ragged(seed=3, counts=(6, 9, 4, 11)):
    rng = np.random.default_rng(seed)
    targets = [rng.uniform(-1, 1, 2) for _ in counts]
    return [{"obs": t[None, :].repeat(n, 0) + 0.1 * rng.normal(size=(n, 2))}
            for t, n in zip(targets, counts)]


def test_pad_instances_matches_reference():
    data = _ragged()
    stacked, mask = pad_instances(
        [{"obs": torch.as_tensor(d["obs"])} for d in data], pad_value=7.0)
    j_stacked, j_mask = j_pad([{"obs": jnp.asarray(d["obs"])} for d in data],
                              pad_value=7.0)
    np.testing.assert_array_equal(stacked["obs"].numpy(),
                                  np.asarray(j_stacked["obs"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert mask.dtype == torch.float32
    with pytest.raises(ValueError, match="empty"):
        pad_instances([])


def test_masked_residuals_drop_values_and_derivatives():
    """Padded rows whose residual is NaN / inf give zero residual and zero
    (forward-mode) derivative, as the JAX package's select does."""
    mask = np.asarray([1.0, 1.0, 0.0, 0.0])
    d = np.asarray([0.5, 2.0, 0.0, -1.0])

    def jr(x):
        return j_masked(jnp.log(jnp.asarray(d)) * x + 1.0 / jnp.asarray(d),
                        jnp.asarray(mask))

    def tr(x):
        return masked_residuals(torch.log(torch.as_tensor(d)) * x
                                + 1.0 / torch.as_tensor(d),
                                torch.as_tensor(mask))

    x = 0.3
    np.testing.assert_array_equal(tr(torch.tensor(x, dtype=torch.float64)),
                                  np.asarray(jr(x)))
    np.testing.assert_array_equal(
        torch.func.jacfwd(tr)(torch.tensor(x, dtype=torch.float64)),
        np.asarray(jax.jacfwd(jr)(x)))


def test_heterogeneous_batch_matches_reference():
    """Circle-style fits with different observation counts, padded:
    padded rows contribute zero residual and zero Jacobian."""
    data = _ragged()
    stacked, mask = pad_instances(
        [{"obs": torch.as_tensor(d["obs"])} for d in data])
    j_stacked, j_mask = j_pad([{"obs": jnp.asarray(d["obs"])} for d in data])

    def fn(x, inst):
        obs, m = inst
        return masked_residuals(obs - x[None, :], m).reshape(-1)

    def jfn(x, inst):
        obs, m = inst
        return j_masked(obs - x[None, :], m).reshape(-1)

    got, want = {}, {}
    W._record(got, "h", *batched_optimize(
        torch.zeros((4, 2), dtype=torch.float64), fn,
        data_batch=(stacked["obs"], mask.double())))
    x, out = j_batched(jnp.zeros((4, 2)), jfn,
                       data_batch=(j_stacked["obs"], j_mask))
    W.record(want, "h", [x], out)
    W.parity(want, "h", got, "h")
    means = [d["obs"].mean(0) for d in data]
    np.testing.assert_allclose(got["h/x0"], np.stack(means), atol=1e-8)
