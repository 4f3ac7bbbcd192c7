"""A dict of parameters lays out as in the JAX package: by sorted key.

Torch's pytree flattens a dict in insertion order, JAX's in sorted key
order.  The port flattens every parameter pytree through
``manifold.tree_flatten_sorted``, so a dict inserted in any order gives
the JAX package's tangent layout, flat vectors, gradient and covariance,
and the returned x keeps the caller's keys.  float64 on the CPU, 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu import manifold as jmf
from tinyopt_tpu.manifolds import SE3 as JSE3

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.manifolds import SE3

torch.set_num_threads(1)

TOL = 1e-12


def _probe(x):
    """The probe of the re-anchor, ``[b − (1, 2), 3·(a − 5)]``, made
    nonlinear so that the gradient after two iterations is not zero."""
    b, a = x["b"], x["a"]
    return b + 0.1 * b ** 3, 3.0 * (a - 5.0) + 0.2 * a ** 2


def probe_residual_jax(x):
    rb, ra = _probe(x)
    return jnp.concatenate([rb - jnp.array([1.0, 2.0]), ra])


def probe_residual_torch(x):
    rb, ra = _probe(x)
    return torch.cat([rb - torch.tensor([1.0, 2.0], dtype=rb.dtype), ra])


POSE_T = np.array([0.3, -0.2, 0.5, 0.05, -0.1, 0.2])
BIAS_T = np.array([0.4, -0.3, 0.2])
Q = np.array([1.0, 2.0, -1.0])


def pose_residual(x, lib):
    """A pose prior, a bias prior and a term that couples them through the
    pose and the scale, so every block of H is filled."""
    cat, arr = (jnp.concatenate, jnp.asarray) if lib == "jax" else (
        torch.cat, lambda a: torch.as_tensor(a, dtype=torch.float64))
    SE3cls = JSE3 if lib == "jax" else SE3
    prior_inv = SE3cls.exp(arr(-POSE_T))
    pose, bias, scale = x["pose"], x["calib"]["bias"], x["calib"]["scale"]
    return cat([(prior_inv @ pose).log(), bias - arr(BIAS_T),
                0.5 * (pose.apply(bias * scale[0]) - arr(Q)),
                2.0 * (scale - 1.5)])


def _x0_pose(lib):
    """``{"pose", "calib": {"scale", "bias"}}``: both dicts inserted out of
    sorted order (JAX lays them out as calib.bias, calib.scale, pose)."""
    if lib == "jax":
        return {"pose": JSE3.exp(jnp.asarray(0.1 * POSE_T)),
                "calib": {"scale": jnp.ones(1), "bias": jnp.zeros(3)}}
    return {"pose": SE3.exp(torch.as_tensor(0.1 * POSE_T)),
            "calib": {"scale": torch.ones(1, dtype=torch.float64),
                      "bias": torch.zeros(3, dtype=torch.float64)}}


def _x0_probe(lib):
    if lib == "jax":
        return {"b": jnp.zeros(2), "a": jnp.zeros(1)}
    return {"b": torch.zeros(2, dtype=torch.float64),
            "a": torch.zeros(1, dtype=torch.float64)}


CASES = {
    "probe": (_x0_probe, probe_residual_jax, probe_residual_torch),
    "nested_se3": (_x0_pose, lambda x: pose_residual(x, "jax"),
                   lambda x: pose_residual(x, "torch")),
}


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _close(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tangent_layout_matches_jax(case):
    make, _, _ = CASES[case]
    xj, xt = make("jax"), make("torch")
    sj, st = jmf.tangent_spec(xj), mf.tangent_spec(xt)
    assert st.leaf_dims == tuple(sj.leaf_dims)
    assert st.offsets == tuple(sj.offsets)
    assert st.dims == sj.dims
    _close(mf.flatten_values(xt), jmf.flatten_values(xj))
    # unflatten rebuilds the caller's structure, keys in the caller's order
    back = mf.unflatten(mf.flatten_batch(
        torch.utils._pytree.tree_map(lambda a: a[None], xt), st)[0], st)
    assert list(back) == list(xt)
    _close(mf.flatten_values(back), mf.flatten_values(xt))


def test_probe_layout_is_sorted():
    """The re-anchor's probe: ``a`` at tangent offset 0, as in JAX."""
    st = mf.tangent_spec({"b": torch.zeros(2), "a": torch.ones(1)})
    assert st.offsets == (0, 1) and st.leaf_dims == (1, 2)
    np.testing.assert_array_equal(
        mf.flatten_values({"b": torch.zeros(2), "a": torch.ones(1)}).numpy(),
        [1.0, 0.0, 0.0])


@pytest.mark.parametrize("max_iters", [2, 30])
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimize_output_matches_jax(case, max_iters):
    """x, its flat values, the gradient and the covariance of a dict
    inserted out of sorted order, after 2 iterations (a gradient far from
    0) and at convergence."""
    make, fj, ft = CASES[case]
    oj = jto.Options(max_iters=max_iters, max_consec_failures=0)
    ot = to.Options(max_iters=max_iters, max_consec_failures=0)
    xj, outj = jto.optimize(make("jax"), fj, oj)
    xt, outt = to.optimize(make("torch"), ft, ot)
    assert list(xt) == list(make("torch"))        # the caller's keys
    assert int(outt.stop_reason) == int(outj.stop_reason)
    assert int(outt.num_iters) == int(outj.num_iters)
    _close(mf.flatten_values(xt), jmf.flatten_values(xj))
    _close(outt.final_grad, outj.final_grad)
    _close(outt.covariance(), outj.covariance())
    if max_iters == 2:
        assert np.abs(_np(outt.final_grad)).max() > 1e-3


def test_batched_output_matches_jax():
    """The probe through ``batched_optimize`` on 4 starts: x, gradient and
    covariance per instance."""
    from tinyopt_tpu.parallel import batched_optimize as jbo
    rng = np.random.default_rng(3)
    b0, a0 = rng.normal(size=(4, 2)), rng.normal(size=(4, 1))
    o = dict(max_iters=2, max_consec_failures=0)
    xj, outj = jbo({"b": jnp.asarray(b0), "a": jnp.asarray(a0)},
                   probe_residual_jax, jto.Options(**o))
    xt, outt = to.batched_optimize({"b": torch.from_numpy(b0),
                                    "a": torch.from_numpy(a0)},
                                   probe_residual_torch, to.Options(**o))
    assert list(xt) == ["b", "a"]
    for k in ("a", "b"):
        _close(xt[k], xj[k])
    _close(outt.final_grad, outj.final_grad)
    _close(outt.covariance(), outj.covariance())


def _y_pose(lib):
    """Another point than ``_x0_pose``, every dict inserted in the other
    order: ``{"calib": {"bias", "scale"}, "pose"}``."""
    if lib == "jax":
        return {"calib": {"bias": jnp.asarray(BIAS_T),
                          "scale": jnp.full(1, 1.5)},
                "pose": JSE3.exp(jnp.asarray(POSE_T))}
    return {"calib": {"bias": torch.as_tensor(BIAS_T),
                      "scale": torch.full((1,), 1.5, dtype=torch.float64)},
            "pose": SE3.exp(torch.as_tensor(POSE_T))}


def test_local_across_insertion_orders_matches_jax():
    """``local(x, y)`` where y's dicts hold x's keys in another insertion
    order: one structure in JAX's terms, so the call succeeds and gives
    JAX's tangent; ``retract`` takes it back to y.  A missing key still
    raises."""
    xj, xt = _x0_pose("jax"), _x0_pose("torch")
    yj, yt = _y_pose("jax"), _y_pose("torch")
    dt = mf.local(xt, yt)
    _close(dt, jmf.local(xj, yj))
    _close(mf.flatten_values(mf.retract(xt, dt)), jmf.flatten_values(yj))
    del yt["calib"]["scale"]
    with pytest.raises(ValueError, match="mismatched"):
        mf.local(xt, yt)
