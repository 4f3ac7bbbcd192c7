"""The perceptron model of tinyopt_tpu_torch (models/nn.py) against the
JAX package (tests/test_nn.py; reference tests/nn.cpp:62-296): the manual
chain-rule Jacobian equals automatic differentiation and the JAX one, one
GD step from a manual accumulation equals one from AD, and LM and GD
training match the JAX solves.  Weights come from the JAX package's
``init_perceptron`` through ``interop.perceptron_from_numpy``."""

import jax.numpy as jnp
import numpy as np
import torch

import tinyopt_tpu as jto
from tinyopt_tpu.models import nn as jnn

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch.diff.auto import residual_jacobian
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       perceptron_from_numpy)
from tinyopt_tpu_torch.models import nn as tnn

torch.set_num_threads(1)


def _data(n=16, in_dim=3, out_dim=2, seed=1):
    rng = np.random.default_rng(seed)
    W = rng.uniform(-1, 1, (out_dim, in_dim))
    b = rng.uniform(-0.5, 0.5, out_dim)
    x = rng.uniform(-1, 1, (n, in_dim))
    jd = jnn.PerceptronData(jnp.asarray(x), jnn.forward(
        {"W": jnp.asarray(W), "b": jnp.asarray(b)}, jnp.asarray(x)))
    td = tnn.PerceptronData(torch.from_numpy(x),
                            torch.from_numpy(np.array(jd.targets)))
    return jd, td


def _params(seed):
    jp = jnn.init_perceptron(3, 2, jnp.float64, seed=seed)
    return jp, perceptron_from_numpy({k: np.asarray(v) for k, v in
                                      jp.items()}, device="cpu",
                                     dtype=torch.float64)


def _close(tp, jp, **tol):
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **tol)


def test_jacobian_manual_equals_ad_and_reference():
    jd, td = _data()
    jp, tp = _params(2)
    J_manual = tnn.manual_jacobian(tp, td)
    _, J_ad = residual_jacobian(lambda p: tnn.residuals(p, td), tp)
    np.testing.assert_allclose(J_manual.numpy(), J_ad.numpy(), atol=1e-12)
    np.testing.assert_allclose(J_manual.numpy(),
                               np.asarray(jnn.manual_jacobian(jp, jd)),
                               atol=1e-12)


def test_gd_step_manual_vs_ad():
    jd, td = _data()
    jp, tp = _params(3)
    opts = jto.Options(solver_type=jto.GradientDescent, max_iters=1,
                       min_error=0, min_rerr_dec=0, min_step_norm2=0,
                       min_grad_norm2=0, gd=jto.GDOptions(lr=0.1))
    topts = options_from_reference(opts)

    def manual_acc(p):
        r = tnn.residuals(p, td)
        J = tnn.manual_jacobian(p, td)
        return torch.sum(r * r), 2.0 * (J.T @ r)

    p1, _ = to.optimize(tp, lambda p: tnn.mse_cost(p, td), topts,
                        mode="cost")
    p2, _ = to.optimize(tp, manual_acc, topts, mode="acc")
    _close(p1, {k: v.numpy() for k, v in p2.items()}, atol=1e-12)
    pr, _ = jto.optimize(jp, lambda p: jnn.mse_cost(p, jd), opts, mode="cost")
    _close(p1, pr, rtol=1e-12)


def test_lm_training_matches_reference():
    jd, td = _data(n=32)
    jp, tp = _params(4)
    opts = jto.Options(max_iters=100)
    pr, outr = jto.optimize(jp, lambda p: jnn.residuals(p, jd), opts)
    p, out = to.optimize(tp, lambda p: tnn.residuals(p, td),
                         options_from_reference(opts))
    assert bool(out.succeeded())
    assert abs(int(out.num_iters) - int(outr.num_iters)) <= 1
    _close(p, pr, rtol=1e-5, atol=1e-8)
    pred = tnn.forward(p, td.inputs)
    assert float(torch.max(torch.abs(pred - td.targets))) < 1e-4


def test_gd_training_matches_reference():
    jd, td = _data()
    jp, tp = _params(5)
    opts = jto.Options(solver_type=jto.GradientDescent, max_iters=500,
                       gd=jto.GDOptions(lr=0.5))
    pr, outr = jto.optimize(jp, lambda p: jnn.mse_cost(p, jd), opts)
    p, out = to.optimize(tp, lambda p: tnn.mse_cost(p, td),
                         options_from_reference(opts))
    assert out.errs_list[-1] < out.errs_list[0] * 0.1
    assert int(out.num_iters) == int(outr.num_iters)
    assert int(out.stop_reason) == int(outr.stop_reason)
    _close(p, pr, rtol=1e-8, atol=1e-12)


def test_init_perceptron_seeded():
    a = tnn.init_perceptron(3, 2, torch.float64, seed=7, device="cpu")
    b = tnn.init_perceptron(3, 2, torch.float64, seed=7, device="cpu")
    assert list(a) == ["W", "b"] and a["W"].shape == (2, 3)
    assert torch.equal(a["W"], b["W"]) and torch.equal(a["b"], b["b"])
