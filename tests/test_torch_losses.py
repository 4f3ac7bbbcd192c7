"""Slice B item 10 of tinyopt_tpu_torch against the JAX package: the rest of
``Cost``, the losses (norms, robust M-estimators, Mahalanobis,
activations, classification, distances, each ``*_with_jac``), numerical
differentiation, the gradient checker, and the ``acc`` / ``numdiff``
modes with the automatic-differentiation → numdiff fallback; plus the
easy suite's scalar costs and the robust curve-fit model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyopt_tpu as jto
from tinyopt_tpu import diff as jdiff
from tinyopt_tpu import losses as jl
from tinyopt_tpu.cost import Cost as JCost
from tinyopt_tpu.manifolds import SO3 as JSO3
from tinyopt_tpu.models import problems as jp

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import diff as tdiff
from tinyopt_tpu_torch import losses as tl
from tinyopt_tpu_torch.cost import Cost
from tinyopt_tpu_torch.interop import options_from_reference, so3_from_numpy
from tinyopt_tpu_torch.models import curve_fit as tcf
from tinyopt_tpu_torch.models import problems as tp

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _close(got, ref, **tol):
    """Every leaf of ``got`` (torch) against ``ref`` (JAX)."""
    tol = tol or TOL
    gl = jax.tree_util.tree_leaves(got)
    rl = jax.tree_util.tree_leaves(ref)
    assert len(gl) == len(rl)
    for g, r in zip(gl, rl):
        np.testing.assert_allclose(_np(g), _np(r), **tol)


rng = np.random.default_rng(0)
V = rng.normal(size=6)                       # a vector
W = rng.normal(size=6)
N2 = np.concatenate([rng.uniform(0, 1.2, 20), rng.uniform(1.4, 9, 20)])
A = rng.normal(size=(6, 6))
COV = A @ A.T + 6 * np.eye(6)                # SPD
VAR = rng.uniform(0.5, 2.0, 6)
U = np.triu(rng.normal(size=(6, 6)))
ROBUST = ["truncated", "huber", "tukey", "arctan", "cauchy",
          "geman_mcclure", "blake_zisserman"]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float64))


# name -> (the attribute path in both packages, arguments)
LOSS_CASES = {
    **{f"{n}": (f"robust_norms.{n}", (N2, 1.3)) for n in ROBUST},
    **{f"{n}_loss": (f"robust_norms.{n}_loss", (V, 1.3)) for n in ROBUST},
    "squared_l2": ("norms.squared_l2", (V,)),
    "squared_l2_scale": ("norms.squared_l2", (V, True)),
    "l2": ("norms.l2", (V,)),
    "l2_zero": ("norms.l2", (np.zeros(3),)),
    "l1": ("norms.l1", (V,)),
    "linf": ("norms.linf", (V,)),
    "squared_l2_with_jac": ("norms.squared_l2_with_jac", (V,)),
    "l2_with_jac": ("norms.l2_with_jac", (V,)),
    "l1_with_jac": ("norms.l1_with_jac", (V,)),
    "linf_with_jac": ("norms.linf_with_jac", (V,)),
    "maha_squared_norm_scalar": ("mahalanobis.maha_squared_norm",
                                 (V, 1.7)),
    "maha_squared_norm_var": ("mahalanobis.maha_squared_norm", (V, VAR)),
    "maha_squared_norm_cov": ("mahalanobis.maha_squared_norm", (V, COV)),
    "maha_squared_norm_with_jac": ("mahalanobis.maha_squared_norm_with_jac",
                                   (V, COV)),
    "maha_norm": ("mahalanobis.maha_norm", (V, VAR)),
    "maha_norm_with_jac": ("mahalanobis.maha_norm_with_jac", (V, COV)),
    "maha_whitened_scalar": ("mahalanobis.maha_whitened", (V, 0.7)),
    "maha_whitened_var": ("mahalanobis.maha_whitened", (V, VAR)),
    "maha_whitened_cov": ("mahalanobis.maha_whitened", (V, COV)),
    "maha_whitened_with_jac_var": ("mahalanobis.maha_whitened_with_jac",
                                   (V, VAR)),
    "maha_whitened_with_jac_cov": ("mahalanobis.maha_whitened_with_jac",
                                   (V, COV)),
    "maha_whitened_info_u": ("mahalanobis.maha_whitened_info_u", (V, U)),
    "maha_whitened_info_u_with_jac": (
        "mahalanobis.maha_whitened_info_u_with_jac", (V, U)),
    "sigmoid": ("activations.sigmoid", (V,)),
    "sigmoid_with_jac": ("activations.sigmoid_with_jac", (V,)),
    "tanh": ("activations.tanh", (V,)),
    "tanh_with_jac": ("activations.tanh_with_jac", (V,)),
    "relu": ("activations.relu", (V,)),
    "relu_with_jac": ("activations.relu_with_jac", (V,)),
    "leaky_relu": ("activations.leaky_relu", (V, 0.05)),
    "leaky_relu_with_jac": ("activations.leaky_relu_with_jac", (V, 0.05)),
    "softmax": ("classif.softmax", (V,)),
    "safe_softmax": ("classif.safe_softmax", (30 * V,)),
    "softmax_with_jac": ("classif.softmax_with_jac", (V,)),
    "safe_softmax_with_jac": ("classif.safe_softmax_with_jac", (V,)),
    "euclidean": ("distances.euclidean", (V, W)),
    "euclidean_with_jac": ("distances.euclidean_with_jac", (V, W)),
    "manhattan": ("distances.manhattan", (V, W)),
    "manhattan_with_jac": ("distances.manhattan_with_jac", (V, W)),
    "linf_dist": ("distances.linf_dist", (V, W)),
    "linf_dist_with_jac": ("distances.linf_dist_with_jac", (V, W)),
    "cosine": ("distances.cosine", (V, W)),
    "cosine_zero": ("distances.cosine", (np.zeros(6), W)),
    "cosine_with_jac": ("distances.cosine_with_jac", (V, W)),
    "maha_dist": ("distances.maha_norm", (V, W, VAR)),
    "maha_dist_with_jac": ("distances.maha_norm_with_jac", (V, W, COV)),
}


def _attr(mod, path):
    for p in path.split("."):
        mod = getattr(mod, p)
    return mod


def _arg(a, conv):
    return conv(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    """Every loss and ``*_with_jac`` against its JAX counterpart, float64,
    to 1e-12."""
    path, args = LOSS_CASES[name]
    got = _attr(tl, path)(*(_arg(a, _t) for a in args))
    ref = _attr(jl, path)(*(_arg(a, _j) for a in args))
    _close(got, ref)


@pytest.mark.parametrize("name", ROBUST)
def test_robust_whiten_matches_jax(name):
    """``robust_whiten``: value and Jacobian (torch.func.jacfwd against
    jax.jacfwd) on an inlier and an outlier residual block."""
    for scale in (0.3, 3.0):
        r = scale * V[:3]
        tfn = getattr(tl.robust_norms, name)
        jfn = getattr(jl.robust_norms, name)
        _close(tl.robust_whiten(_t(r), tfn, 1.3),
               jl.robust_whiten(_j(r), jfn, 1.3))
        _close(torch.func.jacfwd(lambda v: tl.robust_whiten(v, tfn, 1.3))(
            _t(r)), jax.jacfwd(lambda v: jl.robust_whiten(v, jfn, 1.3))(
                _j(r)))


def _reject_all(n2, th2):
    """A hard-rejecting estimator whose loss is 0 past the threshold."""
    n2 = torch.as_tensor(n2)
    keep = n2 <= th2
    return torch.where(keep, n2, torch.zeros_like(n2)), keep.to(n2.dtype)


@pytest.mark.parametrize("name", ROBUST + ["reject_all"])
def test_robust_whiten_gradient_finite_at_rejection(name):
    """The double-where guards: at r = 0, far past the threshold (the
    plateau of truncated and Tukey), and where ρ is 0 (a rejecting
    estimator), forward and reverse derivatives stay finite."""
    fn = _reject_all if name == "reject_all" else getattr(
        tl.robust_norms, name)

    def white(v):
        return tl.robust_whiten(v, fn, 0.5)
    for r in (np.zeros(3), np.array([30.0, -40.0, 5.0]), V[:3]):
        for jac in (torch.func.jacfwd, torch.func.jacrev):
            J = jac(white)(_t(r))
            assert bool(torch.all(torch.isfinite(J))), (name, r, jac)
    if name == "reject_all":
        assert torch.equal(white(_t([30.0, 0.0, 0.0])), torch.zeros(3,
                           dtype=torch.float64))


def test_robust_cost_and_gnc_match_jax():
    r = rng.normal(size=(7, 3)) * 2
    for fn in ROBUST:
        c = tl.robust_cost(_t(r), getattr(tl.robust_norms, fn), 2.0)
        jc = jl.robust_cost(_j(r), getattr(jl.robust_norms, fn), 2.0)
        _close((c.cost, c.num_residuals, c.inlier_ratio),
               (jc.cost, jc.num_residuals, jc.inlier_ratio))
    c = tl.robust_cost(_t(r[:, 0]), tl.huber, 1.0)
    assert int(c.num_residuals) == 7
    assert tl.gnc_schedule(50.0, 2.0, 4) == jl.gnc_schedule(50.0, 2.0, 4)
    assert tl.gnc_schedule(5.0, 2.0, 1) == (2.0,)
    # gnc_anneal's three forms: th² per stage, warm starts chained
    calls = []

    def stage2(x, th2):
        calls.append(th2)
        return x + 1, th2

    assert tl.gnc_anneal(stage2, 0, (3.0, 2.0)) == (2, 4.0)

    def stage3(x, th2, fn):
        calls.append(float(fn(_t([1.0, 0.0]))[0]))
        return x + 1, th2

    x, th2 = tl.gnc_anneal(stage3, 0, (2.0,), residual_fn=lambda v: v,
                           robust_fn=tl.huber)
    assert (x, th2) == (1, 4.0) and calls[:2] == [9.0, 4.0]
    assert calls[2] == pytest.approx(1.0)       # inlier: r' = r
    x, _ = tl.gnc_anneal(stage3, 0, (1.0, 0.5),
                         make_fn=lambda th2: (lambda v: v * th2))
    assert x == 2 and calls[3:] == [1.0, 0.25]


def test_cost_matches_jax():
    """``Cost``: from_residuals, the merge of inlier counts, validity,
    inliers / outliers and the log string."""
    r = V[:4]
    c = Cost.from_residuals(_t(r), 0.5)
    jc = JCost.from_residuals(_j(r), 0.5)
    _close((c.cost, c.num_residuals, c.inlier_ratio),
           (jc.cost, jc.num_residuals, jc.inlier_ratio))
    a = Cost.make(_t(2.0), 4, 0.75, "a")
    b = Cost.make(_t(3.0), 6, 0.5, "b")
    ja = JCost.make(2.0, 4, 0.75, "a")
    jb = JCost.make(3.0, 6, 0.5, "b")
    s, js = a + b, ja + jb
    _close((s.cost, s.num_residuals, s.inlier_ratio, s.num_inliers(),
            s.num_outliers(), s.is_valid()),
           (js.cost, js.num_residuals, js.inlier_ratio, js.num_inliers(),
            js.num_outliers(), js.is_valid()))
    assert s.log_str == js.log_str == "a b"
    for pi in (False, True):
        assert s.to_string(print_inliers=pi) == js.to_string(
            print_inliers=pi)
    empty = Cost.make(_t(0.0), 0) + Cost.make(_t(0.0), 0)
    assert float(empty.inlier_ratio) == 1.0 and not bool(empty.is_valid())
    assert not bool(Cost.make(_t(np.finfo(np.float64).max), 3).is_valid())
    # batched counts keep the batch axis
    bc = Cost.make(_t([1.0, 2.0, 3.0]), 5, 0.6)
    assert bc.num_inliers().tolist() == [3, 3, 3]


def _rosen_t(p):
    return torch.stack([1.0 - p[0], 10.0 * (p[1] - p[0] * p[0])])


def _rosen_j(p):
    return jnp.stack([1.0 - p[0], 10.0 * (p[1] - p[0] * p[0])])


@pytest.mark.parametrize("method", ["FORWARD", "CENTRAL", "FAST_CENTRAL"])
def test_num_eval_matches_jax(method):
    """Finite differences through the retraction: the same evaluations as
    JAX's ``num_eval`` (1e-9: a difference of nearly equal values over
    h = 1e-7 magnifies rounding), and near automatic differentiation (as
    tests/test_diff.py:29-34)."""
    x = np.array([0.3, -1.2])
    m, jm = tdiff.Method[method], jdiff.Method[method]
    r, J = tdiff.num_eval(_rosen_t, _t(x), m)
    jr, jJ = jdiff.num_eval(_rosen_j, _j(x), jm)
    _close((r, J), (jr, jJ), rtol=1e-9, atol=1e-9)
    _, J_ad = tdiff.residual_jacobian(_rosen_t, _t(x))
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(),
                               atol=1e-4 if method == "FORWARD" else 1e-6)
    # on SO3's tangent space (tests/test_diff.py:42-55)
    w = np.array([0.2, -0.1, 0.3])
    R = so3_from_numpy(JSO3.exp(_j(w)).wxyz, device="cpu",
                       dtype=torch.float64)
    jR = JSO3.exp(_j(w))
    p = np.array([1.0, 2.0, 3.0])
    _, J = tdiff.num_eval(lambda rot: rot.apply(_t(p)), R, m)
    _, jJ = jdiff.num_eval(lambda rot: rot.apply(_j(p)), jR, jm)
    _close(J, jJ, rtol=1e-8, atol=1e-8)
    assert tdiff.estimate_num_jac(_rosen_t, _t(x), m).shape == (2, 2)


def test_num_diff_system_batched():
    """The batch-native system: H = JᵀJ and g = Jᵀr of each instance equal
    the single-instance finite differences; first_order gives no H."""
    xs = torch.tensor([[0.3, -1.2], [1.0, 1.0], [-0.5, 2.0]],
                      dtype=torch.float64)
    acc, ev, n = tdiff.make_num_diff_system(_rosen_t, xs[0])
    H, g, cost = acc(xs)
    assert n == 2 and H.shape == (3, 2, 2) and g.shape == (3, 2)
    for b in range(3):
        r, J = tdiff.num_eval(_rosen_t, xs[b])
        np.testing.assert_allclose(H[b].numpy(), (J.T @ J).numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(g[b].numpy(), (J.T @ r).numpy(),
                                   rtol=1e-12)
    assert torch.equal(ev(xs).cost, cost.cost)
    acc1, _, _ = tdiff.make_num_diff_system(_rosen_t, xs[0],
                                            first_order=True)
    assert acc1(xs)[0] is None


def test_gradient_check_matches_jax():
    """The checker catches a wrong gradient (3x where 2x is right), passes
    a right one, and checks residuals' JᵀR and JᵀJ; its differences
    equal JAX's."""
    x = np.array([1.0, 2.0])

    def bad_t(v):
        return torch.sum(v * v), 3.0 * v

    def bad_j(v):
        return jnp.sum(v * v), 3.0 * v

    res = tdiff.check_gradient(_t(x), bad_t)
    jres = jdiff.check_gradient(_j(x), bad_j)
    assert not res.ok and not jres.ok and res.max_grad_diff > 0.5
    assert res.max_grad_diff == pytest.approx(jres.max_grad_diff, rel=1e-6)
    good = tdiff.check_gradient(_t(x), lambda v: (torch.sum(v * v),
                                                  2.0 * v))
    assert good.ok
    # the cost slot as a (cost, n) pair
    assert tdiff.check_gradient(_t(x), lambda v: ((torch.sum(v * v), 2),
                                                  2.0 * v)).ok
    rc = tdiff.check_residuals_gradient(_t([0.3, -1.2]), _rosen_t)
    jrc = jdiff.check_residuals_gradient(_j([0.3, -1.2]), _rosen_j)
    assert rc.ok and jrc.ok
    assert rc.max_h_diff == pytest.approx(jrc.max_h_diff, abs=1e-9)
    with pytest.raises(ValueError):
        tdiff.check_gradient(_t(x), lambda v: torch.sum(v * v))


def _solve_pair(tfn, jfn, x0, jopts, mode="auto", x_t=None):
    ref = jto.optimize(_j(x0) if x_t is None else x0[1], jfn, jopts,
                       mode=mode)
    got = to.optimize(_t(x0) if x_t is None else x_t, tfn,
                      options_from_reference(jopts), mode=mode)
    return ref, got


def _assert_solve(ref, got, x_tol=1e-6):
    """Stop reason equal, iterations within 1, x to 1e-6."""
    (xr, outr), (xg, outg) = ref, got
    assert int(outg.stop_reason) == int(outr.stop_reason)
    assert abs(int(outg.num_iters) - int(outr.num_iters)) <= 1
    _close(xg, xr, rtol=0, atol=x_tol)
    assert bool(outg.num_diff_used) == bool(outr.num_diff_used)


def test_numdiff_mode_matches_jax():
    """mode="numdiff": sqrt2 (tests/test_diff.py:63-68) and Rosenbrock,
    and a batch through ``batched_optimize`` with per-instance data."""
    opts = jto.Options(max_iters=50, max_consec_failures=0)
    ref, got = _solve_pair(lambda x: x * x - 2.0, lambda x: x * x - 2.0,
                           np.float64(1.0), opts, "numdiff")
    _assert_solve(ref, got)
    assert got[1].num_diff_used and bool(got[1].converged())
    ref, got = _solve_pair(_rosen_t, _rosen_j, np.array([-1.2, 1.0]), opts,
                           "numdiff")
    _assert_solve(ref, got)
    # a batch of curves with data (examples/robust_curve_fit.py's model)
    data, x0 = tcf.make_curve_batch(6, n=20, dtype=torch.float64, seed=3,
                                    device="cpu")

    def j_curve(x, d):
        return x[0] * jnp.exp(x[1] * d[0]) - d[1]

    xr, outr = jto.batched_optimize(_j(x0.numpy()), j_curve, opts,
                                    data_batch=(_j(data.t.numpy()),
                                                _j(data.y.numpy())),
                                    mode="numdiff")
    xg, outg = to.batched_optimize(x0, tcf.exp_residuals,
                                   options_from_reference(opts),
                                   data_batch=data, mode="numdiff")
    np.testing.assert_array_equal(outg.stop_reason.numpy(),
                                  np.asarray(outr.stop_reason))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= 1
    np.testing.assert_allclose(xg.numpy(), np.asarray(xr), atol=1e-6)
    assert outg.num_diff_used


class _NoJvp(torch.autograd.Function):
    """x², with a backward and no forward-mode rule: ``torch.func.jacfwd``
    cannot differentiate it, ``vmap`` can map it."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x * x

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 2.0 * x * g


@jax.custom_vjp
def _j_sq(x):
    return x * x


_j_sq.defvjp(lambda x: (x * x, x), lambda x, g: (2.0 * x * g,))


def test_ad_fallback_to_numdiff_matches_jax():
    """A residual that automatic differentiation cannot push forward (no
    jvp rule) is solved by finite differences, with
    ``Output.num_diff_used`` set, as the JAX package falls back
    (tinyopt_tpu/optimize.py:126-142)."""
    opts = jto.Options(max_iters=50, max_consec_failures=0)
    x0 = np.array([1.0, 0.5])
    ref, got = _solve_pair(lambda x: _NoJvp.apply(x) - torch.tensor([2.0, 3.0],
                                                                   dtype=x.dtype),
                           lambda x: _j_sq(x) - jnp.array([2.0, 3.0]),
                           x0, opts)
    assert ref[1].num_diff_used
    _assert_solve(ref, got)
    # a differentiable residual keeps automatic differentiation
    _, out = to.optimize(_t(x0), lambda x: x * x - 2.0)
    assert not out.num_diff_used
    # batched_optimize with the fused solver falls back to the loop
    xs = _t([[1.0, 0.5], [2.0, 1.0]])
    fused = options_from_reference(jto.Options(
        max_iters=50, max_consec_failures=0,
        hessian=jto.HessianOptions(solver="fused", save_last=False,
                                   carry_system=False)))
    xb, ob = to.batched_optimize(
        xs, lambda x: _NoJvp.apply(x) - torch.tensor([2.0, 3.0],
                                                     dtype=x.dtype), fused)
    assert ob.num_diff_used and bool(torch.all(ob.converged()))
    np.testing.assert_allclose(xb.abs().numpy(),
                               np.sqrt([[2.0, 3.0], [2.0, 3.0]]), atol=1e-6)


def test_acc_mode_matches_jax():
    """Manual accumulation functions (tests/test_sqrt2.py:24-78): auto
    detection by shape, (cost, n) pairs, an upper-triangle-only H with
    ``H_is_full=False``, and a robust_cost Cost whose inlier ratio reaches
    the output (tests/test_losses.py:266-290)."""
    opts = jto.Options(max_iters=20, max_consec_failures=0)

    def acc_t(x):
        res = x[0] * x[0] - 2.0
        J = 2.0 * x[0]
        return res * res, torch.stack([J * res]), torch.stack(
            [torch.stack([J * J])])

    def acc_j(x):
        res = x[0] * x[0] - 2.0
        J = 2.0 * x[0]
        return res * res, jnp.array([J * res]), jnp.array([[J * J]])

    for x0 in (0.5, 3.0):
        ref, got = _solve_pair(acc_t, acc_j, np.array([x0]), opts)
        _assert_solve(ref, got)
        assert bool(got[1].converged())

    def system_t(x):
        r = torch.stack([x[0] * x[0] - 2.0, x[0] * x[1] - 2.0, x[1] - 1.0])
        z = torch.zeros((), dtype=x.dtype)
        J = torch.stack([torch.stack([2.0 * x[0], z]),
                         torch.stack([x[1], x[0]]),
                         torch.stack([z, z + 1.0])])
        return r, J

    def upper_t(x):
        r, J = system_t(x)
        H = J.T @ J
        return (torch.sum(r * r), 3), J.T @ r, torch.triu(H) - 7.0 * \
            torch.tril(H, -1)

    def full_t(x):
        r, J = system_t(x)
        return (torch.sum(r * r), 3), J.T @ r, J.T @ J

    upper = dataclasses.replace(
        opts, hessian=dataclasses.replace(opts.hessian, H_is_full=False))
    xf, outf = to.optimize(_t([3.0, 1.0]), full_t,
                           options_from_reference(opts), mode="acc")
    xu, outu = to.optimize(_t([3.0, 1.0]), upper_t,
                           options_from_reference(upper), mode="acc")
    assert bool(outu.succeeded()) and torch.equal(xf, xu)
    assert int(outf.final_cost.num_residuals) == 3

    y = _t([0.0, 0.1, -0.1, 10.0])             # one gross outlier

    def robust_acc(x):
        c = tl.robust_cost(x - y, tl.huber, 0.25)
        f = lambda v: tl.robust_cost(v - y, tl.huber, 0.25).cost  # noqa
        return (c, torch.func.grad(f)(x),
                torch.func.hessian(f)(x) + torch.eye(1, dtype=x.dtype)
                * 1e-9)

    x, out = to.optimize(_t([0.5]), robust_acc, options_from_reference(
        jto.Options(max_iters=40, max_consec_failures=0)), mode="acc")
    assert bool(out.succeeded()) and abs(float(x[0])) < 0.2
    assert float(out.final_cost.inlier_ratio) == pytest.approx(0.75)


def test_mode_dispatch():
    """``mode="cost"`` with LM raises the JAX package's ValueError
    (tinyopt_tpu/optimize.py:147-152), as does an unknown mode; a residual
    tuple that is not (cost, grad (dims,), H (dims, dims)) stays
    residuals; the first-order solvers are not ported yet."""
    from tinyopt_tpu_torch.optimize import _detect_mode
    with pytest.raises(ValueError):
        to.optimize(_t([1.0, 2.0]), lambda x: torch.sum(x * x), mode="cost")
    with pytest.raises(ValueError):
        to.optimize(_t([1.0]), lambda x: x, mode="acc_grad")
    opts = to.Options()
    x = _t([1.0, 2.0])
    assert _detect_mode(lambda v: (v, v), x, opts, 2) == "residuals"
    assert _detect_mode(lambda v: (v.sum(), v, torch.eye(2)), x, opts,
                        2) == "acc"
    assert _detect_mode(lambda v: ((v.sum(), 2), v, torch.eye(2)), x, opts,
                        2) == "acc"
    assert _detect_mode(lambda v: (v.sum(), v, torch.eye(3)), x, opts,
                        2) == "residuals"
    # GD on a 2-element manual accumulation (cost, grad) solves as the JAX
    # package's does
    jo = jto.Options(solver_type=jto.GradientDescent)
    xr, outr = jto.optimize(jnp.asarray([1.0, 2.0]), lambda v: (v.sum(), v),
                            jo)
    xg, outg = to.optimize(x, lambda v: (v.sum(), v),
                           options_from_reference(jo))
    np.testing.assert_allclose(xg.numpy(), np.asarray(xr), rtol=1e-12)
    assert int(outg.num_iters) == int(outr.num_iters)
    assert int(outg.stop_reason) == int(outr.stop_reason)
    np.testing.assert_allclose(outg.errs_list, outr.errs_list, rtol=1e-12)


@pytest.mark.parametrize("name", ["rosenbrock_cost", "plateau_cost",
                                  "easom_cost"])
def test_easy_suite_costs_match_jax(name):
    for p in (np.array([0.3, -1.2]), np.array([3.0, 3.2]),
              np.array([-2.0, 5.0])):
        _close(getattr(tp, name)(_t(p)), getattr(jp, name)(_j(p)))


def test_curve_fit_model_matches_example():
    """The curve-fit model (models/curve_fit.py) against
    examples/robust_curve_fit.py's functions on the same points: the
    residuals, and the Huber and Geman-McClure fits of a few curves
    through the loop ("cg"), float64: x to 1e-6, stop reasons equal,
    iterations within 1; the robust fits nearer (1.7, 0.8)."""
    data, x0 = tcf.make_curve_batch(4, n=30, dtype=torch.float64, seed=1,
                                    device="cpu")
    t, y = jnp.asarray(data.t.numpy()), jnp.asarray(data.y.numpy())

    def j_res(x, d):
        return x[0] * jnp.exp(x[1] * d[0]) - d[1]

    def j_huber(x, d):
        return jax.vmap(lambda r: jl.robust_whiten(r[None], jl.huber,
                                                   tcf.TH2))(j_res(x, d))

    def j_gm(x, d):
        return jax.vmap(lambda r: jl.robust_whiten(
            r[None], jl.geman_mcclure, tcf.TH2))(j_res(x, d))

    one = tcf.CurveData(data.t[0], data.y[0])
    xv = torch.tensor([1.2, 0.7], dtype=torch.float64)
    _close(tcf.huber_residuals(xv, one), j_huber(_j(xv.numpy()),
                                                 (t[0], y[0])))
    opts = jto.Options(max_iters=100, max_consec_failures=0,
                       hessian=jto.HessianOptions(solver="cg"))
    topts = options_from_reference(opts)
    fits = {}
    for name, tfn, jfn in (("ls", tcf.exp_residuals, j_res),
                           ("huber", tcf.huber_residuals, j_huber),
                           ("gm", tcf.geman_mcclure_residuals, j_gm)):
        start = fits["huber"] if name == "gm" else x0
        xr, outr = jto.batched_optimize(_j(start.numpy()), jfn, opts,
                                        data_batch=(t, y))
        xg, outg = to.batched_optimize(start, tfn, topts, data_batch=data)
        np.testing.assert_array_equal(outg.stop_reason.numpy(),
                                      np.asarray(outr.stop_reason))
        assert np.max(np.abs(outg.num_iters.numpy()
                             - np.asarray(outr.num_iters))) <= 1
        np.testing.assert_allclose(xg.numpy(), np.asarray(xr), atol=1e-6)
        fits[name] = xg
    true = torch.tensor(tcf.TRUE_AB, dtype=torch.float64)
    err = {k: (v - true).abs().sum(-1) for k, v in fits.items()}
    assert bool(torch.all(err["huber"] < err["ls"]))
    assert bool(torch.all(err["gm"] < err["ls"]))
