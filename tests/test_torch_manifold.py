"""The manifolds of tinyopt_tpu_torch (SO3, SE23, SE3, SEn3, the registry and
the flat layouts) against the JAX package's, on the same inputs made with
numpy, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import tinyopt_tpu as jto
from tinyopt_tpu import manifold as jmf
from tinyopt_tpu.manifolds import SE3 as JSE3
from tinyopt_tpu.manifolds import SE23 as JSE23
from tinyopt_tpu.manifolds import SEn3 as JSEn3
from tinyopt_tpu.manifolds import SO3 as JSO3

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       se3_from_numpy, sen3_from_numpy,
                                       so3_from_numpy)
from tinyopt_tpu_torch.manifolds import SE3, SE23, SO3, SEn3

torch.set_num_threads(1)

RTOL = 1e-12
#: θ² below and above the float64 small-angle threshold sqrt(eps) ≈ 1.5e-8
#: (so3._small), θ = 0, generic angles and 180°.
ANGLES = (0.0, 1e-5, 3e-4, 0.3, 2.0, np.pi)


def _rotvecs(seed):
    """Rotation vectors (n, 3): each angle of ANGLES on random axes."""
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(len(ANGLES) * 2, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    return np.repeat(np.asarray(ANGLES), 2)[:, None] * ax


def _close(got, ref, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def test_so3_maps_match_reference():
    w = _rotvecs(0)
    rng = np.random.default_rng(1)
    p = rng.normal(size=(len(w), 3))
    jr, tr = JSO3.exp(jnp.asarray(w)), SO3.exp(_t(w))
    _close(tr.wxyz, jr.wxyz)
    _close(tr.log(), jr.log())
    _close(tr.matrix(), jr.matrix())
    _close(tr.apply(_t(p)), jr.apply(jnp.asarray(p)))
    _close((tr @ tr.inverse()).wxyz, (jr @ jr.inverse()).wxyz)
    _close((tr @ _t(p)), (jr @ jnp.asarray(p)))
    _close(tr.normalized().wxyz, jr.normalized().wxyz)
    # from_matrix through every Shepperd branch, 180° included
    _close(SO3.from_matrix(_t(jr.matrix())).wxyz,
           JSO3.from_matrix(jr.matrix()).wxyz)
    assert SO3.identity(torch.float64, (2,)).wxyz.tolist() == [
        [1.0, 0.0, 0.0, 0.0]] * 2
    # a quaternion carried across with interop
    _close(so3_from_numpy(np.asarray(jr.wxyz), device="cpu",
                          dtype=torch.float64).log(), jr.log())


def test_se3_and_se23_maps_match_reference():
    w = _rotvecs(2)
    rng = np.random.default_rng(3)
    rho = rng.normal(size=(len(w), 3))
    nu = rng.normal(size=(len(w), 3))
    p = rng.normal(size=(len(w), 3))
    d6 = np.concatenate([rho, w], -1)
    jT, tT = JSE3.exp(jnp.asarray(d6)), SE3.exp(_t(d6))
    _close(tT.rotation.wxyz, jT.rotation.wxyz)
    _close(tT.translation, jT.translation)
    _close(tT.log(), jT.log(), rtol=1e-10, atol=1e-12)
    _close(tT.matrix(), jT.matrix())
    _close(tT.apply(_t(p)), jT.apply(jnp.asarray(p)))
    _close((tT @ tT.inverse()).translation, (jT @ jT.inverse()).translation)
    _close((tT @ _t(p)), (jT @ jnp.asarray(p)))
    tc = se3_from_numpy(np.asarray(jT.rotation.wxyz),
                        np.asarray(jT.translation), device="cpu",
                        dtype=torch.float64)
    _close(tc.translation, jT.translation)
    d9 = np.concatenate([nu, rho, w], -1)
    jX, tX = JSE23.exp(jnp.asarray(d9)), SE23.exp(_t(d9))
    _close(tX.velocity, jX.velocity)
    _close(tX.position, jX.position)
    _close(tX.log(), jX.log(), rtol=1e-10, atol=1e-12)
    _close((tX @ tX.inverse()).position, (jX @ jX.inverse()).position)


@pytest.mark.parametrize("kind", ["SO3", "SE3", "SE23"])
def test_retract_and_local_match_reference(kind):
    """``retract`` / ``local`` of one element through the registry, at
    every angle of ANGLES, and the flat ``retract_flat`` of the port equal
    to its pytree ``retract``."""
    rng = np.random.default_rng({"SO3": 4, "SE3": 5, "SE23": 6}[kind])
    n = {"SO3": 3, "SE3": 6, "SE23": 9}[kind]
    jcls, tcls = {"SO3": (JSO3, SO3), "SE3": (JSE3, SE3),
                  "SE23": (JSE23, SE23)}[kind]
    base = rng.normal(size=n) * 0.4
    jx, tx = jcls.exp(jnp.asarray(base)), tcls.exp(_t(base))
    for w in _rotvecs(7):
        delta = np.concatenate([rng.normal(size=n - 3) * 0.3, w])
        jy = jmf.retract(jx, jnp.asarray(delta))
        ty = mf.retract(tx, _t(delta))
        for a, b in zip(jax.tree_util.tree_leaves(jy),
                        torch.utils._pytree.tree_leaves(ty)):
            _close(b, a)
        _close(mf.local(tx, ty), jmf.local(jx, jy), rtol=1e-9, atol=1e-11)
        spec = mf.tangent_spec(tx)
        flat = mf.flatten_batch(
            torch.utils._pytree.tree_map(lambda a: a[None], tx), spec)[0]
        _close(mf.retract_flat(flat, _t(delta), spec),
               mf.flatten_values(ty))


def test_tangent_spec_layouts():
    """P stored values and D tangent dimensions with offsets in each, for
    a manifold leaf, a mixed pytree and a plain tensor."""
    spec = mf.tangent_spec(SE3.identity(torch.float64))
    assert (spec.params, spec.dims, spec.has_manifold) == (7, 6, True)
    assert spec.shapes == ((4,), (3,)) and spec.leaf_dims == (6,)
    # keys in sorted order: JAX flattens a dict so, torch in insertion order
    x = {"R": SO3.identity(torch.float64), "T": SE3.identity(torch.float64),
         "bias": torch.zeros(2, dtype=torch.float64)}
    spec = mf.tangent_spec(x)
    jspec = jmf.tangent_spec({"T": JSE3.identity(jnp.float64),
                              "bias": jnp.zeros(2, jnp.float64),
                              "R": JSO3.identity(jnp.float64)})
    assert (spec.leaf_dims, spec.offsets, spec.dims) == (
        jspec.leaf_dims, jspec.offsets, jspec.dims)
    assert spec.params == 4 + 7 + 2 and spec.dtype == torch.float64
    assert [b.p_offset for b in spec.blocks] == [0, 4, 11]
    assert [b.t_offset for b in spec.blocks] == [0, 3, 9]
    spec = mf.tangent_spec(torch.zeros(5))
    assert (spec.params, spec.dims, spec.has_manifold) == (5, 5, False)
    assert mf.zero_tangent(x).shape == (11,)
    assert torch.equal(mf.retract_flat(torch.ones(2, 5), torch.ones(2, 5),
                                       spec), torch.full((2, 5), 2.0))
    with pytest.raises(ValueError):
        mf.tangent_spec(torch.zeros(3, dtype=torch.int64))
    kept = mf.as_pytree({"T": SE3.identity(), "s": 2})
    assert isinstance(kept["T"], SE3) and kept["s"].dtype.is_floating_point


def test_retraction_jvp_at_zero_matches_reference():
    """The jvp of δ ↦ x ⊞ δ at δ = 0 (what every linearization
    differentiates) is finite and equals JAX's, on a pose and at the
    identity (θ = 0 in both exp maps)."""
    rng = np.random.default_rng(8)
    for base in (np.zeros(6), rng.normal(size=6) * 0.5):
        jx, tx = JSE3.exp(jnp.asarray(base)), SE3.exp(_t(base))
        spec = mf.tangent_spec(tx)
        flat = mf.flatten_values(tx)
        for v in np.eye(6):
            _, jt = jax.jvp(lambda d: jmf.flatten_values(jmf.retract(jx, d)),
                            (jnp.zeros(6),), (jnp.asarray(v),))
            _, tt = torch.func.jvp(lambda d: mf.retract_flat(flat, d, spec),
                                   (torch.zeros(6, dtype=torch.float64),),
                                   (_t(v),))
            assert bool(torch.all(torch.isfinite(tt)))
            _close(tt, jt)
        # and the vjp (what the fused path transposes)
        u = rng.normal(size=7)
        _, jv = jax.vjp(lambda d: jmf.flatten_values(jmf.retract(jx, d)),
                        jnp.zeros(6))
        _, tv = torch.func.vjp(lambda d: mf.retract_flat(flat, d, spec),
                               torch.zeros(6, dtype=torch.float64))
        _close(tv(_t(u))[0], jv(jnp.asarray(u))[0])


# ---- SEn3 (tests/test_se3.py:199, class TestSEn3) ----

class TestSEn3:
    """Generic SEn3⟨n⟩ against the JAX package's ``manifolds.SEn3``."""

    def test_exp_log_match_reference_various_n(self):
        rng = np.random.default_rng(3)
        for n in (1, 2, 3, 4):
            d = rng.uniform(-1.0, 1.0, (3, 3 * (n + 1)))
            d[0, -3:] = 0.0                   # θ = 0: the Taylor branch
            jX, tX = JSEn3.exp(jnp.asarray(d)), SEn3.exp(_t(d))
            _close(tX.rotation.wxyz, jX.rotation.wxyz)
            _close(tX.vectors, jX.vectors)
            _close(tX.log(), jX.log(), rtol=1e-10, atol=1e-12)
            _close(tX.log(), d, rtol=1e-10, atol=1e-10)

    def test_matches_se23(self):
        """SEn3 with n = 2 is SE23 with [ν, ρ] stacked into .vectors."""
        d = _t(np.linspace(-0.7, 0.7, 9))
        a, b = SEn3.exp(d), SE23.exp(d)
        _close(a.rotation.wxyz, b.rotation.wxyz)
        _close(a.vectors[..., 0, :], b.velocity)
        _close(a.vectors[..., 1, :], b.position)

    def test_inverse_compose_retract_match_reference(self):
        rng = np.random.default_rng(5)
        d = rng.uniform(-0.5, 0.5, (4, 12))             # a batch of SEn3<3>
        e = rng.uniform(-0.5, 0.5, (4, 12))
        jX, tX = JSEn3.exp(jnp.asarray(d)), SEn3.exp(_t(d))
        jY, tY = JSEn3.exp(jnp.asarray(e)), SEn3.exp(_t(e))
        _close((tX @ tX.inverse()).log(), np.zeros((4, 12)), atol=1e-12)
        _close((tX.inverse() @ tY).log(), (jX.inverse() @ jY).log(),
               rtol=1e-10, atol=1e-12)
        x1 = SEn3(SO3(tX.rotation.wxyz[0]), tX.vectors[0])
        jx1 = JSEn3(JSO3(jX.rotation.wxyz[0]), jX.vectors[0])
        tr = mf.retract(x1, _t(e[0]))
        jr = jmf.retract(jx1, jnp.asarray(e[0]))
        _close(tr.rotation.wxyz, jr.rotation.wxyz)
        _close(tr.vectors, jr.vectors)
        _close(mf.local(x1, tr), jmf.local(jx1, jr), rtol=1e-10, atol=1e-12)

    def test_tangent_dims_and_interop(self):
        assert mf.tangent_spec(SEn3.identity(3)).dims == 12
        assert mf.tangent_spec(SEn3.identity(3)).params == 13
        assert mf.tangent_spec(SEn3.identity(1, batch=(5,))).dims == 30
        jX = JSEn3.exp(jnp.asarray(np.linspace(-0.3, 0.3, 12)))
        tX = sen3_from_numpy(np.asarray(jX.rotation.wxyz),
                             np.asarray(jX.vectors), device="cpu",
                             dtype=torch.float64)
        _close(tX.log(), jX.log(), rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("method", ["lm", "dogleg"])
    def test_prior_solve_n3_matches_reference(self, method):
        """An SEn3⟨3⟩ prior solve through ``optimize`` of both packages."""
        opts = jto.Options(solver_type={"lm": jto.LevenbergMarquardt,
                                        "dogleg": jto.DogLeg}[method])
        rng = np.random.default_rng(11)
        jprior = JSEn3.exp(jnp.asarray(rng.uniform(-0.8, 0.8, 12)))
        xr, outr = jto.optimize(JSEn3.identity(3, jnp.float64),
                                lambda x: (jprior @ x).log(), opts)
        prior = sen3_from_numpy(np.asarray(jprior.rotation.wxyz),
                                np.asarray(jprior.vectors), device="cpu",
                                dtype=torch.float64)
        x, out = to.optimize(SEn3.identity(3, torch.float64),
                             lambda x: (prior @ x).log(),
                             options_from_reference(opts))
        assert bool(out.converged()) and bool(outr.converged())
        assert abs(int(out.num_iters) - int(outr.num_iters)) <= 1
        _close(x.rotation.wxyz, xr.rotation.wxyz, rtol=1e-5, atol=1e-9)
        _close(x.vectors, xr.vectors, rtol=1e-5, atol=1e-9)
        assert float(torch.linalg.norm((x @ prior).log())) < 1e-5


@pytest.mark.cuda
def test_sen3_prior_batch_on_gpu():
    """chip_smoke.py phase 15 in small: a batch of SEn3⟨3⟩ prior solves on
    the card against the same solves on the CPU (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    prior = SEn3.exp(_t(rng.uniform(-0.8, 0.8, (64, 12))))

    def res(x, p):
        return (p @ x).log()

    x0 = SEn3.identity(3, torch.float64, (64,))
    got = to.batched_optimize(
        pytree.tree_map(lambda a: a.cuda(), x0), res, to.Options(),
        data_batch=pytree.tree_map(lambda a: a.cuda(), prior))
    ref = to.batched_optimize(x0, res, to.Options(), data_batch=prior)
    torch.testing.assert_close(got[0].vectors.cpu(), ref[0].vectors,
                               rtol=1e-9, atol=1e-12)
    assert torch.equal(got[1].num_iters.cpu(), ref[1].num_iters)
