"""The residuals on manifold parameters of ``chip_smoke.py`` phase 22, in
both packages, and their seeded inputs: shared by
``tests/test_torch_codegen_manifold.py`` and
``tests/test_torch_fused_manifold.py`` (not collected by pytest).

``se3_prior``: tests/test_fused.py:317-319's SE3 pose prior (P, D, n_res
= 7, 6, 6); ``se3_bias``: its {SE3, bias} pytree (:350-351; 9, 8, 8);
``so3_cycle``: one batched SO3 leaf of 4 rotations, an anchor prior and
the 4 relative-rotation logs of a cycle (16, 12, 15); ``se23_prior`` and
``sen3_prior`` (n = 2): (prior⁻¹ @ X).log(), the prior's inverse as
data (10, 9, 9); ``icp_huber`` /
``icp_plain``: ``models.icp.icp_residual`` on 16 points with and without
Huber whitening at 0.05 (7, 6, 48), 3 of each instance's targets
displaced by 0.5·N(0, 1).  :func:`solve_both` solves a case with the JAX
package's fused kernel in interpret mode and with the port's fused path
(float64, the states carried across by ``interop``)."""

import numpy as np

NAMES = ("se3_prior", "se3_bias", "so3_cycle", "se23_prior", "sen3_prior",
         "icp_huber", "icp_plain")
#: (P, D, n_res) of each case
WIDTHS = {"se3_prior": (7, 6, 6), "se3_bias": (9, 8, 8),
          "so3_cycle": (16, 12, 15), "se23_prior": (10, 9, 9),
          "sen3_prior": (10, 9, 9), "icp_huber": (7, 6, 48),
          "icp_plain": (7, 6, 48)}
ICP_POINTS, ICP_OUTLIERS, ICP_TH = 16, 3, 0.05


def _lib(pkg):
    """(concatenate, SO3, SE3, SE23, SEn3, icp_residual) of a package."""
    if pkg == "torch":
        import torch
        from tinyopt_tpu_torch.manifolds import SE3, SE23, SO3, SEn3
        from tinyopt_tpu_torch.models.icp import icp_residual
        return torch.cat, SO3, SE3, SE23, SEn3, icp_residual
    import jax.numpy as jnp
    from tinyopt_tpu.manifolds import SE3, SE23, SO3, SEn3
    from tinyopt_tpu.models.icp import icp_residual
    return jnp.concatenate, SO3, SE3, SE23, SEn3, icp_residual


def residual(name, pkg="torch"):
    """The residual of case ``name`` in package ``pkg`` ("torch" or
    "jax")."""
    cat, SO3, SE3, SE23, SEn3, icp_residual = _lib(pkg)

    def se3_prior(T, d):
        q_inv, t_inv = d
        return (SE3(SO3(q_inv), t_inv) @ T).log()

    def se3_bias(x, d):
        return cat([x["T"].log(), 2.0 * (x["bias"] - d)])

    def so3_cycle(R, d):
        # d: the anchor's and the relative rotations' inverses; R_i⁻¹ as
        # the conjugate (the JAX kernel takes no closed-over constant, such
        # as SO3.inverse's signs)
        anchor_inv, rel_inv = d
        w = R.wxyz
        w_inv = cat([w[:, :1], -w[:, 1:]], -1)
        first = (SO3(anchor_inv) @ SO3(w[0])).log()
        step = SO3(w_inv) @ SO3(cat([w[1:], w[:1]]))
        return cat([first, (SO3(rel_inv) @ step).log().reshape(-1)])

    def se23_prior(X, d):
        return (SE23(SO3(d[0]), d[1], d[2]) @ X).log()

    def sen3_prior(X, d):
        return (SEn3(SO3(d[0]), d[1]) @ X).log()

    def icp_huber(T, d):
        return icp_residual(T, d.points, d.targets, robust_th=ICP_TH)

    def icp_plain(T, d):
        return icp_residual(T, d.points, d.targets)

    return locals()[name]


def draws(name, B, seed):
    """The case's seeded tangents and vectors (numpy, float64)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=(B,) + shape)
    if name == "se3_prior":
        return dict(x=0.2 * n(6), prior=0.4 * n(6))
    if name == "se3_bias":
        return dict(x=0.1 * n(6), bias=n(2), tgt=n(2))
    if name == "so3_cycle":
        return dict(x=0.3 * n(4, 3), anchor=0.2 * n(3), rel=0.3 * n(4, 3))
    if name in ("se23_prior", "sen3_prior"):
        return dict(x=0.2 * n(9), prior=0.3 * n(9))
    # icp: the flagship's points (uniform), true tangents, starts 0.1·N
    # off, then 3 targets of each instance displaced by 0.5·N(0, 1)
    return dict(points=rng.uniform(-1, 1, (B, ICP_POINTS, 3)),
                true=rng.uniform(-0.5, 0.5, (B, 6)), start=0.1 * n(6),
                noise=1e-3 * n(ICP_POINTS, 3),
                out=0.5 * n(ICP_OUTLIERS, 3))


def inputs(name, B, seed, pkg="torch", dtype=None):
    """(x0, data) of case ``name``: ``B`` instances built by ``pkg``'s
    manifolds from :func:`draws` (float64, or ``dtype`` for torch, on the
    CPU)."""
    cat, SO3, SE3, SE23, SEn3, _ = _lib(pkg)
    dr = draws(name, B, seed)
    if pkg == "torch":
        import torch
        dt = dtype or torch.float64

        def arr(a):
            return torch.as_tensor(a, dtype=dt)
    else:
        import jax.numpy as jnp

        def arr(a):
            return jnp.asarray(a, dtype=jnp.float64)
    if name == "se3_prior":
        inv = SE3.exp(arr(dr["prior"])).inverse()
        return SE3.exp(arr(dr["x"])), (inv.rotation.wxyz, inv.translation)
    if name == "se3_bias":
        return ({"T": SE3.exp(arr(dr["x"])), "bias": arr(dr["bias"])},
                arr(dr["tgt"]))
    if name == "so3_cycle":
        return SO3.exp(arr(dr["x"])), (
            SO3.exp(arr(dr["anchor"])).inverse().wxyz,
            SO3.exp(arr(dr["rel"])).inverse().wxyz)
    if name == "se23_prior":
        p = SE23.exp(arr(dr["prior"])).inverse()
        return SE23.exp(arr(dr["x"])), (p.rotation.wxyz, p.velocity,
                                         p.position)
    if name == "sen3_prior":
        p = SEn3.exp(arr(dr["prior"])).inverse()
        return SEn3.exp(arr(dr["x"])), (p.rotation.wxyz, p.vectors)
    true = SE3.exp(arr(dr["true"]))
    pts = arr(dr["points"])
    rot = SO3(true.rotation.wxyz[:, None, :])
    tgt = rot.apply(pts) + true.translation[:, None, :] + arr(dr["noise"])
    if name == "icp_huber":      # icp_plain keeps the clean targets
        tgt = cat([tgt[:, :ICP_OUTLIERS] + arr(dr["out"]),
                   tgt[:, ICP_OUTLIERS:]], 1)
    if pkg == "torch":
        from tinyopt_tpu_torch.models.se3_refinement import SE3RefinementData
    else:
        from tinyopt_tpu.models.se3_refinement import SE3RefinementData
    return (SE3.exp(arr(dr["true"] + dr["start"])),
            SE3RefinementData(pts, tgt))


def jax_options(dogleg=False):
    """``bench_se3``'s options on "fused" (the JAX package's)."""
    import tinyopt_tpu as jto
    return jto.Options(
        max_iters=10, max_consec_failures=3,
        solver_type=jto.DogLeg if dogleg else jto.LevenbergMarquardt,
        hessian=jto.HessianOptions(save_last=False, solver="fused",
                                   carry_system=False))


def to_port(name, jx, jd):
    """The JAX case's (x0, data) on the port (float64, on the CPU),
    through ``interop``."""
    import torch
    from torch.utils import _pytree as pytree

    from tinyopt_tpu_torch.interop import (se3_from_numpy, se23_from_numpy,
                                           se3_refinement_data_from_numpy,
                                           sen3_from_numpy, so3_from_numpy)
    a = np.asarray
    kw = dict(device="cpu", dtype=torch.float64)
    if name in ("se3_prior", "icp_huber", "icp_plain"):
        x = se3_from_numpy(a(jx.rotation.wxyz), a(jx.translation), **kw)
    elif name == "se3_bias":
        x = {"T": se3_from_numpy(a(jx["T"].rotation.wxyz),
                                 a(jx["T"].translation), **kw),
             "bias": torch.tensor(a(jx["bias"]))}
    elif name == "so3_cycle":
        x = so3_from_numpy(a(jx.wxyz), **kw)
    elif name == "se23_prior":
        x = se23_from_numpy(a(jx.rotation.wxyz), a(jx.velocity),
                            a(jx.position), **kw)
    else:
        x = sen3_from_numpy(a(jx.rotation.wxyz), a(jx.vectors), **kw)
    if name.startswith("icp"):
        return x, se3_refinement_data_from_numpy(a(jd.points),
                                                 a(jd.targets), **kw)
    return x, pytree.tree_map(lambda v: torch.tensor(a(v)), jd)


def solve_both(name, B, seed, dogleg=False):
    """Case ``name`` (``B`` instances of ``seed``) solved by the JAX
    package's fused kernel in interpret mode and by the port's
    ``batched_optimize`` (the twin on the CPU): ((x, Output) of JAX, of
    the port, the port's x0, data and options)."""
    import jax

    import tinyopt_tpu_torch as to
    from tinyopt_tpu.ops.pallas_solver import fused_batched_solver
    from tinyopt_tpu_torch.interop import options_from_reference
    opts = jax_options(dogleg)
    jx, jd = inputs(name, B, seed, pkg="jax")
    ex = jax.tree_util.tree_map(lambda v: v[0], (jx, jd))
    ref = fused_batched_solver(residual(name, "jax"), opts, *ex,
                               interpret=True)(jx, jd)
    tx, td = to_port(name, jx, jd)
    topts = options_from_reference(opts)
    got = to.batched_optimize(tx, residual(name), topts, data_batch=td)
    return ref, got, tx, td, topts


def flat(x):
    """Every stored value of a batched parameter pytree of either package,
    (B, P) numpy, in the JAX order (a dict's keys sorted)."""
    import jax
    from torch.utils import _pytree as pytree
    if isinstance(x, dict):
        return np.concatenate([flat(x[k]) for k in sorted(x)], axis=-1)
    leaves = (jax.tree_util.tree_leaves(x)
              if type(x).__module__.startswith("tinyopt_tpu.")
              else pytree.tree_leaves(x))
    return np.concatenate([np.asarray(v).reshape(np.shape(v)[0], -1)
                           for v in leaves], axis=-1)
