"""Why a float32 flagship solve sometimes stops by its failure budget, on
the port and on the JAX package: a study on the CPU, not a test.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_se3_noise_floor.py

For each seed, the JAX package's float32 SE(3) instances
(``make_se3_refinement(10_000, 16, float32, seed)``) go through JAX's loop
and the port's loop ("cholesky", ``bench_se3``'s options), and through a
float64 solve of the same values (30 iterations) for each instance's least
cost.  Printed per seed: the instances each side stops with
MAX_CONSEC_NO_DECR, and for them and for the others the cost of the
returned pose, evaluated in float64, above that least cost (relative).
Then, at seed 0's float64 minimum rounded to float32, the float32 rounding
of r, J'J, g = J'r, the cost and the Gauss-Newton step on each side against
float64 (rms over the instances and their entries).  Last, one instance
that the port stops by its budget (``--trace seed:index``): each side's
history (the cost at each iteration and the step proposed there) and its
Jacobian at the port's returned pose beside JAX's.
"""

import argparse

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import tinyopt_tpu as jto  # noqa: E402
from tinyopt_tpu import manifold as jmf  # noqa: E402
from tinyopt_tpu.diff.auto import make_nlls_system as j_nlls  # noqa: E402
from tinyopt_tpu.diff.auto import residual_jacobian as j_jac  # noqa: E402
from tinyopt_tpu.manifolds import SE3 as JSE3  # noqa: E402
from tinyopt_tpu.manifolds import SO3 as JSO3  # noqa: E402
from tinyopt_tpu.models.se3_refinement import (  # noqa: E402
    make_se3_refinement as j_make, se3_residual as j_res)
from tinyopt_tpu.parallel.batched import batched_solver  # noqa: E402

import tinyopt_tpu_torch as to  # noqa: E402
from tinyopt_tpu_torch import manifold as mf  # noqa: E402
from tinyopt_tpu_torch.diff.auto import (  # noqa: E402
    make_nlls_system, residual_jacobian)
from tinyopt_tpu_torch.interop import (  # noqa: E402
    options_from_reference, se3_from_numpy, se3_refinement_data_from_numpy)
from tinyopt_tpu_torch.manifolds import SE3, SO3  # noqa: E402
from tinyopt_tpu_torch.models.se3_refinement import (  # noqa: E402
    SE3RefinementData, se3_residual)

MAX_CONSEC_NO_DECR = int(to.StopReason.MAX_CONSEC_NO_DECR)


def options(max_iters=10, **kw):
    return jto.Options(max_iters=max_iters, max_consec_failures=3, **kw,
                       hessian=jto.HessianOptions(save_last=False,
                                                  solver="cholesky",
                                                  carry_system=False))


def first(t):
    return jax.tree_util.tree_map(lambda a: a[0], t)


def as_f64(t):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)


def to_port(data, x):
    td = se3_refinement_data_from_numpy(np.asarray(data.points),
                                        np.asarray(data.targets),
                                        device="cpu", dtype=torch.float32)
    tx = se3_from_numpy(np.asarray(x.rotation.wxyz),
                        np.asarray(x.translation), device="cpu",
                        dtype=torch.float32)
    return td, tx


cost64 = jax.jit(jax.vmap(lambda T, d: jnp.sum(j_res(T, d) ** 2)))


def stops_and_gaps(B, seed):
    data, x0, _ = j_make(B, 16, dtype=jnp.float32, seed=seed)
    d64 = as_f64(data)
    _, o64 = jax.jit(batched_solver(j_res, options(30), "residuals",
                                    first(as_f64(x0)), first(d64)))(
        as_f64(x0), d64)
    least = np.asarray(o64.final_cost.cost)
    xj, oj = jax.jit(batched_solver(j_res, options(), "residuals", first(x0),
                                    first(data)))(x0, data)
    td, tx = to_port(data, x0)
    xp, op = to.batched_optimize(tx, se3_residual,
                                 options_from_reference(options()),
                                 data_batch=td)
    out = {}
    for who, wxyz, t, o in (
            ("jax", xj.rotation.wxyz, xj.translation, oj),
            ("port", xp.rotation.wxyz.numpy(), xp.translation.numpy(), op)):
        pose = JSE3(JSO3(jnp.asarray(np.asarray(wxyz), jnp.float64)),
                    jnp.asarray(np.asarray(t), jnp.float64))
        gap = (np.asarray(cost64(pose, d64)) - least) / least
        budget = np.asarray(o.stop_reason) == MAX_CONSEC_NO_DECR
        out[who] = (np.nonzero(budget)[0], gap[budget], gap[~budget].max())
    return out


def rounding(B):
    """f32 rounding of each side's r, J'J, g, cost and GN step at seed 0's
    float64 minimum rounded to float32."""
    data, x0, _ = j_make(B, 16, dtype=jnp.float32, seed=0)
    d64 = as_f64(data)
    xs, _ = jax.jit(batched_solver(j_res, options(30), "residuals",
                                   first(as_f64(x0)), first(d64)))(
        as_f64(x0), d64)
    x32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), xs)

    def jax_side(x, d):
        spec = jmf.tangent_spec(first(x))

        def one(xi, di):
            H, g, c = j_nlls(lambda T: j_res(T, di), xi, spec)[0](xi)
            return (j_res(xi, di), H, g, c.cost, jnp.linalg.solve(H, g))
        return [np.asarray(a, np.float64)
                for a in jax.jit(jax.vmap(one))(x, d)]

    ref = jax_side(as_f64(x32), d64)
    got_jax = jax_side(x32, data)
    td, tx = to_port(data, x32)
    x_ex = pytree.tree_map(lambda a: a[0], tx)
    spec = mf.tangent_spec(x_ex)
    acc, _, _ = make_nlls_system(
        se3_residual, x_ex, spec, data_batch=td,
        data_example=SE3RefinementData(td.points[0], td.targets[0]))
    xf = mf.flatten_batch(tx, spec)
    H, g, c = acc(xf)
    r = torch.func.vmap(
        lambda x, d: se3_residual(mf.unflatten(x, spec), d))(xf, td)
    got_port = [a.double().numpy()
                for a in (r, H, g, c.cost, torch.linalg.solve(H, g))]
    for i, name in enumerate(("r", "J'J", "g", "cost", "GN step")):
        rms = np.sqrt(np.mean(ref[i] ** 2))
        errs = [np.sqrt(np.mean((got[i] - ref[i]) ** 2))
                for got in (got_jax, got_port)]
        print(f"{name:8s} rms {rms:.3e}; f32 rounding rms: JAX {errs[0]:.3e}, "
              f"port {errs[1]:.3e}")


def trace(B, seed, i):
    """One instance's history on both sides, and J at the port's pose."""
    data, x0, _ = j_make(B, 16, dtype=jnp.float32, seed=seed)
    data, x0 = (jax.tree_util.tree_map(lambda a: a[i:i + 1], t)
                for t in (data, x0))
    o = options(save_history=True)
    _, oj = jax.jit(batched_solver(j_res, o, "residuals", first(x0),
                                   first(data)))(x0, data)
    td, tx = to_port(data, x0)
    xp, op = to.batched_optimize(tx, se3_residual, options_from_reference(o),
                                 data_batch=td)
    for who, out in (("jax", oj), ("port", op)):
        n = int(np.asarray(out.num_hist)[0])
        print(f"seed {seed} instance {i} {who}: stop "
              f"{int(np.asarray(out.stop_reason)[0])}; cost "
              f"{np.asarray(out.errs)[0, :n].tolist()}; |step|^2 "
              f"{np.asarray(out.deltas2)[0, :n].tolist()}")
    wxyz, t = xp.rotation.wxyz[0], xp.translation[0]
    d1 = SE3RefinementData(td.points[0], td.targets[0])
    _, Jp = residual_jacobian(lambda T: se3_residual(T, d1),
                              SE3(SO3(wxyz), t))
    _, Jj = j_jac(lambda T: j_res(T, first(data)),
                  JSE3(JSO3(jnp.asarray(wxyz.numpy())),
                       jnp.asarray(t.numpy())))
    Jj = np.asarray(Jj)
    print(f"  J at the port's pose: {int(np.sum(Jj != Jp.numpy()))} of "
          f"{Jj.size} entries differ, by at most "
          f"{np.abs(Jj - Jp.numpy()).max():.3e} (largest |J| "
          f"{np.abs(Jj).max():.3e})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=34)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--trace", default="0:9053")
    a = ap.parse_args()
    torch.set_num_threads(2)
    totals = {"jax": 0, "port": 0}
    for seed in range(a.seeds):
        out = stops_and_gaps(a.batch, seed)
        for who, (idx, gaps, other) in out.items():
            totals[who] += len(idx)
            print(f"seed {seed} {who}: MAX_CONSEC_NO_DECR {idx.tolist()}, "
                  f"their f64 cost gap {[f'{v:.2e}' for v in gaps]}; the "
                  f"others' largest {other:.2e}", flush=True)
    print(f"MAX_CONSEC_NO_DECR over {a.seeds} x {a.batch} instances: "
          f"JAX {totals['jax']}, port {totals['port']}")
    rounding(a.batch)
    seed, i = (int(v) for v in a.trace.split(":"))
    trace(a.batch, seed, i)


if __name__ == "__main__":
    main()
