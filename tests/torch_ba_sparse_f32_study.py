"""Float32 sparse bundle adjustment run on past its convergence (a study,
not collected by pytest).

bench_ba_sparse's corridor rig (``benchmarks/run_benchmarks.py:329-391``:
K = 8 observations a landmark, σ = 1e-3, seed 7) through
``schur_sparse_optimize`` in float32 with two refinement rounds of the
banded reduced solve, every stop test off and no failure budget
(``chip_smoke.bas_iter_options``), from five starts: the landmarks shifted
by 1e-6 × k, k = 1..5.  Each solve prints its wall, iterations, failures,
stop reason and final cost.  With the stop tests off, λ falls to ~1e-7
past the convergence, where the float32 cyclic reduction of the
near-singular reduced system can be far off and its refinement rounds
diverge; a step far along the gauge can then be taken, the next
linearization overflows, and the retries of the failed proposals end
the solve SOLVER_FAILED (-3) after 256 of them.

Three modes:

    python3 tests/torch_ba_sparse_f32_study.py --card

        the port alone on the card at bench_ba_sparse's 1,000 cameras ×
        50,000 landmarks, max_iters 9 (starts 1-4) and 12 (start 5);
        imports no JAX (~1 min on an H100).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_ba_sparse_f32_study.py \\
        --cpu [N_CAMS N_PTS] [--inputs jax|port]

        the JAX package and the port on the CPU from the same float32
        inputs, max_iters 12, at 600 × 30,000 by default: a cut of the row
        where the overflow still shows (it does not at 100 × 5,000 or
        300 × 15,000).  ``--inputs jax`` (the default) draws the problem
        with the JAX package's generator and carries it into the port's
        types; ``--inputs port`` draws it with the port's, whose float32
        camera translations differ from the JAX package's by an ulp in
        places, and carries it into the JAX package's.  ~5-20 min a
        package, most of it in the failed solves.  ``--starts 1,2`` picks
        the starts; ``--log`` prints each package's iteration log (ε², the
        step, |dx|, |grad|, 1/λ) and ends a solve after 16 consecutive
        failures instead of 256, which leaves the iterations before the
        overflow as they were.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_ba_sparse_f32_study.py \\
        --probe [N_CAMS N_PTS]

        the float32 banded reduced solve on the same inputs in the port,
        in the port with its block Cholesky on the lower triangle alone
        (as it was before it took the symmetric part, as JAX's
        ``cholesky`` does), and in the JAX package, each against the
        float64 solve of those inputs (``probe``); 600 × 30,000 by
        default (~3 min).  ``--probe --at K,ITERS [--inputs jax|port]``
        stops the port's solve from start K after ITERS iterations and
        solves the reduced system of its reduce there, at the loop's λ,
        by both packages, banded and dense (``at_iterate``).
"""

import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import tinyopt_tpu_torch as to                                 # noqa: E402
from tinyopt_tpu_torch.models.bundle_adjustment import (        # noqa: E402
    make_ba_problem_sparse, project)
from tinyopt_tpu_torch.ops import schur_obs                     # noqa: E402

K_OBS, NOISE, SEED = 8, 1e-3, 7


def ba_pair(pose, point, obs):
    return project(pose, point[None, :])[0] - obs


def iter_options(pkg, iters, log=False):
    """``chip_smoke.bas_iter_options`` for either package (``log``: its
    iteration log on, at most 16 consecutive failures)."""
    return pkg.Options(max_iters=iters, min_error=0.0, min_step_norm2=0.0,
                       min_grad_norm2=0.0, min_rerr_dec=0.0,
                       max_consec_failures=16 if log else 0,
                       log=pkg.LogOptions(enable=log),
                       hessian=pkg.HessianOptions(save_last=False,
                                                  schur_refine=2))


def report(who, iters, k, wall, out, extra=""):
    print(f"[f32-study] {who} max_iters {iters}, start {k}: {wall:.3f} s, "
          f"{int(out.num_iters)} iterations, {int(out.num_failures)} "
          f"failures, stop {int(out.stop_reason)}, cost "
          f"{float(out.final_cost.cost):.6e}{extra}", flush=True)


def port_solve(x0, obs, ci, mk, iters, k, who, sync=lambda: None,
               log=False):
    o = iter_options(to, iters, log).for_dtype(torch.float32)
    for key in schur_obs.SOLVES:
        schur_obs.SOLVES[key] = 0
    sync()
    t0 = time.perf_counter()
    _, out = to.schur_sparse_optimize(
        (x0[0], x0[1] + 1e-6 * k), ba_pair, obs, ci, mk, o)
    float(out.final_cost.cost)
    report(who, iters, k, time.perf_counter() - t0, out,
           f", reduced solves {dict(schur_obs.SOLVES)}")


def card():
    import subprocess
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[f32-study] the port on {smi}, 1000 x 50000", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    (obs, ci, mk), x0, _ = make_ba_problem_sparse(
        1000, 50_000, K_OBS, noise=NOISE, seed=SEED, dtype=torch.float32,
        device=torch.device("cuda", 0))
    for iters, k in ((9, 1), (9, 2), (9, 3), (9, 4), (12, 5)):
        port_solve((x0["poses"], x0["points"]), obs, ci, mk, iters, k,
                   "port (card)", torch.cuda.synchronize)


def cpu(n_cams, n_pts, inputs="jax", starts=(1, 2, 3, 4, 5), log=False,
        iters=12, threads=4):
    import jax
    # as bench_ba_sparse: x64 gives the refinement its float64 residual
    # (without it the JAX package refines in float32); every array of the
    # problem stays float32
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import tinyopt_tpu as jto
    from tinyopt_tpu.manifolds import SE3 as JSE3, SO3 as JSO3
    from tinyopt_tpu.models import bundle_adjustment as jba
    from tinyopt_tpu_torch.interop import ba_problem_from_numpy

    torch.set_num_threads(threads)
    print(f"[f32-study] the JAX package ({jax.default_backend()}) and the "
          f"port on the CPU, {n_cams} x {n_pts}, {inputs}'s generator",
          flush=True)
    if inputs == "jax":
        (obs, ci, mk), x0, _ = jba.make_ba_problem_sparse(
            n_cams=n_cams, n_pts=n_pts, k_obs=K_OBS, noise=NOISE, seed=SEED,
            dtype=jnp.float32)
        (tobs, tci, tmk), tx0 = ba_problem_from_numpy(
            (np.asarray(obs), np.asarray(ci), np.asarray(mk)),
            np.asarray(x0["poses"].rotation.wxyz),
            np.asarray(x0["poses"].translation), np.asarray(x0["points"]),
            device="cpu", dtype=torch.float32)
    else:
        (tobs, tci, tmk), tx0, _ = make_ba_problem_sparse(
            n_cams, n_pts, K_OBS, noise=NOISE, seed=SEED,
            dtype=torch.float32, device="cpu")
        obs, ci, mk = (jnp.asarray(a.numpy()) for a in (tobs, tci, tmk))
        x0 = {"poses": JSE3(JSO3(jnp.asarray(
                  tx0["poses"].rotation.wxyz.numpy())),
                  jnp.asarray(tx0["poses"].translation.numpy())),
              "points": jnp.asarray(tx0["points"].numpy())}

    def jpair(pose, point, d):
        return jba.project(pose, point[None, :])[0] - d

    jo = iter_options(jto, iters, log).for_dtype(jnp.float32)
    for k in starts:
        t0 = time.perf_counter()
        _, out = jto.schur_sparse_optimize(
            (x0["poses"], x0["points"] + 1e-6 * k), jpair, obs, ci, mk, jo)
        float(out.final_cost.cost)
        report("JAX", iters, k, time.perf_counter() - t0, out)
        port_solve((tx0["poses"], tx0["points"]), tobs, tci, tmk, iters, k,
                   "port", log=log)


def probe(n_cams, n_pts, threads=4):
    """The float32 reduced solve on the banded route against the float64
    solve of the same float32 inputs (S, rhs, the damped camera blocks) at
    the port's iterates 5 and 7 from starts 1-3 and λ 1e-5, 1e-6, 3e-7:
    the error |dx - dx64| with ``schur_refine`` 0 and 2, for the port's
    cyclic reduction with its block Cholesky on the lower triangle alone,
    for the port as it is (the symmetric part, as JAX's ``cholesky``), and
    for the JAX package's."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tinyopt_tpu.ops import schur_obs as jso
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.ops import tridiag
    from tinyopt_tpu_torch.ops.schur import _damp_blocks

    torch.set_num_threads(threads)
    (obs, ci, mk), x0, _ = make_ba_problem_sparse(
        n_cams, n_pts, K_OBS, noise=NOISE, seed=SEED, dtype=torch.float32,
        device="cpu")
    sym_chol = tridiag._chol

    def lower_chol(A):
        L, info = torch.linalg.cholesky_ex(A)
        low = torch.ones(A.shape[-2:], dtype=torch.bool).tril()
        return torch.where((info != 0)[..., None, None] & low,
                           torch.tensor(float("nan"), dtype=A.dtype), L)

    jsolve = {r: jax.jit(lambda *a, r=r: jso.assemble_reduced(
        *a, refine=r, band_group=7)) for r in (0, 2)}
    print(f"[f32-study] probe at {n_cams} x {n_pts}: |dx - dx64| of the "
          f"banded reduced solve, refine 0 and 2: Cholesky on the lower "
          f"triangle / the port / JAX", flush=True)
    for k in (1, 2, 3):
        for iters in (5, 7):
            xs, _ = to.schur_sparse_optimize(
                (x0["poses"], x0["points"] + 1e-6 * k), ba_pair, obs, ci,
                mk, iter_options(to, iters).for_dtype(torch.float32))
            spec = mf.tangent_spec(xs)
            acc, _, _, prop = schur_obs.schur_obs_system(
                ba_pair, xs[0], xs[1], obs[None], ci, mk, spec)
            H, g, _ = acc(mf.flatten_batch(
                pytree.tree_map(lambda a: a[None], xs), spec))
            st = prop.stages
            for lam in (1e-5, 1e-6, 3e-7):
                lt = torch.tensor([lam])
                g_a, g_b, E_p, Cd_p = st.reduce_inputs(
                    H, schur_obs._damp_flat(H.C, 3, lt), g)
                S_f, rhs, _ = st.reduce(E_p, Cd_p, g_b)
                args = (S_f, rhs, _damp_blocks(H.Ba, lt), g_a)
                ref = schur_obs.assemble_reduced(
                    *(a.double() for a in args))[0].reshape(-1)
                line = (f"[f32-study] start {k}, iterate {iters}, λ "
                        f"{lam:.0e}: |dx64| {float(ref.norm()):.3g}")

                def err(dx, ok):
                    return (f"{float((dx.double().reshape(-1) - ref).norm()):.3g}"
                            if bool(ok) else "failed")

                for r in (0, 2):
                    got = []
                    for chol in (lower_chol, sym_chol):
                        tridiag._chol = chol
                        dx, ok = schur_obs.assemble_reduced(
                            *args, refine=r, band_group=7)
                        got.append(err(dx[0], ok[0]))
                    tridiag._chol = sym_chol
                    dj, okj = jsolve[r](*(jnp.asarray(a[0].numpy())
                                          for a in args))
                    got.append(err(torch.as_tensor(np.asarray(dj)), okj))
                    line += f"; refine {r}: " + " / ".join(got)
                print(line, flush=True)


def at_iterate(n_cams, n_pts, inputs, k, iters, threads=4):
    """The port's solve from start ``k`` stopped after ``iters``
    iterations; at that iterate and the loop's λ there, the reduced solve
    of the port's reduce by the JAX package and by the port, banded and
    dense, with 0 and 2 refinement rounds: |dx_a| and ``ok``."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tinyopt_tpu.models import bundle_adjustment as jba
    from tinyopt_tpu.ops import schur_obs as jso
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.interop import ba_problem_from_numpy
    from tinyopt_tpu_torch.ops.schur import _damp_blocks

    torch.set_num_threads(threads)
    if inputs == "jax":
        (obs, ci, mk), x0, _ = jba.make_ba_problem_sparse(
            n_cams=n_cams, n_pts=n_pts, k_obs=K_OBS, noise=NOISE, seed=SEED,
            dtype=jnp.float32)
        (obs, ci, mk), x0 = ba_problem_from_numpy(
            (np.asarray(obs), np.asarray(ci), np.asarray(mk)),
            np.asarray(x0["poses"].rotation.wxyz),
            np.asarray(x0["poses"].translation), np.asarray(x0["points"]),
            device="cpu", dtype=torch.float32)
    else:
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams, n_pts, K_OBS, noise=NOISE, seed=SEED,
            dtype=torch.float32, device="cpu")
    xs, out = to.schur_sparse_optimize(
        (x0["poses"], x0["points"] + 1e-6 * k), ba_pair, obs, ci, mk,
        iter_options(to, iters).for_dtype(torch.float32))
    spec = mf.tangent_spec(xs)
    acc, _, _, prop = schur_obs.schur_obs_system(
        ba_pair, xs[0], xs[1], obs[None], ci, mk, spec)
    H, g, _ = acc(mf.flatten_batch(pytree.tree_map(lambda a: a[None], xs),
                                   spec))
    st = prop.stages
    # the loop's λ there, and the first retry's (λ × 3 after a failure)
    for lam in (torch.as_tensor(out.final_lambda).reshape(1) * f
                for f in (1, 3)):
        g_a, g_b, E_p, Cd_p = st.reduce_inputs(
            H, schur_obs._damp_flat(H.C, 3, lam), g)
        S_f, rhs, _ = st.reduce(E_p, Cd_p, g_b)
        args = (S_f[0], rhs[0], _damp_blocks(H.Ba, lam)[0], g_a[0])
        print(f"[f32-study] {inputs}'s inputs, start {k}, iterate {iters},"
              f" λ {float(lam):.4g}: |dx_a| and ok of the reduced solve",
              flush=True)
        for band in (st.band_group, None):
            for r in (0, 2):
                dj, okj = jax.jit(lambda *a: jso.assemble_reduced(
                    *a, refine=r, band_group=band))(
                        *(jnp.asarray(a.numpy()) for a in args))
                dt, okt = schur_obs.assemble_reduced(
                    *(a[None] for a in args), refine=r, band_group=band)
                dj = float(np.linalg.norm(np.asarray(dj, np.float64)))
                print(f"[f32-study]   {'banded' if band else 'dense'}, "
                      f"refine {r}: JAX {dj:.4g} ({bool(okj)}), port "
                      f"{float(dt.double().norm()):.4g} ({bool(okt[0])})",
                      flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--card"]:
        card()
    elif args[:1] == ["--cpu"]:
        kw = {"log": "--log" in args}
        args = [a for a in args if a != "--log"]
        for flag in ("--inputs", "--starts"):
            if flag in args:
                i = args.index(flag)
                kw[flag[2:]] = args[i + 1]
                del args[i:i + 2]
        if "starts" in kw:
            kw["starts"] = [int(k) for k in kw["starts"].split(",")]
        size = [int(a) for a in args[1:3]] or [600, 30_000]
        cpu(*size, **kw)
    elif args[:1] == ["--probe"] and "--at" in args:
        i = args.index("--at")
        k, iters = (int(a) for a in args[i + 1].split(","))
        inputs = args[args.index("--inputs") + 1] if "--inputs" in args \
            else "jax"
        at_iterate(600, 30_000, inputs, k, iters)
    elif args[:1] == ["--probe"]:
        probe(*([int(a) for a in args[1:3]] or [600, 30_000]))
    else:
        sys.exit(__doc__)
