// K2: the whole batched GN / LM / DogLeg solve.  This file holds the C entry
// points and K2's kernel for max(P, d, n_res) > 64, one warp per instance
// with its state in shared memory; csrc/solver_seg.cuh holds the kernel
// for max(d, n_res) <= 64 (the bench prior, Jennrich-Sampson, Powell,
// Wood) and csrc/solver_se3.cuh the SE3 family's (pose refinement up to 21
// points), state in registers.
// ops/cuda_solver.k2_launch_plan picks one and its geometry.
//
// Replaces the TPU kernel tinyopt_tpu/ops/pallas_solver.py::_solver_kernel
// (launched by fused_batched_solver).  Per instance, x0 -> converged x:
// linearize at x, g = J'r, diag(J'J) (identity coloring: one jvp of the
// all-ones probe; Curtis-Powell-Reid coloring, register kernel only: one
// jvp a color's probe and the recovery sum; otherwise one jvp per tangent
// dimension), the damped normal equations solved in closed form when the
// coloring has one color (H diagonal), else by Jacobi-PCG applying H as
// J'(J p); the Powell dogleg
// from up to three such solves; the propose / lambda-escalating retry
// loop, accept / reject, rollback and probe, the lambda schedule, the
// failure budgets, the priority-ordered stop cascade and the optional
// per-iteration history of the JAX kernel (and of the carry_system=False
// loop, optimizers/loop.py).
// The plain twin is ops/cuda_solver.py::fused_solve_plain, with the same
// op order.
//
// CUDA has no automatic differentiation, so the kernels are templated on a
// residual FAMILY that provides residual / jvp / vjp as device functions
// written by hand (csrc/solver.cuh): PriorFamily (models/problems.
// prior_residual, r = (x - y) * inv_std), JenSamFamily
// (jennrich_sampson_residuals, r_i = 2 + 2i - exp(i x1) - exp(i x2)),
// PowellFamily and WoodFamily (powell_singular_residuals, wood_residuals:
// 4 parameters, 4 and 6 residuals, two colors each; register kernel only)
// and SE3Family (models/se3_refinement.se3_residual, r_k = R p_k + t - q_k on
// an SE3 pose: P = 7 stored values, a tangent of D = 6, the jvp and vjp of
// d -> r(x (+) d) at 0, and the retraction that applies a step: the JAX
// kernel's manifold branch, ret_flat).
//
// solver_kernel's layout: lanes stride over the d tangent entries and the
// n_res residual rows; dot products are __shfl_xor_sync butterflies, so
// every lane holds the same scalar state and all control flow is
// warp-uniform.  Each warp runs its own outer loop, which replaces the
// tile-level "any instance active" gates of the TPU kernel (the
// per-instance results are the same, pallas_solver.py:566-574).  Per-warp
// state: 2 P + 12 d + 2 n_res values of shared memory (14 d + 2 n_res
// when P = d: 77 KB at d = 600 in double); the dogleg keeps its GN and first regularized steps in two of
// them that the other solvers do not read during a proposal.  The dogleg
// and the history are branches on the parameters here: this kernel serves
// max(d, n_res) > 64 only, off the main path.  What bounds it: latency, a
// chain of dependent warp reductions and shared-memory passes an
// iteration.
#include "solver.cuh"

namespace tinyopt {

template <typename T>
__device__ __forceinline__ bool warp_all_finite(const T* v, int n, int lane) {
  int f = 1;
  for (int i = lane; i < n; i += 32) f &= isfinite(v[i]) ? 1 : 0;
  return __all_sync(kFullMask, f) != 0;
}

template <typename T>
__device__ __forceinline__ T warp_dot(const T* a, const T* b, int n, int lane) {
  T s = 0;
  for (int i = lane; i < n; i += 32) s += a[i] * b[i];
  return warp_sum(s);
}

template <typename T, typename Fam>
__global__ void solver_kernel(const SolverParams p, const SolverIO io,
                              const Fam fam, int B, int warps_per_block,
                              int ws_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * warps_per_block + w;
  if (b >= B) return;         // whole warp: b is warp-uniform

  const int d = p.d;
  const int P = param_width<Fam>(d);   // values of x
  const int nr = p.n_res;
  T* x = reinterpret_cast<T*>(smem_raw) + (size_t)w * ws_stride;
  T* best_x = x + P;
  T* dgn = best_x + P;        // dogleg: the GN step of the proposal
  T* g = dgn + d;
  T* diagH = g + d;
  T* dx = diagH + d;          // accepted proposal of this iteration
  T* dxn = dx + d;            // proposal of the current try
  T* dampl = dxn + d;
  T* dinv = dampl + d;
  T* cr = dinv + d;           // PCG residual
  T* cz = cr + d;             // PCG preconditioned residual
  T* cp = cz + d;             // PCG direction
  T* chp = cp + d;            // H p
  T* tv = chp + d;            // tangent probe; dogleg: regularized step
  T* r = tv + d;              // residuals (n_res)
  T* jp = r + nr;             // J v (n_res)

  const T tiny = tiny_v<T>();
  const T feps = float_epsilon_v<T>();
  const T noise = T(8) * eps_v<T>();
  const T inf = T(INFINITY);
  const T lam_lo = T(p.lam_lo), lam_hi = T(p.lam_hi);
  const T base_bad = T(p.bad_factor), good_f = T(p.good_factor);
  const bool is_lm = p.solver == kSolverLM;
  const bool is_dl = p.solver == kSolverDogLeg;
  const int max_tries = p.max_consec_failures > 0 ? p.max_consec_failures : 255;

  const T* x0 = static_cast<const T*>(io.x0) + (size_t)b * P;
  if constexpr (Fam::kManifold) {
    for (int i = lane; i < P; i += 32) {
      x[i] = x0[i];
      best_x[i] = x0[i];
    }
    for (int i = lane; i < d; i += 32) g[i] = 0;
  } else {
    for (int i = lane; i < d; i += 32) {
      x[i] = x0[i];
      best_x[i] = x0[i];
      g[i] = 0;
    }
  }
  T best_cost = inf, final_rerr = inf;
  T lam = T(p.damping_init), bad = base_bad;
  int has_last = 0, it = 0, nfail = 0, nconsec = 0, stop = kNone;
  int best_nres = 0, nhist = 0;
  __syncwarp();

  // y = H v = J'(J v) + dampl * v   (v and y are d-vectors)
  auto matvec = [&](const T* v, T* y) {
    fam.jvp(b, x, v, jp, lane);
    __syncwarp();
    fam.vjp(b, x, jp, y, lane);
    __syncwarp();
    for (int i = lane; i < d; i += 32) y[i] = y[i] + dampl[i] * v[i];
    __syncwarp();
  };

  // dxn = solve((H + diag(dampl)) dxn = -g), dampl = damp * lam_eff when
  // damped, else 0; returns all(isfinite(dxn)).
  auto solve = [&](bool damped, T lam_eff) -> bool {
    for (int i = lane; i < d; i += 32) {
      const T damp = diagH[i] == T(0) ? T(1) : diagH[i];
      const T dl = damped ? damp * lam_eff : T(0);
      dampl[i] = dl;
      const T dd = diagH[i] + dl;
      dinv[i] = dd > T(0) ? T(1) / dd : T(1);
    }
    if (p.coloring == kColorIdentity) {
      // One color: H = J'J is exactly diagonal, the damped system solves
      // in closed form (the JAX kernel's n_colors == 1 branch).
      for (int i = lane; i < d; i += 32) dxn[i] = (-g[i]) * dinv[i];
      __syncwarp();
      return warp_all_finite(dxn, d, lane);
    }
    // Jacobi-PCG, ops/linalg.pcg_core formulas.
    T part = 0;
    for (int i = lane; i < d; i += 32) {
      dxn[i] = 0;
      cr[i] = -g[i];
      cz[i] = cr[i] * dinv[i];
      cp[i] = cz[i];
      part += cr[i] * cz[i];
    }
    T rz = warp_sum(part);
    __syncwarp();
    for (int k = 0; k < p.cg_iters; ++k) {
      matvec(cp, chp);
      const T denom = warp_dot(cp, chp, d, lane);
      const T alpha = denom > tiny ? rz / denom : T(0);
      part = 0;
      for (int i = lane; i < d; i += 32) {
        dxn[i] = dxn[i] + alpha * cp[i];
        cr[i] = cr[i] - alpha * chp[i];
        cz[i] = cr[i] * dinv[i];
        part += cr[i] * cz[i];
      }
      const T rz_new = warp_sum(part);
      const T beta = rz_new / (rz > tiny ? rz : tiny);
      for (int i = lane; i < d; i += 32) cp[i] = cz[i] + beta * cp[i];
      rz = rz_new;
      __syncwarp();
    }
    return warp_all_finite(dxn, d, lane);
  };

  // The Powell dogleg (the twin's GN step, g'Hg, then solvers/step.
  // dogleg_core): the GN step in dgn, J'(J g) in chp, the regularized step
  // in tv, the step in dxn.
  auto propose_dogleg = [&](T lam_try) -> bool {
    const T kappa2 = T(1e6);
    const bool ok_gn = solve(false, T(0));
    for (int i = lane; i < d; i += 32) dgn[i] = ok_gn ? dxn[i] : T(0);
    __syncwarp();
    fam.jvp(b, x, g, jp, lane);
    __syncwarp();
    fam.vjp(b, x, jp, chp, lane);
    __syncwarp();
    const T gg = warp_dot(g, g, d, lane);
    const T gHg = warp_dot(g, chp, d, lane);
    const bool pos_curv = gHg > T(0);
    DogLegGeometry<T> geo;
    geo.alpha = pos_curv ? gg / gHg : T(0);
    T pa = 0, pb = 0;
    for (int i = lane; i < d; i += 32) {
      const T sd = (-geo.alpha) * g[i];
      pa += dgn[i] * dgn[i];
      pb += sd * sd;
    }
    const T n_gn2 = warp_sum(pa), n_sd2 = warp_sum(pb);
    const bool gn_sane = ok_gn && (!(n_sd2 > T(0)) || n_gn2 <= kappa2 * n_sd2);
    bool ok_r1 = false, ok_r2 = false;
    if (!gn_sane) {
      ok_r1 = solve(true, lam_try);
      for (int i = lane; i < d; i += 32) tv[i] = dxn[i];
    } else {
      for (int i = lane; i < d; i += 32) tv[i] = T(0);
    }
    __syncwarp();
    const T n_r1 = warp_dot(tv, tv, d, lane);
    const bool r1_sane = ok_r1 && (!(n_sd2 > T(0)) || n_r1 <= kappa2 * n_sd2);
    if (!gn_sane && !r1_sane) {
      ok_r2 = solve(true, fmax(lam_try, T(1)));
      for (int i = lane; i < d; i += 32) tv[i] = dxn[i];
      __syncwarp();
    }
    const bool ok_reg = r1_sane || ok_r2;
    pa = pb = 0;
    T pc = 0;
    for (int i = lane; i < d; i += 32) {
      const T sd = (-geo.alpha) * g[i];
      if (!ok_reg) tv[i] = sd;
      const T dv = dgn[i] - sd;
      pa += tv[i] * tv[i];
      pb += dv * dv;
      pc += sd * dv;
    }
    const T n_reg2 = warp_sum(pa), qa0 = warp_sum(pb), qb0 = warp_sum(pc);
    geo.finish(gn_sane, ok_reg, pos_curv, gg, n_gn2, n_sd2, n_reg2, qa0, qb0,
               lam_try);
    for (int i = lane; i < d; i += 32) dxn[i] = geo.entry(dgn[i], g[i], tv[i]);
    __syncwarp();
    return warp_all_finite(dxn, d, lane);
  };

  while (stop == kNone && it < p.max_iters_total) {
    // ---- linearize at x, accumulate g, diag(H), err ----
    fam.residual(b, x, r, lane);
    __syncwarp();
    fam.vjp(b, x, r, g, lane);
    __syncwarp();
    if (p.coloring == kColorIdentity) {
      for (int i = lane; i < d; i += 32) tv[i] = T(1);
      __syncwarp();
      fam.jvp(b, x, tv, jp, lane);
      __syncwarp();
      for (int i = lane; i < d; i += 32) diagH[i] = jp[i] * jp[i];
    } else {
      for (int j = 0; j < d; ++j) {
        for (int i = lane; i < d; i += 32) tv[i] = i == j ? T(1) : T(0);
        __syncwarp();
        fam.jvp(b, x, tv, jp, lane);
        __syncwarp();
        const T dj = warp_dot(jp, jp, nr, lane);
        if (lane == 0) diagH[j] = dj;
        __syncwarp();
      }
    }
    T err = warp_dot(r, r, nr, lane);
    if (!p.use_squared_norm) err = sqrt(err);
    if (p.downscale_by_2) err = T(0.5) * err;
    if (p.normalize) err = err / T(nr > 1 ? nr : 1);
    if (p.grad_clipping > 0) {
      const T v = T(p.grad_clipping);
      for (int i = lane; i < d; i += 32) g[i] = fmin(fmax(g[i], -v), v);
    }
    __syncwarp();

    // ---- propose, retry with lambda escalation (optimizer.h:356-399) ----
    bool ok = false, give_up = false;
    T r_lam = lam, r_bad = bad;
    int nf = nfail, nc = nconsec;
    for (int i = lane; i < d; i += 32) dx[i] = 0;
    __syncwarp();
    while (!ok && !give_up && nc <= max_tries) {
      const bool ok_new = is_dl ? propose_dogleg(r_lam) : solve(is_lm, r_lam);
      if (!ok_new) {
        ++nf;
        ++nc;
      }
      const bool gu_new = !ok_new && p.max_consec_failures > 0 &&
                          nc >= p.max_consec_failures;
      if (ok_new)
        for (int i = lane; i < d; i += 32) dx[i] = dxn[i];
      ok = ok_new;
      if (!ok_new && !gu_new && is_dl) {
        r_lam = clampv(r_lam * base_bad, lam_lo, lam_hi);   // fixed shrink
      } else if (!ok_new && !gu_new && is_lm) {
        r_lam = clampv(r_lam * r_bad, lam_lo, lam_hi);
        r_bad = r_bad * base_bad;
      }
      give_up = give_up || gu_new;
      __syncwarp();
    }
    lam = r_lam;
    bad = r_bad;

    // ---- early failure routing ----
    const bool err_bad = !isfinite(err) || !warp_all_finite(g, d, lane);
    int stop_early = err_bad ? kNanOrInf : (ok ? kNone : kSolverFailed);
    const T dx_norm2 = warp_dot(dx, dx, d, lane);
    if (stop_early == kNone && !isfinite(dx_norm2)) stop_early = kNanOrInf;
    const bool early_fail = stop_early != kNone;

    // ---- accept / reject (optimizer.h:427-459) ----
    const T derr = err - best_cost;
    const bool is_good = derr < T(0);
    const T rel_derr = (best_cost > feps && isfinite(best_cost))
                           ? (best_cost - err) / best_cost : T(0);
    const bool first_eval = !isfinite(best_cost);
    const bool good = is_good || first_eval;
    if (is_lm || is_dl) {
      if (!early_fail && good && !first_eval) {
        // the dogleg ignores the step quality
        const T q = (p.use_quality && !is_dl) ? rel_derr : T(0);
        const T t = T(2) * q - T(1);
        T s = q != T(0) ? fmax(good_f, T(1) - t * t * t) : good_f;
        if (bad != base_bad) s = s / bad;
        lam = clampv(lam * s, lam_lo, lam_hi);
        bad = base_bad;
      } else if (!early_fail && !good && is_dl) {
        lam = clampv(lam * base_bad, lam_lo, lam_hi);
      } else if (!early_fail && !good) {
        lam = clampv(lam * bad, lam_lo, lam_hi);
        bad = bad * base_bad;
      }
    }
    if (p.cap > 0 && !early_fail) {
      // history slot `it`; succ records is_good, not the auto-accept
      if (lane == 0) {
        const size_t at = (size_t)b * p.cap + it;
        static_cast<T*>(io.errs)[at] = err;
        static_cast<T*>(io.deltas2)[at] = dx_norm2;
        static_cast<bool*>(io.succ)[at] = is_good;
      }
      nhist = it + 1;
    }
    const bool accepted = !early_fail && good;
    const bool rejected = !early_fail && !good;
    const int nconsec_new = accepted ? 0 : nc + (rejected ? 1 : 0);
    const int nfail_new = nf + (rejected ? 1 : 0);
    if (accepted) {
      best_cost = err;
      best_nres = nr;
      final_rerr = rel_derr;
    }
    int budget_stop = kNone;
    if (rejected && p.max_consec_failures > 0 &&
        nconsec_new >= p.max_consec_failures)
      budget_stop = kMaxConsecNoDecr;
    else if (rejected && p.max_total_failures > 0 &&
             nfail_new >= p.max_total_failures)
      budget_stop = kMaxNoDecr;
    const bool budget_fail = stop_early == kNone && budget_stop != kNone;

    // ---- stop cascade (optimizer.h:518-534), first match wins ----
    const T gn2 = warp_dot(g, g, d, lane);
    int cascade = kNone;
    if (p.min_error > 0 && err < T(p.min_error))
      cascade = kMinError;
    else if (p.min_rerr_dec > 0 && rel_derr > noise && rel_derr < T(p.min_rerr_dec))
      cascade = kMinRelError;
    else if (p.min_step_norm2 > 0 && dx_norm2 < T(p.min_step_norm2))
      cascade = kMinDeltaNorm;
    else if (p.min_grad_norm2 > 0 && gn2 < T(p.min_grad_norm2))
      cascade = kMinGradNorm;
    const int stop_new = stop_early != kNone ? stop_early
                         : (budget_stop != kNone ? budget_stop : cascade);

    // ---- apply / rollback / probe (optimizer.h:266-299) ----
    const bool returned_dx = !early_fail && !budget_fail;
    const bool success = accepted && returned_dx;
    const bool probe = !success && !has_last && returned_dx;
    const bool roll = !success && has_last;
    const bool apply = (success || probe) && cascade == kNone &&
                       it + 1 < p.max_iters_total;
    if constexpr (Fam::kManifold) {
      // x (+) dx from the rollback point (dx = 0 where no step applies),
      // every lane the same, then written by the first P lanes
      T xb[Fam::kP], dd[Fam::kD], xn[Fam::kP];
      for (int i = 0; i < Fam::kP; ++i) xb[i] = roll ? best_x[i] : x[i];
      for (int i = 0; i < Fam::kD; ++i) dd[i] = apply ? dx[i] : T(0);
      fam.retract(xb, dd, xn);
      __syncwarp();
      for (int i = 0; i < Fam::kP; ++i) {
        if (lane == i) {
          if (success) best_x[i] = x[i];
          x[i] = xn[i];
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const T xb = roll ? best_x[i] : x[i];
        const T xn = xb + (apply ? dx[i] : T(0));
        if (success) best_x[i] = x[i];
        x[i] = xn;
      }
    }
    has_last = success ? 1 : (has_last ? 0 : (probe ? 1 : 0));
    ++it;
    nfail = nfail_new;
    nconsec = nconsec_new;
    stop = stop_new;
    __syncwarp();
  }

  if (stop == kNone) stop = kMaxIters;
  T* xo = static_cast<T*>(io.x) + (size_t)b * P;
  T* go = static_cast<T*>(io.g) + (size_t)b * d;
  if constexpr (Fam::kManifold) {
    for (int i = lane; i < P; i += 32) xo[i] = x[i];
    for (int i = lane; i < d; i += 32) go[i] = g[i];
  } else {
    for (int i = lane; i < d; i += 32) {
      xo[i] = x[i];
      go[i] = g[i];
    }
  }
  const size_t row = (size_t)b * p.cap;
  for (int j = nhist + lane; j < p.cap; j += 32) {
    static_cast<T*>(io.errs)[row + j] = T(0);
    static_cast<T*>(io.deltas2)[row + j] = T(0);
    static_cast<bool*>(io.succ)[row + j] = false;
  }
  if (lane == 0) {
    static_cast<T*>(io.cost)[b] = best_cost;
    static_cast<T*>(io.rerr)[b] = final_rerr;
    static_cast<T*>(io.lam)[b] = lam;
    static_cast<int*>(io.stop)[b] = stop;
    static_cast<int*>(io.iters)[b] = it;
    static_cast<int*>(io.nfail)[b] = nfail;
    static_cast<int*>(io.nconsec)[b] = nconsec;
    static_cast<int*>(io.nres)[b] = best_nres;
    static_cast<int*>(io.nhist)[b] = nhist;
    static_cast<float*>(io.inlier)[b] = 1.0f;
    static_cast<float*>(io.duration)[b] = 0.0f;
  }
}

// One warp per instance, `warps` a block, smem = warps * (2 P + 12 d +
// 2 n_res) values (ops/cuda_solver.k2_launch_plan, warp_values).
template <typename T, typename Fam>
int launch_warp(const SolverParams& p, const SolverIO& io, const Fam& fam,
                int B, int warps, int grid, int smem, cudaStream_t stream) {
  const int ws_stride = 2 * param_width<Fam>(p.d) + 12 * p.d + 2 * p.n_res;
  const long long need = (long long)warps * ws_stride * sizeof(T);
  if (warps < 1 || warps > 32 || smem < need || (size_t)smem > kMaxSmem ||
      (long long)grid * warps < B)
    return (int)cudaErrorInvalidValue;
  auto kern = solver_kernel<T, Fam>;
  int fit = 0;
  cudaError_t e = device_fit(reinterpret_cast<const void*>(kern), warps * 32,
                             smem, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  kern<<<grid, 32 * warps, smem, stream>>>(p, io, fam, B, warps, ws_stride);
  return (int)cudaGetLastError();
}

// path kPathSegment: solver_seg_kernel (S lanes and E entries a lane per
// instance, max(d, n_res) <= 64), or for the SE3 family solver_se3_kernel
// (S lanes and E points a lane); kPathWarp: solver_kernel.  The plan's
// numbers come from ops/cuda_solver.k2_launch_plan; one the kernels cannot
// run is refused with cudaErrorInvalidValue.
template <typename T>
int launch_solver(const SolverParams* p, const SolverIO* io,
                  const ColorTables& tables, int B, int path, int S, int E,
                  int warps, int grid, int smem, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->d < 1 || p->n_res < 1 || grid < 1 ||
      p->coloring < kColorNone || p->coloring > kColorMulti ||
      (p->coloring == kColorMulti && (path != kPathSegment || p->n_colors < 1)) ||
      (p->family == kPowell && (p->d != 4 || p->n_res != 4)) ||
      (p->family == kWood && (p->d != 4 || p->n_res != 6)) ||
      (p->family == kJennrichSampson && (p->d != 2 || p->fam_m != p->n_res)) ||
      (p->family == kSE3 && (p->d != SE3Family<T>::kD || p->fam_m < 1 ||
                             p->n_res != 3 * p->fam_m ||
                             p->coloring != kColorNone)))
    return (int)cudaErrorInvalidValue;
  if (p->solver < kSolverGN || p->solver > kSolverDogLeg || p->cap < 0 ||
      (p->cap > 0 && p->cap != p->max_iters_total))
    return (int)cudaErrorInvalidValue;
  if (path == kPathSegment) {
    if (smem != 0) return (int)cudaErrorInvalidValue;
    const bool dl = p->solver == kSolverDogLeg, hist = p->cap > 0;
    if (dl)
      return hist ? launch_segment<T, true, true>(*p, *io, tables, B, S, E, warps, grid, s)
                  : launch_segment<T, true, false>(*p, *io, tables, B, S, E, warps, grid, s);
    return hist ? launch_segment<T, false, true>(*p, *io, tables, B, S, E, warps, grid, s)
                : launch_segment<T, false, false>(*p, *io, tables, B, S, E, warps, grid, s);
  }
  if (path != kPathWarp) return (int)cudaErrorInvalidValue;
  if (p->family == kPrior) {
    PriorFamily<T> fam{static_cast<const T*>(io->data0),
                       static_cast<const T*>(io->data1), p->d};
    return launch_warp<T>(*p, *io, fam, B, warps, grid, smem, s);
  }
  if (p->family == kJennrichSampson) {
    JenSamFamily<T> fam{p->fam_m};
    return launch_warp<T>(*p, *io, fam, B, warps, grid, smem, s);
  }
  if (p->family == kSE3) {
    SE3Family<T> fam{static_cast<const T*>(io->data0),
                     static_cast<const T*>(io->data1), p->fam_m};
    return launch_warp<T>(*p, *io, fam, B, warps, grid, smem, s);
  }
  // PowellFamily and WoodFamily have the register form only: their fixed
  // shapes always take the register kernel.
  return (int)cudaErrorInvalidValue;
}

}  // namespace tinyopt

// probes and recovery: the multi-color coloring's tables (ColorTables),
// null for the other colorings.
extern "C" int tinyopt_solver_f32(const tinyopt::SolverParams* p,
                                  const tinyopt::SolverIO* io,
                                  const void* probes, const void* recovery,
                                  int B, int path, int S, int E, int warps,
                                  int grid, int smem, void* stream) {
  return tinyopt::launch_solver<float>(p, io, {probes, recovery}, B, path, S, E,
                                       warps, grid, smem, stream);
}

extern "C" int tinyopt_solver_f64(const tinyopt::SolverParams* p,
                                  const tinyopt::SolverIO* io,
                                  const void* probes, const void* recovery,
                                  int B, int path, int S, int E, int warps,
                                  int grid, int smem, void* stream) {
  return tinyopt::launch_solver<double>(p, io, {probes, recovery}, B, path, S,
                                        E, warps, grid, smem, stream);
}
