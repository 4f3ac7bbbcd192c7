// K2's SE3 family in registers: solver_se3_kernel, the whole GN / LM /
// DogLeg solve of SE(3) pose refinement (models/se3_refinement.
// se3_residual, up to 21 points an instance; the warp kernel in
// csrc/solver.cu takes more), the counterpart of the JAX kernel's manifold
// branch (pallas_solver.py::_solver_kernel with ret_flat).
//
// Same function as solver_seg_kernel on the other families and as the twin
// ops/cuda_solver.fused_solve_plain: the same stop cascade, lambda
// schedule, retries, rollback, failure budgets and history rows.  Not
// bit-equal to the twin (closed forms of the maps torch.func
// differentiates; PERF.md states the tolerances it is held to).
//
// What the family gives that a generic residual cannot: r_k = R p_k + t -
// qhat_k has J_k = R [I, -[p_k]x], so, with R'R = I,
//
//   H = J'J = [[K I, -[c]x], [[c]x, tr(M) I - M]],  c = sum p_k,
//                                                    M = sum p_k p_k'
//
// depends on the points alone.  It is built once an instance, when the
// instance starts, from c and M summed in double, and kept as ten numbers
// (K, the centroid c / K and the six of the centred scatter, SE3Gram) in
// every lane that runs the solve; diag(H) is read off it.  (R(q) drifts from orthogonal as the
// stored quaternion's norm drifts, a few ulps an iteration:
// tests/test_torch_se3_gram.py measures that term, PERF.md.)
//
// The residuals are formed in double and rounded once, in float as well:
// near the solution r_k is ~1e-3 of the values it is formed from, so float
// rounding of R p_k + t - qhat_k would be ~1e-4 of it, and r'r would decide
// the accept / reject of the late steps by that noise.  In double the
// float kernel follows the float64 solve's decisions on most instances and
// lands several times nearer its pose than the float twin does
// (se3_accuracy.py, PERF.md).
//
// Layout: an instance on a segment of S lanes (S a power of two, 32 / S
// instances a warp), lane sl serving points sl + j*S, j < NP (4 in float,
// 8 in double: se3_points), read through the read-only cache at each pass
// (held in registers they cost the double kernels spills and the float
// dogleg a block an SM, PERF.md), and the whole pose-side state: x (7
// stored values, wxyz then t), best_x, g, diag(H), H, the step and the PCG
// vectors of the 6-dimensional tangent.  Every lane of a segment computes
// the same pose-side values (the segment's sums reach each lane
// bit-identical), so the linearization, the Jacobi-PCG on the 6 x 6, the
// dogleg, the accept / stop logic and the retraction run in each lane
// without a shuffle.  An iteration makes one pass over the lane's points
// (the residuals, r'r and g = J'r) and one 7-value butterfly over the
// segment; a new instance one 9-value butterfly (c and M, in double).
// Those
// butterflies sit in warp-uniform code and use the full mask; between them
// a segment votes with no other, so its retries and the dogleg's damped
// solves follow its own instance.  Persistent grid: a segment whose
// instance stops writes it out and starts the instance one grid's worth
// of segments further on.
//
// What bounds it on an H100: latency, the dependent chain of an iteration
// (cg_iters PCG steps, each a product with H, two dot products of 6 and
// two divisions), not bytes (10k x 16 poses read 4 MB).
#pragma once

#include "solver_seg.cuh"

namespace tinyopt {

// An instance's book: what the twin's loop carries besides x and g
// (ops/cuda_solver.fused_solve_plain), the same values in each lane of a
// segment, and the steps of an outer iteration that do not depend on the
// family: the proposal's retries, then the judgement of its step.  The
// kernel linearizes, proposes and moves x; the book decides.  The same
// semantics as solver_seg_kernel's inline block (csrc/solver_seg.cuh),
// which keeps its own copy: moved into this struct, it changed the
// registers of most of that kernel's instances (PERF.md, ROADMAP K2-d).
template <typename T, bool kDogLeg, bool kHist>
struct InstanceBook {
  T best_cost, final_rerr, lam, bad;
  int has_last, it, nfail, nconsec, stop, best_nres;
  int nhist = 0;

  __device__ __forceinline__ void start(const SolverParams& p) {
    best_cost = T(INFINITY);
    final_rerr = T(INFINITY);
    lam = T(p.damping_init);
    bad = T(p.bad_factor);
    has_last = it = nfail = nconsec = best_nres = 0;
    if constexpr (kHist) nhist = 0;
    stop = kNone;
  }

  __device__ __forceinline__ bool running(const SolverParams& p) const {
    return stop == kNone && it < p.max_iters_total;
  }

  // Propose, retry with lambda escalation (optimizer.h:356-399): each retry
  // calls propose(lam_try, upd) -> all(isfinite(step)), which keeps its
  // step where upd.  The warp runs the loop while any of its segments
  // retries, a segment voting with no other.  Returns whether a step was
  // kept; r_lam, r_bad, nf and nc are the retries' lambda, bad factor and
  // failure counts.
  template <int S, typename Propose>
  __device__ __forceinline__ bool retry(const SolverParams& p, bool act,
                                        T& r_lam, T& r_bad, int& nf, int& nc,
                                        const Propose& propose) const {
    const T lam_lo = T(p.lam_lo), lam_hi = T(p.lam_hi);
    const T base_bad = T(p.bad_factor);
    const bool lam_sched = kDogLeg || p.solver != kSolverGN;
    const int max_tries =
        p.max_consec_failures > 0 ? p.max_consec_failures : 255;
    bool ok = false, give_up = false;
    r_lam = lam;
    r_bad = bad;
    nf = nfail;
    nc = nconsec;
    while (true) {
      const bool upd = act && !ok && !give_up && nc <= max_tries;
      if (!warp_any<S>(upd)) break;
      const bool ok_new = propose(r_lam, upd);
      if (upd) {
        if (!ok_new) {
          ++nf;
          ++nc;
        }
        const bool gu_new = !ok_new && p.max_consec_failures > 0 &&
                            nc >= p.max_consec_failures;
        ok = ok_new;
        if (!ok_new && !gu_new && lam_sched) {
          if constexpr (kDogLeg) {
            r_lam = clampv(r_lam * base_bad, lam_lo, lam_hi);   // fixed shrink
          } else {
            r_lam = clampv(r_lam * r_bad, lam_lo, lam_hi);
            r_bad = r_bad * base_bad;
          }
        }
        give_up = give_up || gu_new;
      }
    }
    return ok;
  }

  // What to do with x after judge: apply the step from the rollback point
  // (best x where roll, else x) where apply, and keep x as best where
  // success.
  struct Move {
    bool success, roll, apply;
  };

  // The judgement of an active instance's step (optimizer.h:266-299,
  // 427-534) from the iteration's r'r (e_sum), finiteness of g (g_ok),
  // step norm, |g|^2 and the retries' outcome: early-failure routing,
  // accept / reject with the lambda schedule, the history slot (lane 0 of
  // the segment writes slot `it` of row b), the failure budgets and the
  // stop cascade, first match wins.  Advances the book by the iteration.
  __device__ __forceinline__ Move judge(const SolverParams& p,
                                        const SegIO<kHist>& io, int b, int sl,
                                        int nr, T e_sum, bool g_ok, bool ok,
                                        T dx_norm2, T gn2, T r_lam, T r_bad,
                                        int nf, int nc) {
    const T feps = float_epsilon_v<T>();
    const T noise = T(8) * eps_v<T>();
    const T lam_lo = T(p.lam_lo), lam_hi = T(p.lam_hi);
    const T base_bad = T(p.bad_factor), good_f = T(p.good_factor);
    const bool lam_sched = kDogLeg || p.solver != kSolverGN;
    T err = e_sum;
    if (!p.use_squared_norm) err = sqrt(err);
    if (p.downscale_by_2) err = T(0.5) * err;
    if (p.normalize) err = err / T(nr > 1 ? nr : 1);
    lam = r_lam;
    bad = r_bad;

    // ---- early failure routing ----
    const bool err_bad = !isfinite(err) || !g_ok;
    int stop_early = err_bad ? kNanOrInf : (ok ? kNone : kSolverFailed);
    if (stop_early == kNone && !isfinite(dx_norm2)) stop_early = kNanOrInf;
    const bool early_fail = stop_early != kNone;

    // ---- accept / reject (optimizer.h:427-459) ----
    const T derr = err - best_cost;
    const bool is_good = derr < T(0);
    const T rel_derr = (best_cost > feps && isfinite(best_cost))
                           ? (best_cost - err) / best_cost : T(0);
    const bool first_eval = !isfinite(best_cost);
    const bool good = is_good || first_eval;
    if (lam_sched) {
      if (!early_fail && good && !first_eval) {
        // the dogleg ignores the step quality
        const T q = (p.use_quality && !kDogLeg) ? rel_derr : T(0);
        const T t = T(2) * q - T(1);
        T s = q != T(0) ? fmax(good_f, T(1) - t * t * t) : good_f;
        if (bad != base_bad) s = s / bad;
        lam = clampv(lam * s, lam_lo, lam_hi);
        bad = base_bad;
      } else if (!early_fail && !good) {
        if constexpr (kDogLeg) {
          lam = clampv(lam * base_bad, lam_lo, lam_hi);
        } else {
          lam = clampv(lam * bad, lam_lo, lam_hi);
          bad = bad * base_bad;
        }
      }
    }
    if constexpr (kHist) {
      // slot `it` of an instance that did not fail early; succ records
      // is_good, not the auto-accepted good
      if (!early_fail) {
        if (sl == 0) {
          const size_t at = (size_t)b * p.cap + it;
          static_cast<T*>(io.errs)[at] = err;
          static_cast<T*>(io.deltas2)[at] = dx_norm2;
          static_cast<bool*>(io.succ)[at] = is_good;
        }
        nhist = it + 1;
      }
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
    int cascade = kNone;
    if (p.min_error > 0 && err < T(p.min_error))
      cascade = kMinError;
    else if (p.min_rerr_dec > 0 && rel_derr > noise && rel_derr < T(p.min_rerr_dec))
      cascade = kMinRelError;
    else if (p.min_step_norm2 > 0 && dx_norm2 < T(p.min_step_norm2))
      cascade = kMinDeltaNorm;
    else if (p.min_grad_norm2 > 0 && gn2 < T(p.min_grad_norm2))
      cascade = kMinGradNorm;

    // ---- apply / rollback / probe (optimizer.h:266-299) ----
    const bool returned_dx = !early_fail && !budget_fail;
    Move m;
    m.success = accepted && returned_dx;
    const bool probe = !m.success && !has_last && returned_dx;
    m.roll = !m.success && has_last;
    m.apply = (m.success || probe) && cascade == kNone &&
              it + 1 < p.max_iters_total;
    has_last = m.success ? 1 : (has_last ? 0 : (probe ? 1 : 0));
    ++it;
    nfail = nfail_new;
    nconsec = nconsec_new;
    stop = stop_early != kNone ? stop_early
           : (budget_stop != kNone ? budget_stop : cascade);
    return m;
  }

  // Lane 0 of the segment writes the stopped instance's scalars (row b).
  __device__ __forceinline__ void write(const SegIO<kHist>& io, int b,
                                        int sl) const {
    if (sl != 0) return;
    static_cast<T*>(io.cost)[b] = best_cost;
    static_cast<T*>(io.rerr)[b] = final_rerr;
    static_cast<T*>(io.lam)[b] = lam;
    static_cast<int*>(io.stop)[b] = stop == kNone ? kMaxIters : stop;
    static_cast<int*>(io.iters)[b] = it;
    static_cast<int*>(io.nfail)[b] = nfail;
    static_cast<int*>(io.nconsec)[b] = nconsec;
    static_cast<int*>(io.nres)[b] = best_nres;
    static_cast<int*>(io.nhist)[b] = kHist ? nhist : 0;
    static_cast<float*>(io.inlier)[b] = 1.0f;
    static_cast<float*>(io.duration)[b] = 0.0f;
  }
};

// H = J'J of the SE3 family at R'R = I from the points' centroid and
// centred scatter (see above): K, cb = c / K and C = sum e_k e_k' (xx, yy,
// zz, xy, xz, yz), e_k = p_k - cb.  H = A' diag(K I, tr(C) I - C) A with A
// = [[I, -[cb]x], [0, I]] (sum e_k = 0), applied in that factored form: the
// uncentred M = C + K cb cb' would round away the part of H that pins the
// rotation where the points lie close together or far from the origin.
template <typename T>
struct SE3Gram {
  T k, cb[3], cm[6];

  // from the segment's sums in double, s = (c, then M's xx, yy, zz, xy,
  // xz, yz): cb = c / K and C = M - c cb', centred in double, then rounded
  __device__ __forceinline__ void set(int K, const double (&s)[9]) {
    const double kd = K, b[3] = {s[0] / kd, s[1] / kd, s[2] / kd};
    k = T(K);
#pragma unroll
    for (int i = 0; i < 3; ++i) cb[i] = T(b[i]);
    cm[0] = T(s[3] - s[0] * b[0]);
    cm[1] = T(s[4] - s[1] * b[1]);
    cm[2] = T(s[5] - s[2] * b[2]);
    cm[3] = T(s[6] - s[0] * b[1]);
    cm[4] = T(s[7] - s[0] * b[2]);
    cm[5] = T(s[8] - s[1] * b[2]);
  }
  __device__ __forceinline__ void diag(T (&d)[6]) const {
    d[0] = d[1] = d[2] = k;
    d[3] = k * (cb[1] * cb[1] + cb[2] * cb[2]) + (cm[1] + cm[2]);
    d[4] = k * (cb[0] * cb[0] + cb[2] * cb[2]) + (cm[0] + cm[2]);
    d[5] = k * (cb[0] * cb[0] + cb[1] * cb[1]) + (cm[0] + cm[1]);
  }
  // out = H v: u = v_rho - cb x v_om, (K u, K cb x u + tr(C) v_om - C v_om)
  __device__ __forceinline__ void apply(const T (&v)[6], T (&out)[6]) const {
    T u[3], a[3];
    cross3(cb, v + 3, a);
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = v[i] - a[i];
    cross3(cb, u, a);
    const T tr = (cm[0] + cm[1]) + cm[2];
    const T mv[3] = {(cm[0] * v[3] + cm[3] * v[4]) + cm[4] * v[5],
                     (cm[3] * v[3] + cm[1] * v[4]) + cm[5] * v[5],
                     (cm[4] * v[3] + cm[5] * v[4]) + cm[2] * v[5]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[i] = k * u[i];
      out[3 + i] = k * a[i] + (tr * v[3 + i] - mv[i]);
    }
  }
};

// a'b over the 6 tangent entries, in pairs
template <typename T>
__device__ __forceinline__ T dot6(const T (&a)[6], const T (&b)[6]) {
  return ((a[0] * b[0] + a[1] * b[1]) + (a[2] * b[2] + a[3] * b[3])) +
         (a[4] * b[4] + a[5] * b[5]);
}

template <typename T>
__device__ __forceinline__ bool finite6(const T (&v)[6]) {
  bool f = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) f = f && isfinite(v[k]);
  return f;
}

// xor butterfly of N values over a segment of S lanes, full mask: every
// lane of the warp runs it
template <int S, int N, typename T>
__device__ __forceinline__ void seg_sums(T (&s)[N]) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    T o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __shfl_xor_sync(kFullMask, s[i], off);
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] += o[i];
  }
}

template <typename T, int S, int NP, bool kDogLeg, bool kHist>
__global__ void __launch_bounds__(kSegMaxThreads, 1)
solver_se3_kernel(const SolverParams p, const SegIO<kHist> io,
                  const SE3Family<T> fam, int B) {
  constexpr int W = 32 / S;   // instances a warp
  constexpr int P = SE3Family<T>::kP, D = SE3Family<T>::kD;
  const int lane = threadIdx.x & 31;
  const int sl = lane & (S - 1);
  const int seg = lane / S;
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps * W;
  int b = (blockIdx.x * warps + (threadIdx.x >> 5)) * W + seg;

  const int K = fam.K;
  const int nr = 3 * K;
  const T tiny = tiny_v<T>();
  const bool is_lm = p.solver != kSolverGN;

  // point j of the lane (p, then qhat; 0 past K) of instance bl
  int bl = 0;
  auto point = [&](int j, T (&v)[6]) {
    const int i = sl + j * S;
    const bool has = i < K;
    const size_t o = ((size_t)bl * K + (has ? i : K - 1)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T pv = __ldg(fam.points + o + c), tv = __ldg(fam.targets + o + c);
      v[c] = has ? pv : T(0);
      v[3 + c] = has ? tv : T(0);
    }
  };
  double mom[9];            // the lane's part of c and M, until H is built
  T x[P], best_x[P], g[D], hd[D];
  SE3Gram<T> H;
  bool fresh;               // H of the instance not built yet
  InstanceBook<T, kDogLeg, kHist> book;

  // Load instance b (a segment past the batch loads the last instance, so
  // every address is valid, and computes nothing that is kept).
  auto start = [&]() {
    bl = b < B ? b : B - 1;
#pragma unroll
    for (int i = 0; i < 9; ++i) mom[i] = 0.0;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      T v[6];
      point(j, v);
      const double pd[3] = {v[0], v[1], v[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c) mom[c] += pd[c];
      mom[3] += pd[0] * pd[0];
      mom[4] += pd[1] * pd[1];
      mom[5] += pd[2] * pd[2];
      mom[6] += pd[0] * pd[1];
      mom[7] += pd[0] * pd[2];
      mom[8] += pd[1] * pd[2];
    }
    const T* x0 = static_cast<const T*>(io.x0) + (size_t)bl * P;
#pragma unroll
    for (int i = 0; i < P; ++i) best_x[i] = x[i] = x0[i];
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = T(0);
    fresh = true;
    book.start(p);
  };

  // dxn = solve((H + diag(dampl)) dxn = -g), dampl = damp * lam_eff when
  // damped, else 0: cg_iters Jacobi-PCG steps, ops/linalg.pcg_core's
  // formulas, H applied from its ten numbers; returns all(isfinite(dxn)).
  auto solve = [&](bool damped, T lam_eff, T (&dxn)[D]) -> bool {
    T dampl[D], dinv[D], cr[D], cz[D], cp[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T damp = hd[k] == T(0) ? T(1) : hd[k];
      const T dl = damped ? damp * lam_eff : T(0);
      dampl[k] = dl;
      const T dd = hd[k] + dl;
      dinv[k] = dd > T(0) ? T(1) / dd : T(1);
      dxn[k] = 0;
      cr[k] = -g[k];
      cz[k] = cr[k] * dinv[k];
      cp[k] = cz[k];
    }
    T rz = dot6(cr, cz);
    for (int c = 0; c < p.cg_iters; ++c) {
      T hp[D];
      H.apply(cp, hp);
#pragma unroll
      for (int k = 0; k < D; ++k) hp[k] = hp[k] + dampl[k] * cp[k];
      const T denom = dot6(cp, hp);
      const T alpha = denom > tiny ? rz / denom : T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        dxn[k] = dxn[k] + alpha * cp[k];
        cr[k] = cr[k] - alpha * hp[k];
        cz[k] = cr[k] * dinv[k];
      }
      const T rz_new = dot6(cr, cz);
      const T beta = rz_new / (rz > tiny ? rz : tiny);
#pragma unroll
      for (int k = 0; k < D; ++k) cp[k] = cz[k] + beta * cp[k];
      rz = rz_new;
    }
    return finite6(dxn);
  };

  // The Powell dogleg of one retry in the trust radius ref / lam_try (the
  // twin's GN step, g'Hg, then solvers/step.dogleg_core); g'Hg is a
  // quadratic form on H, the damped solves run where this instance needs
  // them.
  auto propose_dogleg = [&](T lam_try, T (&dxn)[D]) -> bool {
    const T kappa2 = T(1e6);
    T gn[D], reg[D], hg[D], ta[D], tb[D];
    const bool ok_gn = solve(false, T(0), gn);
    H.apply(g, hg);
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (!ok_gn) gn[k] = T(0);
    const T gg = dot6(g, g), gHg = dot6(g, hg);
    const bool pos_curv = gHg > T(0);
    DogLegGeometry<T> geo;
    geo.alpha = pos_curv ? gg / gHg : T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) ta[k] = (-geo.alpha) * g[k];   // Cauchy point
    const T n_gn2 = dot6(gn, gn), n_sd2 = dot6(ta, ta);
    // an insane GN step (failed, or kappa times the Cauchy step) gives way
    // to a Levenberg step, damped by lambda, then by max(lambda, 1)
    const bool gn_sane = ok_gn && (!(n_sd2 > T(0)) || n_gn2 <= kappa2 * n_sd2);
    bool r1_sane = false, ok_r2 = false;
#pragma unroll
    for (int k = 0; k < D; ++k) reg[k] = T(0);
    if (!gn_sane) {
      const bool ok_r1 = solve(true, lam_try, reg);
      r1_sane = ok_r1 && (!(n_sd2 > T(0)) || dot6(reg, reg) <= kappa2 * n_sd2);
      if (!r1_sane) ok_r2 = solve(true, fmax(lam_try, T(1)), reg);
    }
    const bool ok_reg = r1_sane || ok_r2;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T sd = (-geo.alpha) * g[k];
      if (!ok_reg) reg[k] = sd;
      ta[k] = gn[k] - sd;
      tb[k] = sd;
    }
    const T n_reg2 = dot6(reg, reg), qa0 = dot6(ta, ta), qb0 = dot6(tb, ta);
    geo.finish(gn_sane, ok_reg, pos_curv, gg, n_gn2, n_sd2, n_reg2, qa0, qb0,
               lam_try);
#pragma unroll
    for (int k = 0; k < D; ++k) dxn[k] = geo.entry(gn[k], g[k], reg[k]);
    return finite6(dxn);
  };

  start();
  while (warp_any<S>(b < B)) {
    // ---- a new instance's H from its points' sums: one 9-value
    // butterfly in double ----
    if (warp_any<S>(fresh)) {
      double s[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) s[i] = mom[i];
      seg_sums<S>(s);
      if (fresh) {
        H.set(K, s);
        H.diag(hd);
        fresh = false;
      }
    }
    const bool act = b < B && book.it < p.max_iters_total;

    // ---- one pass over the lane's points at x: r'r and g = J'r = (sum w_k,
    // sum p_k x w_k), w_k = R' r_k; one 7-value butterfly ----
    T e_sum;
    {
      T R[9], s[7];
      quat_matrix(x, R);
      double xd[P];
#pragma unroll
      for (int i = 0; i < P; ++i) xd[i] = x[i];
#pragma unroll
      for (int i = 0; i < 7; ++i) s[i] = T(0);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const bool has = sl + j * S < K;
        T v[6], r[3], w[3], pw[3];
        point(j, v);
        // r_k in double, rounded once (see above)
        const double pd[3] = {v[0], v[1], v[2]};
        double a[3];
        quat_apply(xd, pd, a);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          r[c] = has ? T((a[c] + xd[4 + c]) - double(v[3 + c])) : T(0);
#pragma unroll
        for (int c = 0; c < 3; ++c) w[c] = (R[c] * r[0] + R[3 + c] * r[1]) + R[6 + c] * r[2];
        cross3(v, w, pw);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          s[c] += w[c];
          s[3 + c] += pw[c];
        }
        s[6] += (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
      }
      seg_sums<S>(s);
#pragma unroll
      for (int k = 0; k < D; ++k) g[k] = s[k];
      e_sum = s[6];
    }
    if (p.grad_clipping > 0) {
      const T v = T(p.grad_clipping);
#pragma unroll
      for (int k = 0; k < D; ++k) g[k] = fmin(fmax(g[k], -v), v);
    }

    // ---- propose, retry with lambda escalation; judge the step; apply /
    // rollback / probe: x (+) dx from the rollback point, a step that is
    // not applied leaving it as it is (the twin's retraction by 0 is
    // exact) ----
    T r_lam, r_bad;
    int nf, nc;
    T dx[D];
#pragma unroll
    for (int k = 0; k < D; ++k) dx[k] = 0;
    const bool ok = book.template retry<S>(
        p, act, r_lam, r_bad, nf, nc, [&](T lam_try, bool upd) {
          T dxn[D];
          bool ok_new;
          if constexpr (kDogLeg)
            ok_new = propose_dogleg(lam_try, dxn);
          else
            ok_new = solve(is_lm, lam_try, dxn);
          if (upd && ok_new) {
#pragma unroll
            for (int k = 0; k < D; ++k) dx[k] = dxn[k];
          }
          return ok_new;
        });
    if (act) {
      const auto m = book.judge(p, io, b, sl, nr, e_sum, finite6(g), ok,
                                dot6(dx, dx), dot6(g, g), r_lam, r_bad, nf,
                                nc);
      T xn[P];
#pragma unroll
      for (int i = 0; i < P; ++i) xn[i] = m.roll ? best_x[i] : x[i];
      if (m.apply) {
        T xr[P];
        se3_retract(xn, xn + 4, dx, xr, xr + 4);
#pragma unroll
        for (int i = 0; i < P; ++i) xn[i] = xr[i];
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (m.success) best_x[i] = x[i];
        x[i] = xn[i];
      }
    }

    // ---- a stopped instance is written out; its segment starts the next ----
    if (b < B && !book.running(p)) {
      T* xo = static_cast<T*>(io.x) + (size_t)b * P;
      T* go = static_cast<T*>(io.g) + (size_t)b * D;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (i % S == sl) xo[i] = x[i];
#pragma unroll
      for (int i = 0; i < D; ++i)
        if (i % S == sl) go[i] = book.it > 0 ? g[i] : T(0);
      if constexpr (kHist) {
        // the row's slots past num_hist, S apart over the segment: the
        // kernel writes every slot (a wrapper's memset of the rows cost
        // the 10k x 16 call ~5 us, PERF.md)
        const size_t row = (size_t)b * p.cap;
        for (int j = book.nhist + sl; j < p.cap; j += S) {
          static_cast<T*>(io.errs)[row + j] = T(0);
          static_cast<T*>(io.deltas2)[row + j] = T(0);
          static_cast<bool*>(io.succ)[row + j] = false;
        }
      }
      book.write(io, b, sl);
      b += stride;
      start();
    }
  }
}

// Points a lane of the SE3 kernel (ops/cuda_solver.SE3_POINTS): timed
// fastest of (S, NP) = (16, 1), (8, 2), (4, 4) and (2, 8) at 10k x 16 poses
// in float, (2, 8) in double (PERF.md).
template <typename T>
constexpr int se3_points() {
  return sizeof(T) == 4 ? 4 : 8;
}
// The most points an instance of the SE3 kernel (max(7, 3K) <= 64).
constexpr int kSE3MaxK = 21;

// The geometries the SE3 kernel is built for, (S, NP): NP = se3_points
// points a lane on the least power of two of lanes S with S * NP >= K
// (tests/test_torch_se3.py checks the plan takes only these).
#define K2_SE3_GEOMETRIES(X, np) X(1, np) X(2, np) X(4, np) X(8, np)

template <typename T, bool kDogLeg, bool kHist>
int launch_se3(const SolverParams& p, const SolverIO& io, int B, int S,
               int NP, int warps, int grid, cudaStream_t stream) {
  void (*kern)(const SolverParams, const SegIO<kHist>, const SE3Family<T>,
               int) = nullptr;
#define K2_SE3_PICK(s, np)                                                   \
  if constexpr (s == 1 || (s / 2) * np < kSE3MaxK) {                         \
    if (S == s && NP == np)                                                  \
      kern = solver_se3_kernel<T, s, np, kDogLeg, kHist>;                    \
  }
  K2_SE3_GEOMETRIES(K2_SE3_PICK, se3_points<T>())
#undef K2_SE3_PICK
  if (kern == nullptr || p.coloring != kColorNone || p.fam_m < 1 ||
      p.fam_m > kSE3MaxK || S * NP < p.fam_m || p.n_res != 3 * p.fam_m ||
      p.d != SE3Family<T>::kD || warps < 1 || warps * 32 > kSegMaxThreads ||
      (long long)grid * warps * (32 / S) < B ||
      kDogLeg != (p.solver == kSolverDogLeg) || kHist != (p.cap > 0))
    return (int)cudaErrorInvalidValue;
  const SE3Family<T> fam{static_cast<const T*>(io.data0),
                         static_cast<const T*>(io.data1), p.fam_m};
  int fit = 0;
  cudaError_t e = device_fit(reinterpret_cast<const void*>(kern), warps * 32,
                             0, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  SegIO<kHist> sio;
  std::memcpy(&sio, &io, sizeof(sio));
  kern<<<grid < fit ? grid : fit, warps * 32, 0, stream>>>(p, sio, fam, B);
  return (int)cudaGetLastError();
}

}  // namespace tinyopt
