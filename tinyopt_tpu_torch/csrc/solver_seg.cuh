// K2 for max(d, n_res) <= 64: solver_seg_kernel, the whole GN / LM /
// DogLeg solve with every per-instance value in registers (the SE3 family
// has a register kernel of its own, csrc/solver_se3.cuh).
//
// Same function as solver_kernel (csrc/solver.cu) and its twin
// ops/cuda_solver.fused_solve_plain: the same per-instance stop reason,
// iterations, failure counts, lambda, cost, x and g.
//
// What bounds it on an H100: latency and instruction issue, not bytes (the
// prior at 10k x 50 reads 6 MB and writes 4 MB).  Each outer iteration is a
// dependent chain: linearize, propose (a division a value; in the PCG
// branch cg_iters matvecs and butterflies), the retry loop, the reductions
// and the accept / stop logic.  The design shortens the chain and packs
// more instances into each warp:
//
// * One instance runs on a SEGMENT of S lanes (S a power of two, 1..32;
//   32 / S instances a warp).  Lane sl holds entries sl + k*S, k < E, of
//   every vector, in registers: x, best_x, g, diag(H), dx, the proposal,
//   the damping and its inverse, the PCG vectors, the residuals and J v
//   (the reference's last_dx is never read, so it is not kept).  Shared
//   memory holds nothing.  The family's per-instance data (y and
//   inv_std for the prior) is loaded once, when the instance starts.
// * Dot products are segment butterflies of log2(S) shuffles, after adds
//   inside the lane, in the order of solver_kernel's warp_dot (lane_part,
//   csrc/solver.cuh); the finiteness flags are one ballot.  The three sums
//   an iteration ends with (err, dx'dx, g'g) share one butterfly.
// * Control flow is uniform over the warp: it loops while any segment
//   holds an instance, and the retry loop runs while any segment retries
//   (the shape of the JAX kernel's tile, "any instance active",
//   pallas_solver.py:566-574, and of the twin's batch-native loop); a
//   segment that has nothing to do runs along and its results are
//   discarded.  Every shuffle uses the full mask and no lane leaves the
//   loop early; a value never crosses a segment's edge, so a NaN or a stop
//   in one segment cannot reach its neighbours.  (On one lane, S = 1, the
//   votes are the lane's own: warp_any.)
// * A persistent grid (as many blocks as fit the card at once, from the
//   occupancy query): a segment whose instance stops writes it out and
//   starts the instance one grid's worth of segments further on, at once,
//   without waiting for the other segments of its warp.
// * A family of fixed shape whose every vector fits one lane's entries
//   (kSegE >= kMaxM: Powell's and Wood's, d = 4 and 4 or 6 residuals) runs
//   one instance a thread (S = 1, min_segment): its jvp and vjp read the
//   lane's own registers, every sum is lane_part's whole tree in the
//   lane, the butterflies and ballots vanish, and d and n_res are the
//   family's constants.  An iteration is then a chain of the arithmetic
//   itself, not of shuffles that wait on each other.  The multi-color
//   coloring is built for these instances only; its tables (the probes and
//   the recovery, a few hundred bytes) are copied into shared memory once
//   a block.
//
// S and E are template parameters, chosen with the block size by
// ops/cuda_solver.k2_launch_plan; the identity coloring (closed-form step),
// no coloring (per-dim diag sweeps, PCG through J'(J p)) and the
// multi-color coloring (kColorMulti: a jvp of each color's probe row and
// the recovery sum, the JAX kernel's pallas_solver.py:269-279; PCG, or the
// closed form when one color) are separate instances, so the closed-form
// kernel holds no PCG registers and only the multi-color one takes the
// coloring's tables.  So are the
// dogleg (kDogLeg: up to three solves a proposal, GN then damped by lambda
// then by max(lambda, 1), each damped one while any segment of the warp
// needs it, and g'Hg by one more J'(J g); the GN and LM kernels keep none
// of its registers) and the history (kHist: lane 0 of a segment writes
// slot `it` of its instance's rows each iteration, and the segment writes
// 0 past num_hist when the instance stops, so the rows need no fill; on one
// lane the rows come zeroed from the wrapper instead, one coalesced memset:
// a lane writing its own row's tail value by value, 32 rows apart across
// the warp, took most of a short call, PERF.md).
#pragma once

#include <cstddef>
#include <cstring>
#include <type_traits>

#include "solver.cuh"

namespace tinyopt {

// The kernel's pointers without the history rows: SolverIO's leading ones.
// The instances without history take this, the history instances all of
// SolverIO.  Passed the whole SolverIO (152 bytes), the GN / LM kernels
// addressed the parameter block through a pointer instead of loading its
// fields once, which cost the float64 closed-form prior kernel 6 registers
// and a block an SM (PERF.md); at 128 bytes they compile as before.
struct SolverIONoHist {
  const void* x0;
  const void* data0;
  const void* data1;
  void *x, *cost, *rerr, *lam, *g, *stop, *iters, *nfail, *nconsec, *nres,
      *nhist, *inlier, *duration;
};
static_assert(sizeof(SolverIONoHist) == offsetof(SolverIO, errs),
              "SolverIONoHist must be SolverIO's leading fields");
template <bool kHist>
using SegIO = std::conditional_t<kHist, SolverIO, SolverIONoHist>;

// The coloring's constants, a kernel parameter of the multi-color instances
// only: the others take an empty struct and compile as before.
struct NoColorTables {};
template <int kColor>
using SegColor =
    std::conditional_t<kColor == kColorMulti, ColorTables, NoColorTables>;

// Threads a block of solver_seg_kernel at most (ops/cuda_solver.SEG_WARPS).
// The launch bound (128 threads, at least 1 block an SM) lets ptxas allot
// registers for blocks this small: 88 a thread in float and 126 in double
// on the closed-form prior kernel, no spill, against 95 and 130 without a
// bound; naming the threads alone made ptxas cap float at 80 and spill
// (PERF.md).
constexpr int kSegMaxThreads = 128;

// Whether the flag holds on any lane of the warp: the vote of the
// warp-uniform loops and branches.  On one lane (S = 1) nothing is shared
// across lanes, so each lane decides for its own instance: a lane whose
// instance needs no more tries, or no damped solve, goes on without
// waiting for the others, and no result changes (the work a vote adds
// for a lane that does not need it is discarded).
template <int S>
__device__ __forceinline__ bool warp_any(bool f) {
  if constexpr (S == 1)
    return f;
  else
    return __any_sync(kFullMask, f);
}

// The multi-color instances' shared copy of the coloring's tables (dynamic
// shared memory, sized by launch_seg_family).
template <typename T>
__device__ __forceinline__ T* seg_tables() {
  extern __shared__ __align__(16) unsigned char seg_smem[];
  return reinterpret_cast<T*>(seg_smem);
}

// The least segment a family runs on: one lane where one lane's entries
// hold every vector of every instance (kSegE >= kMaxM, the fixed shapes of
// Powell and Wood), else 2 lanes.
template <typename Fam>
constexpr int min_segment() {
  return Fam::kSegE >= Fam::kMaxM ? 1 : 2;
}

// d and n_res of an instance: on one lane (S = 1) its family's fixed shape,
// known to the compiler; the run-time values on wider segments.
template <typename Fam, int S>
__device__ __forceinline__ int seg_d(int d) {
  if constexpr (S == 1)
    return Fam::kD;
  else
    return d;
}
template <typename Fam, int S>
__device__ __forceinline__ int seg_n_res(int n_res) {
  if constexpr (S == 1)
    return Fam::kNRes;
  else
    return n_res;
}

// Entries a lane holds of the tangent-wide vectors (x, best_x, g, diag(H),
// the steps, the damping, the PCG vectors) and of the residual-wide ones
// (r, J v): E both, or for a family with kSplitWidths (the generated
// families, one instance a thread) its kD and kNRes, so a curve fit of 2
// parameters and 60 residuals keeps 2-wide steps and gradients.
template <typename Fam, typename = void>
struct SplitWidths : std::false_type {};
template <typename Fam>
struct SplitWidths<Fam, std::void_t<decltype(Fam::kSplitWidths)>>
    : std::integral_constant<bool, Fam::kSplitWidths> {};
template <typename Fam, int E>
__host__ __device__ constexpr int tangent_entries() {
  if constexpr (SplitWidths<Fam>::value)
    return Fam::kD;
  else
    return E;
}
template <typename Fam, int E>
__host__ __device__ constexpr int residual_entries() {
  if constexpr (SplitWidths<Fam>::value)
    return Fam::kNRes;
  else
    return E;
}
// Entries a lane holds of the parameters (x, best_x): the tangent's, or a
// split-width family's kP (kD on Euclidean parameters, so an SE3 pose
// keeps its 7 stored values beside 6-wide steps).
template <typename Fam, int E>
__host__ __device__ constexpr int param_entries() {
  if constexpr (SplitWidths<Fam>::value)
    return Fam::kP;
  else
    return E;
}

// The Powell dogleg of one retry for the segment's instance, in the trust
// radius ref / lam_try: the twin's GN step, g'Hg, then solvers/step.
// dogleg_core, same operations in the same order.  `solve(damped, lam,
// out)` is the kernel's damped solve.  Only the kDogLeg instances call it,
// so the GN / LM instances compile none of it.
template <typename T, int S, int E, int ER, int EP, typename Lanes,
          typename Solve>
__device__ __forceinline__ bool propose_dogleg(
    const Lanes& fl, const T (&x)[EP], const T (&g)[E], const bool (&vt)[E],
    unsigned bits, T lam_try, const Solve& solve, T (&dxn)[E]) {
  const T kappa2 = T(1e6);
  T gn[E], reg[E], ta[E], tb[E], tc[E];
  const bool ok_gn = solve(false, T(0), gn);
  {
    T jp[ER], hg[E];
    fl.jvp(x, g, jp);
    fl.vjp(x, jp, hg);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (!ok_gn) gn[k] = T(0);
      ta[k] = g[k] * g[k];
      tb[k] = g[k] * hg[k];
    }
  }
  T gg = lane_part<S, E>(ta), gHg = lane_part<S, E>(tb);
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const T o1 = __shfl_xor_sync(kFullMask, gg, off);
    const T o2 = __shfl_xor_sync(kFullMask, gHg, off);
    gg += o1;
    gHg += o2;
  }
  const bool pos_curv = gHg > T(0);
  DogLegGeometry<T> geo;
  geo.alpha = pos_curv ? gg / gHg : T(0);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const T sd = (-geo.alpha) * g[k];   // Cauchy point
    ta[k] = gn[k] * gn[k];
    tb[k] = sd * sd;
  }
  T n_gn2 = lane_part<S, E>(ta), n_sd2 = lane_part<S, E>(tb);
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const T o1 = __shfl_xor_sync(kFullMask, n_gn2, off);
    const T o2 = __shfl_xor_sync(kFullMask, n_sd2, off);
    n_gn2 += o1;
    n_sd2 += o2;
  }
  // an insane GN step (failed, or kappa times the Cauchy step) gives way to
  // a Levenberg step, damped by lambda, then by max(lambda, 1); each solve
  // runs while any segment of the warp needs it, and its result is kept
  // for the segments that do
  const bool gn_sane = ok_gn && (!(n_sd2 > T(0)) || n_gn2 <= kappa2 * n_sd2);
  const bool need = !gn_sane;
  bool r1_sane = false;
#pragma unroll
  for (int k = 0; k < E; ++k) reg[k] = T(0);
  if (warp_any<S>(need)) {
    const bool ok_r1 = solve(true, lam_try, reg) && need;
#pragma unroll
    for (int k = 0; k < E; ++k) ta[k] = reg[k] * reg[k];
    const T n_r1 = seg_sum<S>(lane_part<S, E>(ta));
    r1_sane = ok_r1 && (!(n_sd2 > T(0)) || n_r1 <= kappa2 * n_sd2);
  }
  const bool need2 = need && !r1_sane;
  bool ok_r2 = false;
  if (warp_any<S>(need2)) {
    T r2[E];
    ok_r2 = solve(true, fmax(lam_try, T(1)), r2) && need2;
#pragma unroll
    for (int k = 0; k < E; ++k) reg[k] = r1_sane ? reg[k] : r2[k];
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) reg[k] = r1_sane ? reg[k] : T(0);
  }
  const bool ok_reg = r1_sane || ok_r2;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const T sd = (-geo.alpha) * g[k];
    if (!ok_reg) reg[k] = sd;
    const T dv = gn[k] - sd;
    ta[k] = reg[k] * reg[k];
    tb[k] = dv * dv;
    tc[k] = sd * dv;
  }
  T n_reg2 = lane_part<S, E>(ta), qa0 = lane_part<S, E>(tb),
    qb0 = lane_part<S, E>(tc);
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const T o1 = __shfl_xor_sync(kFullMask, n_reg2, off);
    const T o2 = __shfl_xor_sync(kFullMask, qa0, off);
    const T o3 = __shfl_xor_sync(kFullMask, qb0, off);
    n_reg2 += o1;
    qa0 += o2;
    qb0 += o3;
  }
  geo.finish(gn_sane, ok_reg, pos_curv, gg, n_gn2, n_sd2, n_reg2, qa0, qb0,
             lam_try);
  bool f = true;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    dxn[k] = geo.entry(gn[k], g[k], reg[k]);
    f = f && (!vt[k] || isfinite(dxn[k]));
  }
  return seg_all<S>(f, bits);
}

template <typename T, typename Fam, int S, int E, int kColor, bool kDogLeg,
          bool kHist>
__global__ void __launch_bounds__(kSegMaxThreads, 1)
solver_seg_kernel(const SolverParams p, const SegIO<kHist> io, const Fam fam,
                  int B, const SegColor<kColor> ct) {
  static_assert(kColor != kColorMulti || S == 1,
                "the multi-color coloring runs one instance a lane");
  constexpr int W = 32 / S;   // instances a warp
  // entries a lane of the tangent-wide and of the residual-wide vectors
  constexpr int ET = tangent_entries<Fam, E>();
  constexpr int ER = residual_entries<Fam, E>();
  constexpr int EP = param_entries<Fam, E>();   // of the parameters
  static_assert(S == 1 || (ET == E && ER == E && EP == E),
                "split widths run one instance a lane");
  const int lane = threadIdx.x & 31;
  const int sl = lane & (S - 1);
  const int seg = lane / S;
  const unsigned bits = S == 32 ? kFullMask : ((1u << S) - 1u) << (seg * S);
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps * W;
  int b = (blockIdx.x * warps + (threadIdx.x >> 5)) * W + seg;

  const int d = seg_d<Fam, S>(p.d);
  const int P = param_width<Fam>(d);
  const int nr = seg_n_res<Fam, S>(p.n_res);
  const T tiny = tiny_v<T>();
  const T feps = float_epsilon_v<T>();
  const T noise = T(8) * eps_v<T>();
  const T inf = T(INFINITY);
  const T lam_lo = T(p.lam_lo), lam_hi = T(p.lam_hi);
  const T base_bad = T(p.bad_factor), good_f = T(p.good_factor);
  // a GN / LM instance serves GN and LM only (launch_segment)
  const bool is_lm = p.solver != kSolverGN;
  const bool lam_sched = kDogLeg || is_lm;
  const int max_tries = p.max_consec_failures > 0 ? p.max_consec_failures : 255;

  // EP >= ET: a loop over the parameters' entries handles the tangent's
  // first ET of them (k < ET is constant in the unrolled loop)
  static_assert(EP >= ET, "P >= D");
  bool vt[ET];   // entry k is a tangent entry (index < d)
  bool vx[EP];   // entry k is a parameter entry (index < P; vt when P = d)
#pragma unroll
  for (int k = 0; k < EP; ++k) {
    if (k < ET) vt[k] = sl + k * S < d;
    vx[k] = sl + k * S < P;
  }

  typename Fam::template Lanes<S, E> fl;
  T x[EP], best_x[EP], g[ET], diagH[ET];
  T best_cost, final_rerr, lam, bad;
  int has_last, it, nfail, nconsec, stop, best_nres;
  int nhist = 0;

  // Load instance b (a segment past the batch loads the last instance, so
  // every address is valid, and computes nothing that is kept).
  auto start = [&]() {
    const int bl = b < B ? b : B - 1;
    fl.start(fam, bl, sl);
    const T* x0 = static_cast<const T*>(io.x0) + (size_t)bl * P;
#pragma unroll
    for (int k = 0; k < EP; ++k) {
      const int i = sl + k * S;
      const T v = x0[i < P ? i : P - 1];
      x[k] = vx[k] ? v : T(0);
      best_x[k] = x[k];
      if (k < ET) g[k] = T(0);
    }
    best_cost = inf;
    final_rerr = inf;
    lam = T(p.damping_init);
    bad = base_bad;
    has_last = it = nfail = nconsec = best_nres = 0;
    if constexpr (kHist) nhist = 0;
    stop = kNone;
  };

  // dxn = solve((H + diag(dampl)) dxn = -g), dampl = damp * lam_eff when
  // damped, else 0; returns all(isfinite(dxn)).
  auto solve = [&](bool damped, T lam_eff, T (&dxn)[ET]) -> bool {
    T dampl[ET], dinv[ET];
#pragma unroll
    for (int k = 0; k < ET; ++k) {
      const T damp = diagH[k] == T(0) ? T(1) : diagH[k];
      const T dl = damped ? damp * lam_eff : T(0);
      dampl[k] = dl;
      const T dd = diagH[k] + dl;
      dinv[k] = dd > T(0) ? T(1) / dd : T(1);
    }
    if (kColor == kColorIdentity || (kColor == kColorMulti && p.n_colors == 1)) {
      // One color (the identity, or one probe and its recovery): H = J'J is
      // exactly diagonal, the damped system solves in closed form (the JAX
      // kernel's n_colors == 1 branch).
#pragma unroll
      for (int k = 0; k < ET; ++k) dxn[k] = (-g[k]) * dinv[k];
    } else {
      // Jacobi-PCG, ops/linalg.pcg_core formulas.
      T cr[ET], cz[ET], cp[ET], t[ET];
#pragma unroll
      for (int k = 0; k < ET; ++k) {
        dxn[k] = 0;
        cr[k] = -g[k];
        cz[k] = cr[k] * dinv[k];
        cp[k] = cz[k];
        t[k] = cr[k] * cz[k];
      }
      T rz = seg_sum<S>(lane_part<S, ET>(t));
      for (int c = 0; c < p.cg_iters; ++c) {
        T jp[ER], hp[ET];
        fl.jvp(x, cp, jp);
        fl.vjp(x, jp, hp);
#pragma unroll
        for (int k = 0; k < ET; ++k) {
          hp[k] = hp[k] + dampl[k] * cp[k];
          t[k] = cp[k] * hp[k];
        }
        const T denom = seg_sum<S>(lane_part<S, ET>(t));
        const T alpha = denom > tiny ? rz / denom : T(0);
#pragma unroll
        for (int k = 0; k < ET; ++k) {
          dxn[k] = dxn[k] + alpha * cp[k];
          cr[k] = cr[k] - alpha * hp[k];
          cz[k] = cr[k] * dinv[k];
          t[k] = cr[k] * cz[k];
        }
        const T rz_new = seg_sum<S>(lane_part<S, ET>(t));
        const T beta = rz_new / (rz > tiny ? rz : tiny);
#pragma unroll
        for (int k = 0; k < ET; ++k) cp[k] = cz[k] + beta * cp[k];
        rz = rz_new;
      }
    }
    bool f = true;
#pragma unroll
    for (int k = 0; k < ET; ++k) f = f && (!vt[k] || isfinite(dxn[k]));
    return seg_all<S>(f, bits);
  };

  // the coloring's tables, copied into shared memory once a block: the
  // probes (n_colors, d), then the recovery (n_colors * n_res, d)
  if constexpr (kColor == kColorMulti) {
    const int np = p.n_colors * d, n = np * (1 + nr);
    T* tab = seg_tables<T>();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tab[i] = i < np ? static_cast<const T*>(ct.probes)[i]
                      : static_cast<const T*>(ct.recovery)[i - np];
    __syncthreads();
  }

  start();
  while (warp_any<S>(b < B)) {
    const bool act = b < B && it < p.max_iters_total;

    // ---- linearize at x: g, diag(H), and this lane's part of r'r ----
    T e_part;
    {
      T r[ER], rr[ER];
      fl.residual(x, r);
#pragma unroll
      for (int k = 0; k < ER; ++k) rr[k] = r[k] * r[k];
      e_part = lane_part<S, ER>(rr);
      fl.vjp(x, r, g);
    }
    if constexpr (kColor == kColorIdentity) {
      // J diagonal: n_res >= d, residual k the one of tangent entry k
      static_assert(ER >= ET, "the identity coloring has n_res >= d");
      T ones[ET], jp[ER];
#pragma unroll
      for (int k = 0; k < ET; ++k) ones[k] = vt[k] ? T(1) : T(0);
      fl.jvp(x, ones, jp);
#pragma unroll
      for (int k = 0; k < ET; ++k) diagH[k] = vt[k] ? jp[k] * jp[k] : T(0);
    } else if constexpr (kColor == kColorMulti) {
      // Curtis-Powell-Reid: a jvp of each color's probe row, the squares,
      // then diag_j = sum over the recovery's rows (c, i) in ascending
      // order of sq_i * recovery[c * n_res + i][j], the twin's sum; the
      // tables from the block's shared copy, every lane reading the same
      // address (a broadcast).
      const T* tab_probes = seg_tables<T>();
      const T* tab_rec = tab_probes + p.n_colors * d;
#pragma unroll
      for (int k = 0; k < ET; ++k) diagH[k] = T(0);
      for (int c = 0; c < p.n_colors; ++c) {
        T pv[ET], jp[ER];
#pragma unroll
        for (int k = 0; k < ET; ++k) pv[k] = vt[k] ? tab_probes[c * d + k] : T(0);
        fl.jvp(x, pv, jp);
#pragma unroll
        for (int i = 0; i < ER; ++i) {
          if (i < nr) {
            const T sq = jp[i] * jp[i];
            const T* row = tab_rec + (c * nr + i) * d;
#pragma unroll
            for (int k = 0; k < ET; ++k)
              if (vt[k]) diagH[k] = diagH[k] + sq * row[k];
          }
        }
      }
    } else if constexpr (SplitWidths<Fam>::value) {
      // a jvp a tangent dimension, in a loop the compiler keeps (one copy
      // of the generated jvp, however wide d): column j of J, then its
      // squared norm into diag(H)_j by selects
#pragma unroll
      for (int k = 0; k < ET; ++k) diagH[k] = T(0);
#pragma unroll 1
      for (int j = 0; j < ET; ++j) {
        T tv[ET], jp[ER];
#pragma unroll
        for (int kk = 0; kk < ET; ++kk) tv[kk] = kk == j ? T(1) : T(0);
        fl.jvp(x, tv, jp);
#pragma unroll
        for (int kk = 0; kk < ER; ++kk) jp[kk] = jp[kk] * jp[kk];
        const T dj = lane_part<S, ER>(jp);
#pragma unroll
        for (int kk = 0; kk < ET; ++kk) diagH[kk] = kk == j ? dj : diagH[kk];
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        diagH[k] = T(0);
        for (int s = 0; s < S && s + k * S < d; ++s) {
          // column j = s + k*S: J e_j, then its squared norm
          T tv[E], jp[E];
#pragma unroll
          for (int kk = 0; kk < E; ++kk) tv[kk] = (kk == k && sl == s) ? T(1) : T(0);
          fl.jvp(x, tv, jp);
#pragma unroll
          for (int kk = 0; kk < E; ++kk) jp[kk] = jp[kk] * jp[kk];
          const T dj = seg_sum<S>(lane_part<S, E>(jp));
          if (sl == s) diagH[k] = dj;
        }
      }
    }
    if (p.grad_clipping > 0) {
      const T v = T(p.grad_clipping);
#pragma unroll
      for (int k = 0; k < ET; ++k) g[k] = fmin(fmax(g[k], -v), v);
    }

    // ---- propose, retry with lambda escalation (optimizer.h:356-399) ----
    bool ok = false, give_up = false;
    T r_lam = lam, r_bad = bad;
    int nf = nfail, nc = nconsec;
    T dx[ET];
#pragma unroll
    for (int k = 0; k < ET; ++k) dx[k] = 0;
    while (true) {
      const bool upd = act && !ok && !give_up && nc <= max_tries;
      if (!warp_any<S>(upd)) break;
      T dxn[ET];
      bool ok_new;
      if constexpr (kDogLeg)
        ok_new = propose_dogleg<T, S, ET, ER>(fl, x, g, vt, bits, r_lam, solve,
                                              dxn);
      else
        ok_new = solve(is_lm, r_lam, dxn);
      if (upd) {
        if (!ok_new) {
          ++nf;
          ++nc;
        }
        const bool gu_new = !ok_new && p.max_consec_failures > 0 &&
                            nc >= p.max_consec_failures;
        if (ok_new) {
#pragma unroll
          for (int k = 0; k < ET; ++k) dx[k] = vt[k] ? dxn[k] : T(0);
        }
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

    // ---- err, dx'dx, g'g in one butterfly; finiteness of g ----
    T dx_part, g_part;
    bool g_fin = true;
    {
      T dd[ET], gg[ET];
#pragma unroll
      for (int k = 0; k < ET; ++k) {
        dd[k] = dx[k] * dx[k];
        gg[k] = g[k] * g[k];
        g_fin = g_fin && (!vt[k] || isfinite(g[k]));
      }
      dx_part = lane_part<S, ET>(dd);
      g_part = lane_part<S, ET>(gg);
    }
#pragma unroll
    for (int off = S / 2; off > 0; off >>= 1) {
      const T oe = __shfl_xor_sync(kFullMask, e_part, off);
      const T ox = __shfl_xor_sync(kFullMask, dx_part, off);
      const T og = __shfl_xor_sync(kFullMask, g_part, off);
      e_part += oe;
      dx_part += ox;
      g_part += og;
    }
    const bool g_ok = seg_all<S>(g_fin, bits);

    if (act) {
      T err = e_part;
      if (!p.use_squared_norm) err = sqrt(err);
      if (p.downscale_by_2) err = T(0.5) * err;
      if (p.normalize) err = err / T(nr > 1 ? nr : 1);
      lam = r_lam;
      bad = r_bad;

      // ---- early failure routing ----
      const bool err_bad = !isfinite(err) || !g_ok;
      int stop_early = err_bad ? kNanOrInf : (ok ? kNone : kSolverFailed);
      const T dx_norm2 = dx_part;
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
      const T gn2 = g_part;
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
        // x (+) dx from the rollback point, dx = 0 where no step applies:
        // the retraction on every iteration, as the twin's retract_flat of
        // the whole batch (solver_kernel's manifold branch)
        T xb[EP], dd[ET], xn[EP];
#pragma unroll
        for (int k = 0; k < EP; ++k) xb[k] = roll ? best_x[k] : x[k];
#pragma unroll
        for (int k = 0; k < ET; ++k) dd[k] = apply ? dx[k] : T(0);
        fl.retract(xb, dd, xn);
#pragma unroll
        for (int k = 0; k < EP; ++k) {
          if (success) best_x[k] = x[k];
          x[k] = xn[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < ET; ++k) {
          const T xb = roll ? best_x[k] : x[k];
          const T xn = xb + (apply ? dx[k] : T(0));
          if (success) best_x[k] = x[k];
          x[k] = xn;
        }
      }
      has_last = success ? 1 : (has_last ? 0 : (probe ? 1 : 0));
      ++it;
      nfail = nfail_new;
      nconsec = nconsec_new;
      stop = stop_new;
    }

    // ---- a stopped instance is written out; its segment starts the next ----
    if (b < B && !(stop == kNone && it < p.max_iters_total)) {
      T* xo = static_cast<T*>(io.x) + (size_t)b * P;
      T* go = static_cast<T*>(io.g) + (size_t)b * d;
#pragma unroll
      for (int k = 0; k < EP; ++k) {
        if (vx[k]) xo[sl + k * S] = x[k];
        if (k < ET && vt[k]) go[sl + k * S] = it > 0 ? g[k] : T(0);
      }
      if constexpr (kHist && S > 1) {
        const size_t row = (size_t)b * p.cap;
        for (int j = nhist + sl; j < p.cap; j += S) {
          static_cast<T*>(io.errs)[row + j] = T(0);
          static_cast<T*>(io.deltas2)[row + j] = T(0);
          static_cast<bool*>(io.succ)[row + j] = false;
        }
      }
      if (sl == 0) {
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
      b += stride;
      start();
    }
  }
}

// The segment widths K2 is built for, each family with its own entries a
// lane (Fam::kSegE), from its least segment (min_segment) up while
// (S / 2) * kSegE < kMaxM: every plan ops/cuda_solver.k2_launch_plan can
// choose, the least S with S * kSegE >= max(P, d, n_res) for max(P, d,
// n_res) <= 64 (tests/test_torch_fused.py checks the two agree).
#define K2_SEGMENTS(X) X(1) X(2) X(4) X(8) X(16) X(32)

template <typename T, typename Fam, int kColor, bool kDogLeg, bool kHist>
int launch_seg_family(const SolverParams& p, const SolverIO& io,
                      const Fam& fam, const ColorTables& tables, int B, int S,
                      int E, int warps, int grid, cudaStream_t stream) {
  void (*kern)(const SolverParams, const SegIO<kHist>, const Fam, int,
               const SegColor<kColor>) = nullptr;
  if (E != Fam::kSegE) return (int)cudaErrorInvalidValue;
  constexpr int kLeast = min_segment<Fam>();
#define K2_PICK(s)                                                           \
  if constexpr (s == kLeast ||                                               \
                (s > kLeast && (s / 2) * Fam::kSegE < Fam::kMaxM)) {         \
    if (S == s)                                                              \
      kern = solver_seg_kernel<T, Fam, s, Fam::kSegE, kColor, kDogLeg,       \
                               kHist>;                                       \
  }
  K2_SEGMENTS(K2_PICK)
#undef K2_PICK
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  // the multi-color instances' shared copy of the tables
  int smem = 0;
  SegColor<kColor> ct{};
  if constexpr (kColor == kColorMulti) {
    if (tables.probes == nullptr || tables.recovery == nullptr ||
        p.n_colors < 1 || p.n_colors > p.d)
      return (int)cudaErrorInvalidValue;
    smem = (int)(p.n_colors * p.d * (1 + p.n_res) * sizeof(T));
    ct = tables;
  }
  int fit = 0;
  cudaError_t e = device_fit(reinterpret_cast<const void*>(kern), warps * 32,
                             smem, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  SegIO<kHist> sio;
  std::memcpy(&sio, &io, sizeof(sio));
  kern<<<grid < fit ? grid : fit, warps * 32, smem, stream>>>(p, sio, fam, B,
                                                               ct);
  return (int)cudaGetLastError();
}

// The SE3 family's register kernel (csrc/solver_se3.cuh): S lanes and NP
// points a lane an instance.
template <typename T, bool kDogLeg, bool kHist>
int launch_se3(const SolverParams& p, const SolverIO& io, int B, int S,
               int NP, int warps, int grid, cudaStream_t stream);

// The register kernels of one type, solver kind (kDogLeg: the dogleg, else
// GN / LM) and history (kHist); each combination is compiled in a
// translation unit of its own (csrc/solver_seg*_f32.cu, *_f64.cu), the SE3
// family's kernels with them (E is its points a lane there).
template <typename T, bool kDogLeg, bool kHist>
int launch_segment(const SolverParams& p, const SolverIO& io,
                   const ColorTables& tables, int B, int S, int E, int warps,
                   int grid, cudaStream_t stream) {
  if (p.family == kSE3)
    return launch_se3<T, kDogLeg, kHist>(p, io, B, S, E, warps, grid, stream);
  const int m = p.d > p.n_res ? p.d : p.n_res;
  if (S < 1 || S > 32 || (S & (S - 1)) || E < 1 || S * E < m || m > 64 ||
      warps < 1 || warps * 32 > kSegMaxThreads ||
      (long long)grid * warps * (32 / S) < B ||
      kDogLeg != (p.solver == kSolverDogLeg) || kHist != (p.cap > 0))
    return (int)cudaErrorInvalidValue;
  // the colorings each family is built for (ops/cuda_solver.SEG_COLORINGS)
  const int col = p.coloring;
  if (p.family == kPrior && col != kColorMulti) {
    PriorFamily<T> fam{static_cast<const T*>(io.data0),
                       static_cast<const T*>(io.data1), p.d};
    return col == kColorIdentity
        ? launch_seg_family<T, PriorFamily<T>, kColorIdentity, kDogLeg, kHist>(
              p, io, fam, tables, B, S, E, warps, grid, stream)
        : launch_seg_family<T, PriorFamily<T>, kColorNone, kDogLeg, kHist>(
              p, io, fam, tables, B, S, E, warps, grid, stream);
  }
  if (p.family == kJennrichSampson && col == kColorNone) {
    JenSamFamily<T> fam{p.fam_m};
    return launch_seg_family<T, JenSamFamily<T>, kColorNone, kDogLeg, kHist>(
        p, io, fam, tables, B, S, E, warps, grid, stream);
  }
  if (p.family == kPowell && col != kColorIdentity) {
    PowellFamily<T> fam{};
    return col == kColorMulti
        ? launch_seg_family<T, PowellFamily<T>, kColorMulti, kDogLeg, kHist>(
              p, io, fam, tables, B, S, E, warps, grid, stream)
        : launch_seg_family<T, PowellFamily<T>, kColorNone, kDogLeg, kHist>(
              p, io, fam, tables, B, S, E, warps, grid, stream);
  }
  if (p.family == kWood && col != kColorIdentity) {
    WoodFamily<T> fam{};
    return col == kColorMulti
        ? launch_seg_family<T, WoodFamily<T>, kColorMulti, kDogLeg, kHist>(
              p, io, fam, tables, B, S, E, warps, grid, stream)
        : launch_seg_family<T, WoodFamily<T>, kColorNone, kDogLeg, kHist>(
              p, io, fam, tables, B, S, E, warps, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tinyopt
