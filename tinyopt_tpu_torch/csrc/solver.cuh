// K2's parameters, outputs and residual families, shared by its two
// kernels: solver_kernel (csrc/solver.cu, state in shared memory, any d)
// and solver_seg_kernel (csrc/solver_seg.cuh, state in registers,
// max(d, n_res) <= 64).
#pragma once

#include "common.cuh"

namespace tinyopt {

// The options of one solver (ops/cuda_solver.k2_params builds it once per
// solver; the batch size arrives with each launch).  solver: enum Solver;
// cap: slots of each history row (max_iters_total, or 0 without history).
struct SolverParams {
  int d, n_res, family, fam_m, solver, coloring, max_iters_total,
      max_consec_failures, max_total_failures, cg_iters, use_quality,
      use_squared_norm, downscale_by_2, normalize;
  double min_error, min_rerr_dec, min_step_norm2, min_grad_norm2,
      damping_init, lam_lo, lam_hi, good_factor, bad_factor, grad_clipping;
  int cap;
};

// Device pointers: inputs, then every output field of one call, each
// written by the kernel (x and g are (B, d), the history rows errs,
// deltas2 and succ (B, cap), the rest (B,)).  cost, rerr, lam, errs and
// deltas2 have the solver's type; inlier and duration are float; succ is
// bool (one byte); the others int.
struct SolverIO {
  const void* x0;
  const void* data0;
  const void* data1;
  void *x, *cost, *rerr, *lam, *g, *stop, *iters, *nfail, *nconsec, *nres,
      *nhist, *inlier, *duration, *errs, *deltas2, *succ;
};

enum Solver { kSolverGN = 0, kSolverLM = 1, kSolverDogLeg = 2 };
enum Family { kPrior = 0, kJennrichSampson = 1 };
enum Coloring { kColorNone = 0, kColorIdentity = 1 };
enum Path { kPathWarp = 0, kPathSegment = 1 };
enum Stop {
  kSolverFailed = -3, kNanOrInf = -2, kNone = 0, kMinError = 1,
  kMinRelError = 2, kMinDeltaNorm = 3, kMinGradNorm = 4, kMaxIters = 5,
  kMaxNoDecr = 6, kMaxConsecNoDecr = 7
};

// Sums over a segment of S lanes (S a power of two, segments aligned to
// multiples of S), lane sl holding entries sl + k*S, k < E, S*E <= 64.
// They add in the order of solver_kernel's warp_dot, which the twin's
// reductions match bit for bit on an H100 (PERF.md): slot l < 32
// holds 0 + t_l + t_{l+32}, then xor butterflies over the 32 slots with
// offsets 16 down to 1.  lane_part takes the steps whose offset is at
// least S, which pair entries of one lane; seg_sum the others, shuffles
// inside the segment, after which every lane of the segment holds the
// bit-identical total (each pairwise add is commutative) and no value has
// crossed into another segment.
template <int S, int E, typename T>
__device__ __forceinline__ T lane_part(const T (&t)[E]) {
  constexpr int R = 32 / S;   // slots below 32 a lane holds
  static_assert(S * E <= 64, "a segment holds at most 64 entries");
  T u[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    u[k] = k < E ? T(0) + t[k] : T(0);
    if (k + R < E) u[k] = u[k] + t[k + R];
  }
#pragma unroll
  for (int off = 16; off >= S; off >>= 1) {
#pragma unroll
    for (int k = 0; k < off / S; ++k) u[k] = u[k] + u[k + off / S];
  }
  return u[0];
}

template <int S, typename T>
__device__ __forceinline__ T seg_sum(T v) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Whether the flag holds on every lane of the segment whose lanes are the
// set bits of `bits`.
__device__ __forceinline__ bool seg_all(bool f, unsigned bits) {
  return (__ballot_sync(kFullMask, !f) & bits) == 0;
}

// r = (x - y) * inv_std;  J p = p * inv_std;  J'q = q * inv_std.
template <typename T>
struct PriorFamily {
  const T* y;
  const T* inv_std;
  int d;
  // Entries of each vector a lane of solver_seg_kernel holds: light work
  // an entry, so few lanes an instance and more instances a warp (timed
  // fastest of S x E = 32 x 2, 16 x 4 and 8 x 8 at d = 50, PERF.md).
  static constexpr int kSegE = 4;

  // Shared-memory form (solver_kernel): lanes stride over the vectors.
  __device__ int n_res() const { return d; }
  __device__ void residual(int b, const T* x, T* r, int lane) const {
    const T* yb = y + (size_t)b * d;
    const T* sb = inv_std + (size_t)b * d;
    for (int i = lane; i < d; i += 32) r[i] = (x[i] - yb[i]) * sb[i];
  }
  __device__ void jvp(int b, const T* x, const T* p, T* out, int lane) const {
    const T* sb = inv_std + (size_t)b * d;
    for (int i = lane; i < d; i += 32) out[i] = p[i] * sb[i];
  }
  __device__ void vjp(int b, const T* x, const T* q, T* out, int lane) const {
    const T* sb = inv_std + (size_t)b * d;
    for (int i = lane; i < d; i += 32) out[i] = q[i] * sb[i];
  }

  // Register form (solver_seg_kernel): entry k of lane sl of a segment is
  // index sl + k*S.  y and inv_std of the instance are read once, when it
  // starts, and are 0 past d, so every vector stays 0 there.
  template <int S, int E>
  struct Lanes {
    T y[E], s[E];
    __device__ __forceinline__ void start(const PriorFamily& f, int b, int sl) {
      const T* yb = f.y + (size_t)b * f.d;
      const T* sb = f.inv_std + (size_t)b * f.d;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int i = sl + k * S;
        const int ic = i < f.d ? i : f.d - 1;   // loads from valid addresses
        const T yv = yb[ic], sv = sb[ic];
        y[k] = i < f.d ? yv : T(0);
        s[k] = i < f.d ? sv : T(0);
      }
    }
    __device__ __forceinline__ void residual(const T (&x)[E], T (&r)[E]) const {
#pragma unroll
      for (int k = 0; k < E; ++k) r[k] = (x[k] - y[k]) * s[k];
    }
    __device__ __forceinline__ void jvp(const T (&x)[E], const T (&p)[E],
                                        T (&out)[E]) const {
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = p[k] * s[k];
    }
    __device__ __forceinline__ void vjp(const T (&x)[E], const T (&q)[E],
                                        T (&out)[E]) const {
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = q[k] * s[k];
    }
  };
};

// Jennrich-Sampson, m residuals over x = (x1, x2), c = i + 1:
//   r_i = (2 + 2c) - (e^{c x1} + e^{c x2})
//   (J p)_i = -((c p1) e^{c x1} + (c p2) e^{c x2})
//   (J'q)_k = sum_i ((-q_i) e^{c x_k}) c
template <typename T>
struct JenSamFamily {
  int m;
  // Two exponentials an entry of every product: the entries spread over
  // more lanes (timed fastest of S x E = 16 x 1, 8 x 2 and 4 x 4 at m = 10,
  // PERF.md).
  static constexpr int kSegE = 2;

  __device__ int n_res() const { return m; }
  __device__ void residual(int b, const T* x, T* r, int lane) const {
    for (int i = lane; i < m; i += 32) {
      const T c = T(i + 1);
      r[i] = (T(2) + T(2) * c) - (exp(c * x[0]) + exp(c * x[1]));
    }
  }
  __device__ void jvp(int b, const T* x, const T* p, T* out, int lane) const {
    for (int i = lane; i < m; i += 32) {
      const T c = T(i + 1);
      out[i] = -((c * p[0]) * exp(c * x[0]) + (c * p[1]) * exp(c * x[1]));
    }
  }
  __device__ void vjp(int b, const T* x, const T* q, T* out, int lane) const {
    T s0 = 0, s1 = 0;
    for (int i = lane; i < m; i += 32) {
      const T c = T(i + 1);
      s0 += ((-q[i]) * exp(c * x[0])) * c;
      s1 += ((-q[i]) * exp(c * x[1])) * c;
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      out[0] = s0;
      out[1] = s1;
    }
  }

  // Register form: x1, x2 (and p1, p2) live on lanes 0 and 1 of the
  // segment (S >= 2) and reach the others by shuffles; the vjp is a
  // segment sum.  Entries past m (residuals) or 2 (tangents) are 0.
  template <int S, int E>
  struct Lanes {
    int m, sl;
    __device__ __forceinline__ void start(const JenSamFamily& f, int, int sl_) {
      m = f.m;
      sl = sl_;
    }
    __device__ __forceinline__ void residual(const T (&x)[E], T (&r)[E]) const {
      const T x1 = __shfl_sync(kFullMask, x[0], 0, S);
      const T x2 = __shfl_sync(kFullMask, x[0], 1, S);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int i = sl + k * S;
        const T c = T(i + 1);
        const T v = (T(2) + T(2) * c) - (exp(c * x1) + exp(c * x2));
        r[k] = i < m ? v : T(0);
      }
    }
    __device__ __forceinline__ void jvp(const T (&x)[E], const T (&p)[E],
                                        T (&out)[E]) const {
      const T x1 = __shfl_sync(kFullMask, x[0], 0, S);
      const T x2 = __shfl_sync(kFullMask, x[0], 1, S);
      const T p1 = __shfl_sync(kFullMask, p[0], 0, S);
      const T p2 = __shfl_sync(kFullMask, p[0], 1, S);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int i = sl + k * S;
        const T c = T(i + 1);
        const T v = -((c * p1) * exp(c * x1) + (c * p2) * exp(c * x2));
        out[k] = i < m ? v : T(0);
      }
    }
    __device__ __forceinline__ void vjp(const T (&x)[E], const T (&q)[E],
                                        T (&out)[E]) const {
      const T x1 = __shfl_sync(kFullMask, x[0], 0, S);
      const T x2 = __shfl_sync(kFullMask, x[0], 1, S);
      T t0[E], t1[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int i = sl + k * S;
        const T c = T(i + 1);
        const T v0 = ((-q[k]) * exp(c * x1)) * c;
        const T v1 = ((-q[k]) * exp(c * x2)) * c;
        t0[k] = i < m ? v0 : T(0);
        t1[k] = i < m ? v1 : T(0);
      }
      T s0 = lane_part<S, E>(t0), s1 = lane_part<S, E>(t1);
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1) {
        const T o0 = __shfl_xor_sync(kFullMask, s0, off);
        const T o1 = __shfl_xor_sync(kFullMask, s1, off);
        s0 += o0;
        s1 += o1;
      }
      out[0] = sl == 0 ? s0 : (sl == 1 ? s1 : T(0));
#pragma unroll
      for (int k = 1; k < E; ++k) out[k] = T(0);
    }
  };
};

template <typename T>
__device__ __forceinline__ T clampv(T v, T lo, T hi) {
  return fmin(fmax(v, lo), hi);
}

// max(v, c) and min(v, c) for a constant c, a NaN v kept: the twin's
// torch.clamp (fmax / fmin would return c).
template <typename T>
__device__ __forceinline__ T max_keep_nan(T v, T c) {
  return (v > c || v != v) ? v : c;
}
template <typename T>
__device__ __forceinline__ T min_keep_nan(T v, T c) {
  return (v < c || v != v) ? v : c;
}

// The dogleg step from its pieces (solvers/step.dogleg_core after the
// three solves, one instance): the scalars of
// the trust-region geometry, then a per-entry select of the Gauss-Newton
// step, the radius-clipped regularized step, the clipped gradient or the
// interpolation between the Cauchy point and the GN step.  Every sum is
// the caller's, in warp_dot's order; sqrt and division are IEEE.
template <typename T>
struct DogLegGeometry {
  bool use_gn, use_reg, use_bd;
  T alpha, reg_scale, bd_coef, tau;

  // gg = g'g, gHg = g'Hg, n_gn2 = |dx_gn|^2, n_sd2 = |dx_sd|^2,
  // n_reg2 = |dx_reg|^2 (dx_reg already the Cauchy point where !ok_reg),
  // qa0 = |dx_gn - dx_sd|^2, qb0 = dx_sd'(dx_gn - dx_sd).
  __device__ __forceinline__ void finish(bool gn_sane, bool ok_reg,
                                         bool pos_curv, T gg, T n_gn2,
                                         T n_sd2, T n_reg2, T qa0, T qb0,
                                         T lam) {
    const T tiny = tiny_v<T>();
    const bool sd_pos = pos_curv && n_sd2 > T(0);
    const T ref2 = gn_sane ? n_gn2 : (ok_reg ? n_reg2 : (sd_pos ? n_sd2 : gg));
    const T radius = sqrt(max_keep_nan(ref2, tiny)) / lam;
    const T rr = radius * radius;
    const T bd_len = sd_pos ? min_nan(radius, sqrt(n_sd2)) : radius;
    bd_coef = gg > T(0) ? -(bd_len / sqrt(max_keep_nan(gg, tiny))) : T(0);
    reg_scale = min_keep_nan(radius / sqrt(max_keep_nan(n_reg2, tiny)), T(1));
    const T qa = max_keep_nan(qa0, tiny);
    const T qb = T(2) * qb0;
    const T qc = n_sd2 - rr;
    const T disc = max_keep_nan(qb * qb - T(4) * qa * qc, T(0));
    tau = min_keep_nan(max_keep_nan((-qb + sqrt(disc)) / (T(2) * qa), T(0)),
                       T(1));
    use_gn = gn_sane && n_gn2 <= rr;
    use_reg = !gn_sane && ok_reg;
    use_bd = !use_gn && !use_reg && (n_sd2 >= rr || !pos_curv || !gn_sane);
  }

  // Entry of the step: dx_gn, g, dx_reg (unscaled) and the Cauchy point's
  // coefficient -alpha give the entry of dx.
  __device__ __forceinline__ T entry(T gn, T g, T reg) const {
    const T sd = (-alpha) * g;
    if (use_gn) return gn;
    if (use_reg) return reg_scale * reg;
    if (use_bd) return bd_coef * g;
    return sd + tau * (gn - sd);
  }

  // torch.minimum: NaN if either is NaN
  __device__ __forceinline__ static T min_nan(T a, T b) {
    return (a != a || a < b) ? a : b;
  }
};

// The segment kernels' launcher, one instantiation a type, solver kind
// and history (csrc/solver_seg*_f32.cu, csrc/solver_seg*_f64.cu).
template <typename T, bool kDogLeg, bool kHist>
int launch_segment(const SolverParams& p, const SolverIO& io, int B, int S,
                   int E, int warps, int grid, cudaStream_t stream);

#define K2_SEG_INSTANCE(spec, T, dl, hist)                                   \
  spec template int launch_segment<T, dl, hist>(                             \
      const SolverParams&, const SolverIO&, int, int, int, int, int,        \
      cudaStream_t);
#define K2_SEG_INSTANCES(spec, T)                                            \
  K2_SEG_INSTANCE(spec, T, false, false)                                     \
  K2_SEG_INSTANCE(spec, T, false, true)                                      \
  K2_SEG_INSTANCE(spec, T, true, false)                                      \
  K2_SEG_INSTANCE(spec, T, true, true)
K2_SEG_INSTANCES(extern, float)
K2_SEG_INSTANCES(extern, double)

}  // namespace tinyopt
