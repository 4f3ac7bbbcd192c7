// K2's parameters, outputs and residual families, shared by its kernels:
// solver_kernel (csrc/solver_warp.cuh, state in shared memory, any d),
// solver_seg_kernel (csrc/solver_seg.cuh, state in registers, max(d, n_res)
// <= 64) and the SE3 family's solver_se3_kernel (csrc/solver_se3.cuh, up to
// 21 points).  A family's kManifold says whether its
// parameters are Euclidean (x and the tangent both d wide, x + dx) or a
// manifold with kP stored values, a tangent of kD and a retraction of its
// own (the SE3 family: 7 and 6).
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
  int cap, n_colors;
};

// The multi-color coloring's constants (kColorMulti), device arrays of the
// solver's type built once a solver (ops/cuda_solver.color_tables):
// probes (n_colors, d), row c the tangent of color c, and recovery
// (n_colors * n_res, d), diag(H)_j = sum over rows (c, i), ascending, of
// (J probe_c)_i^2 * recovery[c * n_res + i][j].
struct ColorTables {
  const void* probes;
  const void* recovery;
};

// Device pointers: inputs, then every output field of one call, each
// written by the kernel (x is (B, P), g (B, d), the history rows errs,
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
// kGenerated: a family generated from a traced residual
// (ops/residual_codegen.py), built into a library of its own (_build.py).
enum Family {
  kPrior = 0, kJennrichSampson = 1, kSE3 = 2, kPowell = 3, kWood = 4,
  kGenerated = 5
};
// kColorNone: one jvp a tangent dimension for diag(H), then Jacobi-PCG;
// kColorIdentity: J diagonal, one jvp of the all-ones probe and the
// closed-form step; kColorMulti: Curtis-Powell-Reid probes, one jvp a
// color and the recovery sum (ColorTables), closed form when one color.
enum Coloring { kColorNone = 0, kColorIdentity = 1, kColorMulti = 2 };
enum Path { kPathWarp = 0, kPathSegment = 1 };
enum Stop {
  kSolverFailed = -3, kNanOrInf = -2, kNone = 0, kMinError = 1,
  kMinRelError = 2, kMinDeltaNorm = 3, kMinGradNorm = 4, kMaxIters = 5,
  kMaxNoDecr = 6, kMaxConsecNoDecr = 7
};

// Sums over a segment of S lanes (S a power of two, segments aligned to
// multiples of S), lane sl holding entries sl + k*S, k < E.  Where
// S*E <= 64 they add in the order of solver_kernel's warp_dot, which the
// twin's reductions match bit for bit on an H100 (PERF.md): slot l < 32
// holds 0 + t_l + t_{l+32}, then xor butterflies over the 32 slots with
// offsets 16 down to 1.  (A segment of more entries, the SE3 family's
// 32 x 3, adds each further entry into its slot after those two.)
// lane_part takes the steps whose offset is at least S, which pair entries
// of one lane; seg_sum the others, shuffles inside the segment, after
// which every lane of the segment holds the bit-identical total (each
// pairwise add is commutative) and no value has crossed into another
// segment.  On one lane (S = 1) lane_part is the whole tree, and it leaves
// out the steps whose partner slot lies past E: they add +0 to a slot that
// began as 0 + t and so is never -0, which changes no bit.
template <int S, int E, typename T>
__device__ __forceinline__ T lane_part(const T (&t)[E]) {
  constexpr int R = 32 / S;   // slots below 32 a lane holds
  T u[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    u[k] = k < E ? T(0) + t[k] : T(0);
#pragma unroll
    for (int j = k + R; j < E; j += R) u[k] = u[k] + t[j];
  }
  if constexpr (S == 1) {
    int live = E;   // slots that may hold a value other than +0
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
      for (int k = 0; k < off; ++k)
        if (k + off < live) u[k] = u[k] + u[k + off];
      live = live < off ? live : off;
    }
  } else {
#pragma unroll
    for (int off = 16; off >= S; off >>= 1) {
#pragma unroll
      for (int k = 0; k < off / S; ++k) u[k] = u[k] + u[k + off / S];
    }
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
// set bits of `bits` (on one lane, the lane's own flag).
template <int S>
__device__ __forceinline__ bool seg_all(bool f, unsigned bits) {
  if constexpr (S == 1)
    return f;
  else
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
  static constexpr int kMaxM = 64;
  static constexpr bool kManifold = false;

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
  static constexpr int kMaxM = 64;
  static constexpr bool kManifold = false;

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

// Powell's singular function (models/problems.powell_singular_residuals),
// 4 parameters and 4 residuals:
//   r = (x1 + 10 x2, s5 (x3 - x4), u^2, s10 w^2),  u = x2 - 2 x3, w = x1 - x4
// with s5 = sqrt(5), s10 = sqrt(10) rounded to T.  The jvp and vjp are the
// closed forms of the polynomials, each product and sum in the order
// torch.func's rules take them (the twin's; every gradient entry is a sum
// of two terms), so on the same x they equal the twin's bit for bit.
template <typename T>
struct PowellFamily {
  // One instance a thread (solver_seg_kernel at S = 1, 32 instances a
  // warp): the lane holds all 4 entries of every vector, and the fixed
  // shape (kD, kNRes) is known to the compiler.
  static constexpr int kD = 4, kNRes = 4;
  static constexpr int kSegE = 4;
  static constexpr int kMaxM = 4;
  static constexpr bool kManifold = false;

  __device__ static void rows(const T* x, T* r) {
    const T s5 = T(2.23606797749979), s10 = T(3.1622776601683795);
    const T u = x[1] - T(2) * x[2], w = x[0] - x[3];
    r[0] = x[0] + T(10) * x[1];
    r[1] = s5 * (x[2] - x[3]);
    r[2] = u * u;
    r[3] = s10 * (w * w);
  }
  __device__ static void jvp_rows(const T* x, const T* p, T* o) {
    const T s5 = T(2.23606797749979), s10 = T(3.1622776601683795);
    const T u = x[1] - T(2) * x[2], w = x[0] - x[3];
    o[0] = p[0] + p[1] * T(10);
    o[1] = (p[2] - p[3]) * s5;
    o[2] = (p[1] - p[2] * T(2)) * (T(2) * u);
    o[3] = ((p[0] - p[3]) * (T(2) * w)) * s10;
  }
  __device__ static void vjp_rows(const T* x, const T* q, T* o) {
    const T s5 = T(2.23606797749979), s10 = T(3.1622776601683795);
    const T u = x[1] - T(2) * x[2], w = x[0] - x[3];
    const T a1 = q[1] * s5, a2 = q[2] * (T(2) * u), a3 = (q[3] * s10) * (T(2) * w);
    o[0] = q[0] + a3;
    o[1] = q[0] * T(10) + a2;
    o[2] = a1 + (-a2) * T(2);
    o[3] = (-a1) + (-a3);
  }

  // Register form only (the fixed shape never takes solver_kernel), one
  // instance a lane: x and every vector are the lane's own registers.
  template <int S, int E>
  struct Lanes {
    static_assert(S == 1 && E == kSegE, "one instance a lane");
    __device__ __forceinline__ void start(const PowellFamily&, int, int) {}
    __device__ __forceinline__ void residual(const T (&x)[E], T (&r)[E]) const {
      rows(x, r);
    }
    __device__ __forceinline__ void jvp(const T (&x)[E], const T (&p)[E],
                                        T (&out)[E]) const {
      jvp_rows(x, p, out);
    }
    __device__ __forceinline__ void vjp(const T (&x)[E], const T (&q)[E],
                                        T (&out)[E]) const {
      vjp_rows(x, q, out);
    }
  };
};

// Wood's function as 6 residuals (models/problems.wood_residuals), 4
// parameters:
//   r = (10 (x2 - x1^2), 1 - x1, s90 (x4 - x3^2), 1 - x3,
//        s10 ((x2 + x4) - 2), (x2 - x4) / s10)
// Closed-form jvp and vjp in torch.func's order, as PowellFamily; three
// gradient entries are sums of three terms, added as torch's autograd
// accumulates them: ((-q1) + a) + a for x1, (b4 + b5) + b0 for x2.  A
// division by s10 is a product with T(1) / s10, as torch's CUDA kernels
// divide by a scalar (on the CPU torch divides: the twin there differs in
// the last bit of r5 and its products).
template <typename T>
struct WoodFamily {
  // One instance a thread, as PowellFamily: the lane's 6 entries hold the 6
  // residuals; tangent entries 4 and 5 are 0.
  static constexpr int kD = 4, kNRes = 6;
  static constexpr int kSegE = 6;
  static constexpr int kMaxM = 6;
  static constexpr bool kManifold = false;

  __device__ static void rows(const T* x, T* r) {
    const T s90 = T(9.486832980505138), s10 = T(3.1622776601683795);
    r[0] = T(10) * (x[1] - x[0] * x[0]);
    r[1] = T(1) - x[0];
    r[2] = s90 * (x[3] - x[2] * x[2]);
    r[3] = T(1) - x[2];
    r[4] = s10 * ((x[1] + x[3]) - T(2));
    r[5] = (x[1] - x[3]) * (T(1) / s10);
  }
  __device__ static void jvp_rows(const T* x, const T* p, T* o) {
    const T s90 = T(9.486832980505138), s10 = T(3.1622776601683795);
    o[0] = (p[1] - T(2) * (p[0] * x[0])) * T(10);
    o[1] = -p[0];
    o[2] = (p[3] - T(2) * (p[2] * x[2])) * s90;
    o[3] = -p[2];
    o[4] = (p[1] + p[3]) * s10;
    o[5] = (p[1] - p[3]) * (T(1) / s10);
  }
  __device__ static void vjp_rows(const T* x, const T* q, T* o) {
    const T s90 = T(9.486832980505138), s10 = T(3.1622776601683795);
    const T b0 = q[0] * T(10), b2 = q[2] * s90, b4 = q[4] * s10,
            b5 = q[5] * (T(1) / s10);
    const T a1 = (-b0) * x[0], a3 = (-b2) * x[2];
    o[0] = ((-q[1]) + a1) + a1;
    o[1] = (b4 + b5) + b0;
    o[2] = ((-q[3]) + a3) + a3;
    o[3] = (b4 + (-b5)) + b2;
  }

  // Register form only, one instance a lane, as PowellFamily: the
  // residuals fill the lane's 6 entries, tangent entries 4 and 5 stay 0.
  template <int S, int E>
  struct Lanes {
    static_assert(S == 1 && E == kSegE, "one instance a lane");
    __device__ __forceinline__ void start(const WoodFamily&, int, int) {}
    __device__ __forceinline__ void residual(const T (&x)[E], T (&r)[E]) const {
      rows(x, r);
    }
    __device__ __forceinline__ void jvp(const T (&x)[E], const T (&p)[E],
                                        T (&out)[E]) const {
      jvp_rows(x, p, out);
    }
    __device__ __forceinline__ void vjp(const T (&x)[E], const T (&q)[E],
                                        T (&out)[E]) const {
      vjp_rows(x, q, out);
      out[4] = out[5] = T(0);
    }
  };
};

// A family generated from a traced residual (ops/residual_codegen.py):
// Gen is the emitted struct (the header k2gen_<hash>.cuh, built with
// csrc/solver_gen.cuh into a library of its own), whose kP, kD, kNRes and
// kQ are the widths of the flat parameters, of the tangent and of the
// residual and the values of an instance's data row, kManifold whether
// the parameters hold a manifold leaf (kP > kD then), and whose rows /
// jvp_rows / vjp_rows / retract_rows are the residual, the jvp and the vjp
// of d -> r(x (+) d) at 0, and the retraction x (+) dx, of one instance,
// traced from torch.func and manifold.retract_flat.  Two forms, as the
// header holds them (Gen::kWarp):
// * the register form (Lanes), max(P, D, n_res) <= 64: one instance a
//   thread (S = 1) as PowellFamily, with the parameters, the tangent-wide
//   and the residual-wide vectors sized apart (kSplitWidths,
//   csrc/solver_seg.cuh);
// * the warp form (residual / jvp / vjp below), past 64: solver_kernel's
//   one instance a warp (csrc/solver_warp.cuh), the emitted warp_rows,
//   warp_jvp_rows and warp_vjp_rows each op a lane-strided loop over its
//   entries and a __syncwarp, their arrays in kScratch values of T a warp
//   after the warp's state; the retraction is retract_rows in every lane.
// The data row is read through the cache where the emitted code reads it,
// never held in registers.  Its sums are torch's (kTorchRowSums): the
// kernel is held to its twin bit for bit.
template <typename T, typename Gen>
struct GeneratedFamily {
  const T* data;   // (B, kQ), or null when kQ == 0
  static constexpr int kP = Gen::kP, kD = Gen::kD, kNRes = Gen::kNRes;
  static constexpr int kPD = kP > kD ? kP : kD;
  static constexpr int kSegE = kPD > kNRes ? kPD : kNRes;
  static constexpr int kMaxM = kSegE;
  static constexpr bool kManifold = Gen::kManifold;
  static constexpr bool kSplitWidths = true;
  static constexpr int kScratch = Gen::kScratch;
  static constexpr bool kTorchRowSums = true;
  static_assert(kManifold ? kP > kD : kP == kD,
                "P > D on manifold parameters, P = D on Euclidean ones");

  // Warp form (solver_kernel): lanes stride over each op's entries.  x is
  // the first value of the warp's region in shared memory, whose state
  // (2 kP + 12 kD + 2 kNRes values, rounded up to 4) the scratch follows
  // (warp_stride, csrc/solver_warp.cuh).
  __device__ __forceinline__ const T* row(int b) const {
    return Gen::kQ > 0 ? data + (size_t)b * Gen::kQ : nullptr;
  }
  __device__ __forceinline__ static unsigned char* scratch(const T* x) {
    constexpr int state = (2 * kP + 12 * kD + 2 * kNRes + 3) & ~3;
    return reinterpret_cast<unsigned char*>(const_cast<T*>(x) + state);
  }
  __device__ void residual(int b, const T* x, T* r, int lane) const {
    Gen::template warp_rows<T>(x, row(b), r, scratch(x), lane);
  }
  __device__ void jvp(int b, const T* x, const T* p, T* out, int lane) const {
    Gen::template warp_jvp_rows<T>(x, row(b), p, out, scratch(x), lane);
  }
  __device__ void vjp(int b, const T* x, const T* q, T* out, int lane) const {
    Gen::template warp_vjp_rows<T>(x, row(b), q, out, scratch(x), lane);
  }
  // xn = x (+) dx, every lane the same (kManifold only)
  __device__ void retract(const T* x, const T* dx, T* xn) const {
    Gen::template retract_rows<T>(x, dx, xn);
  }

  template <int S, int E>
  struct Lanes {
    static_assert(S == 1 && E == kSegE, "one instance a lane");
    const T* row;
    __device__ __forceinline__ void start(const GeneratedFamily& f, int b, int) {
      row = Gen::kQ > 0 ? f.data + (size_t)b * Gen::kQ : nullptr;
    }
    __device__ __forceinline__ void residual(const T (&x)[kP],
                                             T (&r)[kNRes]) const {
      Gen::template rows<T>(x, row, r);
    }
    __device__ __forceinline__ void jvp(const T (&x)[kP], const T (&p)[kD],
                                        T (&out)[kNRes]) const {
      Gen::template jvp_rows<T>(x, row, p, out);
    }
    __device__ __forceinline__ void vjp(const T (&x)[kP], const T (&q)[kNRes],
                                        T (&out)[kD]) const {
      Gen::template vjp_rows<T>(x, row, q, out);
    }
    // xn = x (+) dx (kManifold only; a Euclidean family adds)
    __device__ __forceinline__ void retract(const T (&x)[kP], const T (&dx)[kD],
                                            T (&xn)[kP]) const {
      Gen::template retract_rows<T>(x, dx, xn);
    }
  };
};

// SE(3) arithmetic of the SE3 family, in the op order of the port's
// manifolds/so3.py and se3.py (each product and sum rounded as torch's
// elementwise ops round it; sums of three as ((a + b) + c)).
template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// SO3.apply: t = 2 (qv x p); p + qw t + qv x t
template <typename T>
__device__ __forceinline__ void quat_apply(const T* q, const T* p, T* out) {
  T c[3], t[3], c2[3];
  cross3(q + 1, p, c);
#pragma unroll
  for (int j = 0; j < 3; ++j) t[j] = T(2) * c[j];
  cross3(q + 1, t, c2);
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = (p[j] + q[0] * t[j]) + c2[j];
}

// so3._qmul
template <typename T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// R(q) as SO3.matrix builds it, row-major: the same linear map as
// quat_apply, which the tangent products apply
template <typename T>
__device__ __forceinline__ void quat_matrix(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = T(1) - T(2) * (y * y + z * z);
  R[1] = T(2) * (x * y - w * z);
  R[2] = T(2) * (x * z + w * y);
  R[3] = T(2) * (x * y + w * z);
  R[4] = T(1) - T(2) * (x * x + z * z);
  R[5] = T(2) * (y * z - w * x);
  R[6] = T(2) * (x * z - w * y);
  R[7] = T(2) * (y * z + w * x);
  R[8] = T(1) - T(2) * (x * x + y * y);
}

// The retraction T (+) d = T exp(d), d = (rho, omega) (se3._se3_retract):
// q <- q (x) exp_q(omega), t <- R(q) V(omega) rho + t, with so3._exp_quat's
// and se23._V_apply's Taylor branches where theta^2 < sqrt(eps) (the
// dtype-aware so3._small); the quaternion is not renormalized.
template <typename T>
__device__ __forceinline__ void se3_retract(const T* q, const T* t,
                                            const T* d, T* qn, T* tn) {
  const T* rho = d;
  const T* om = d + 3;
  const T theta2 = (om[0] * om[0] + om[1] * om[1]) + om[2] * om[2];
  const bool small = theta2 < T(sqrt((double)eps_v<T>()));
  const T th = sqrt(small ? T(1) : theta2);
  const T half = T(0.5) * th;
  const T k = small ? T(0.5) - theta2 / T(48) : sin(half) / th;
  const T qd[4] = {small ? T(1) - theta2 / T(8) : cos(half), k * om[0],
                   k * om[1], k * om[2]};
  const T a = small ? T(0.5) - theta2 / T(24)
                    : (T(1) - cos(th)) / (small ? T(1) : theta2);
  const T bv = small ? T(1.0 / 6.0) - theta2 / T(120)
                     : (th - sin(th)) / (small ? T(1) : theta2 * th);
  T wx[3], wwx[3], v[3], rv[3];
  cross3(om, rho, wx);
  cross3(om, wx, wwx);
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = (rho[j] + a * wx[j]) + bv * wwx[j];
  quat_mul(q, qd, qn);
  quat_apply(q, v, rv);
#pragma unroll
  for (int j = 0; j < 3; ++j) tn[j] = rv[j] + t[j];
}

// SE(3) pose refinement (models/se3_refinement.se3_residual), K points:
// x = (q, t), q = wxyz (P = 7), tangent d = (rho, omega) (D = 6),
//   r_k = R(q) p_k + t - qhat_k   (3 residuals a point, n_res = 3K)
//   (J v)_k = R (rho + omega x p_k)        the jvp of d -> r(x (+) d) at 0
//   J'u = (sum_k w_k, sum_k p_k x w_k),  w_k = R' u_k
// and the retraction se3_retract.  The kernels are not bit-equal to the
// twin here (it differentiates the quaternion formulas with torch.func;
// these are the closed forms of the same maps): PERF.md states the
// tolerances they are held to.  The register kernel of the family,
// solver_se3_kernel, reads points, targets and K and runs its own
// products (csrc/solver_se3.cuh).
template <typename T>
struct SE3Family {
  const T* points;    // (B, K, 3)
  const T* targets;   // (B, K, 3)
  int K;
  static constexpr bool kManifold = true;
  static constexpr int kP = 7, kD = 6;

  // Shared-memory form (solver_kernel): lanes stride over the points; x
  // and the tangent vectors are read from shared memory.
  __device__ int n_res() const { return 3 * K; }
  __device__ void residual(int b, const T* x, T* r, int lane) const {
    for (int j = lane; j < K; j += 32) {
      const size_t o = ((size_t)b * K + j) * 3;
      T a[3];
      quat_apply(x, points + o, a);
#pragma unroll
      for (int c = 0; c < 3; ++c) r[3 * j + c] = (a[c] + x[4 + c]) - targets[o + c];
    }
  }
  __device__ void jvp(int b, const T* x, const T* v, T* out, int lane) const {
    T R[9];
    quat_matrix(x, R);
    for (int j = lane; j < K; j += 32) {
      const T* p = points + ((size_t)b * K + j) * 3;
      T u[3];
      cross3(v + 3, p, u);
#pragma unroll
      for (int c = 0; c < 3; ++c) u[c] = v[c] + u[c];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[3 * j + c] = (R[3 * c] * u[0] + R[3 * c + 1] * u[1]) + R[3 * c + 2] * u[2];
    }
  }
  __device__ void vjp(int b, const T* x, const T* q, T* out, int lane) const {
    T R[9], s[6] = {0, 0, 0, 0, 0, 0};
    quat_matrix(x, R);
    for (int j = lane; j < K; j += 32) {
      const T* p = points + ((size_t)b * K + j) * 3;
      const T* u = q + 3 * j;
      T w[3], pw[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) w[c] = (R[c] * u[0] + R[3 + c] * u[1]) + R[6 + c] * u[2];
      cross3(p, w, pw);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[c] += w[c];
        s[3 + c] += pw[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c] = warp_sum(s[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) out[c] = s[c];
    }
  }
  // xn = x (+) d, every lane the same (x: 7 values, d: 6)
  __device__ void retract(const T* x, const T* d, T* xn) const {
    se3_retract(x, x + 4, d, xn, xn + 4);
  }
};

// Values of the flat parameters x of an instance: d for a Euclidean family,
// Fam::kP for a manifold one.
template <typename Fam>
__host__ __device__ __forceinline__ int param_width(int d) {
  if constexpr (Fam::kManifold)
    return Fam::kP;
  else
    return d;
}

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
int launch_segment(const SolverParams& p, const SolverIO& io,
                   const ColorTables& tables, int B, int S, int E, int warps,
                   int grid, cudaStream_t stream);

// The warp kernel's launcher for the hand-written families
// (csrc/solver_warp.cuh), one instantiation a type (csrc/solver_warp_f32.cu,
// csrc/solver_warp_f64.cu), so that nvcc builds the two beside each other.
template <typename T>
int launch_warp_hand(const SolverParams& p, const SolverIO& io,
                     const ColorTables& tables, int B, int warps, int grid,
                     int smem, cudaStream_t stream);
extern template int launch_warp_hand<float>(
    const SolverParams&, const SolverIO&, const ColorTables&, int, int, int,
    int, cudaStream_t);
extern template int launch_warp_hand<double>(
    const SolverParams&, const SolverIO&, const ColorTables&, int, int, int,
    int, cudaStream_t);

#define K2_SEG_INSTANCE(spec, T, dl, hist)                                   \
  spec template int launch_segment<T, dl, hist>(                             \
      const SolverParams&, const SolverIO&, const ColorTables&, int, int,    \
      int, int, int, cudaStream_t);
#define K2_SEG_INSTANCES(spec, T)                                            \
  K2_SEG_INSTANCE(spec, T, false, false)                                     \
  K2_SEG_INSTANCE(spec, T, false, true)                                      \
  K2_SEG_INSTANCE(spec, T, true, false)                                      \
  K2_SEG_INSTANCE(spec, T, true, true)
K2_SEG_INSTANCES(extern, float)
K2_SEG_INSTANCES(extern, double)

}  // namespace tinyopt
