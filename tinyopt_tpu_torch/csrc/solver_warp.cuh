// K2's warp kernel: one warp per instance, its state in shared memory, for
// max(P, d, n_res) > 64 (csrc/solver_seg.cuh holds the register kernel for
// the widths below).  solver_kernel and launch_warp, included by
// csrc/solver_warp_f32.cu / solver_warp_f64.cu (the hand-written families'
// instances) and by csrc/solver_gen.cuh (a family generated from a traced
// residual, built into a library of its own).
//
// Layout: lanes stride over the d tangent entries and the n_res residual
// rows; dot products are __shfl_xor_sync butterflies, so every lane holds
// the same scalar state and all control flow is warp-uniform.  Each warp
// runs its own outer loop, which replaces the tile-level "any instance
// active" gates of the TPU kernel (the per-instance results are the same,
// pallas_solver.py:566-574).  Per-warp state: 2 P + 12 d + 2 n_res values
// of shared memory (14 d + 2 n_res when P = d: 77 KB at d = 600 in
// double), then a generated family's scratch (warp_stride); the dogleg
// keeps its GN and first regularized steps in two of them that the other
// solvers do not read during a proposal.  The dogleg and the history are
// branches on the parameters; the multi-color coloring is an instance of
// its own (kMulti).  What bounds it: latency, a chain of
// dependent warp reductions and shared-memory passes an iteration.
#pragma once

#include <type_traits>

#include "solver.cuh"

namespace tinyopt {

// Whether a family sums as torch sums the twin's rows (torch_row_sum): the
// generated families' kTorchRowSums.
template <typename Fam, typename = void>
struct TorchRowSums : std::false_type {};
template <typename Fam>
struct TorchRowSums<Fam, std::void_t<decltype(Fam::kTorchRowSums)>>
    : std::integral_constant<bool, Fam::kTorchRowSums> {};

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

// torch's CUDA geometry for the row sums of a contiguous (B, n) tensor, the
// twin's torch.sum(u * v, dim=-1) (ATen's Reduce.cuh setReduceConfig): from
// 128 values it reads the row as 4-vectors; a block is W threads along the
// row (W the largest power of two <= the row's 4-vectors or values, at
// most 512 / h, h = min(the largest power of two <= B, 512 / min(that, 32))
// rows a block), and Y = h warps split the row where that leaves at least
// min(16 h, 256) values a thread, else Y = 1.  At B >= 16 and n < 8,161, W
// is 32 (or fewer where the row is shorter, which adds as 32 lanes do) and
// Y is 1.
__host__ __device__ __forceinline__ int torch_last_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}
__host__ __device__ __forceinline__ void torch_row_geometry(int n, int B,
                                                           int& W, int& Y) {
  const int dim0 = n >= 128 ? n / 4 : n;
  const int p0 = dim0 < 512 ? torch_last_pow2(dim0) : 512;
  const int p1 = B < 512 ? torch_last_pow2(B) : 512;
  const int h = p1 < 512 / (p0 < 32 ? p0 : 32) ? p1 : 512 / (p0 < 32 ? p0 : 32);
  W = p0 < 512 / h ? p0 : 512 / h;
  const int per_thread = (n + W - 1) / W;
  Y = per_thread >= (16 * h < 256 ? 16 * h : 256) ? h : 1;
}

// Torch's thread (x, y) of a row sum in that geometry: from 128 values the
// row's first (4 - s) % 4 values on threads x = s..3 of y = 0, s = row * n %
// 4 (torch reads from a 16-byte (float) or 32-byte (double) boundary of the
// tensor, whose base it is), then vector x + y W, x + y W + W Y, ... into
// four sums a0..a3 (0 + ...), the last (n - (4 - s) % 4) % 4 values on
// threads 0, 1, 2 of y = 0 into a0, and ((a0 + a1) + a2) + a3; below 128
// values x, x + W, ... in turn.
template <typename T, typename F>
__device__ __forceinline__ T torch_thread_sum(F f, int n, int shift, int x,
                                              int y, int W, int Y) {
  if (n < 128) {
    T s = 0;
    for (int i = x; i < n; i += W) s += f(i);
    return s;
  }
  T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int base = 0, end = n;
  if (shift > 0) {
    if (y == 0 && x >= shift && x < 4) a0 = a0 + f(x - shift);
    base = 4 - shift;
    end = n - base;
  }
  for (int v = x + y * W; 4 * v + 3 < end; v += W * Y) {
    const int i = base + 4 * v;
    a0 = a0 + f(i);
    a1 = a1 + f(i + 1);
    a2 = a2 + f(i + 2);
    a3 = a3 + f(i + 3);
  }
  const int tail = end - end % 4 + x;
  if (y == 0 && tail < end) a0 = a0 + f(base + tail);
  return ((a0 + a1) + a2) + a3;
}

// The sum over i < n of f(i) in the order in which torch's CUDA sum adds
// row `row` of a contiguous (B, n) tensor, in its geometry (W, Y) =
// torch_row_geometry(n, B): each lane l plays threads x = l, l + 32, ...
// (< W) of each y (torch_thread_sum), their sums combined as torch's block
// does, x + W / 2, ..., x + 32 into x, then the butterfly, whose lane-0
// total is torch's shuffle-down tree, then the warps' y + Y / 2, ..., y + 1
// into y.  Every lane returns the total.
template <typename T, typename F>
__device__ __forceinline__ T torch_row_sum(F f, int n, size_t row, int W,
                                           int Y, int lane) {
  const int shift = n >= 128 ? (int)((row * (size_t)n) & 3) : 0;
  if (W <= 32 && Y == 1)
    return warp_sum(torch_thread_sum<T>(f, n, shift, lane, 0, 32, 1));
  T tot[16];
  for (int y = 0; y < Y; ++y) {
    T part[16];
    const int m = W / 32;
    for (int j = 0; j < m; ++j)
      part[j] = torch_thread_sum<T>(f, n, shift, lane + 32 * j, y, W, Y);
    for (int h = m / 2; h >= 1; h >>= 1)
      for (int j = 0; j < h; ++j) part[j] = part[j] + part[j + h];
    tot[y] = warp_sum(part[0]);
  }
  for (int h = Y / 2; h >= 1; h >>= 1)
    for (int y = 0; y < h; ++y) tot[y] = tot[y] + tot[y + h];
  return tot[0];
}

// A family's warp scratch: a family generated from a traced residual
// (GeneratedFamily, csrc/solver.cuh) keeps the arrays of its emitted warp
// functions in kScratch values of T a warp, after the warp's state rounded
// up to 4 values (so 16-byte aligned); a hand-written family has none.
template <typename Fam, typename = void>
struct HasWarpScratch : std::false_type {};
template <typename Fam>
struct HasWarpScratch<Fam, std::void_t<decltype(Fam::kScratch)>>
    : std::true_type {};

// Values of shared memory a warp holds for one instance: x and best_x (P
// each), twelve tangent vectors and two residual vectors, then a generated
// family's scratch (ops/cuda_solver.warp_values, warp_state_values).
template <typename Fam>
__host__ __device__ __forceinline__ int warp_stride(int P, int d, int nr) {
  const int v = 2 * P + 12 * d + 2 * nr;
  if constexpr (HasWarpScratch<Fam>::value)
    return ((v + 3) & ~3) + Fam::kScratch;
  else
    return v;
}

// The row sums of one warp's instance: a lane's partial sum (entries
// lane, lane + 32, ...) through the butterfly, warp_dot's order, or for a
// family with kTorchRowSums torch's order (torch_row_sum over f, after a
// sync: it reads other lanes' entries), in the geometry of a row of d or
// of n_res values at the launch's batch, worked out once.  Force-inlined
// members, so that a hand-written family's kernel is the code it was
// before the generated families shared it.
template <typename T, bool kTorch>
struct WarpSums {
  size_t row;
  int B, lane, d, nr, Wd = 32, Yd = 1, Wr = 32, Yr = 1;
  __device__ __forceinline__ WarpSums(size_t row_, int B_, int lane_, int d_,
                                      int nr_)
      : row(row_), B(B_), lane(lane_), d(d_), nr(nr_) {
    if constexpr (kTorch) {
      torch_row_geometry(d, B, Wd, Yd);
      torch_row_geometry(nr, B, Wr, Yr);
    }
  }
  template <typename F>
  __device__ __forceinline__ T fold(T part, F f, int n) const {
    if constexpr (kTorch) {
      int W = Wd, Y = Yd;
      if (n != d) {
        W = Wr;
        Y = Yr;
        if (n != nr) torch_row_geometry(n, B, W, Y);
      }
      __syncwarp();
      return torch_row_sum<T>(f, n, row, W, Y, lane);
    } else {
      return warp_sum(part);
    }
  }
  __device__ __forceinline__ T dot(const T* u, const T* v, int n) const {
    if constexpr (kTorch)
      return fold(T(0), [=](int i) { return u[i] * v[i]; }, n);
    else
      return warp_dot(u, v, n, lane);
  }
};

// K2's warp kernel, one warp an instance; kMulti: the multi-color
// coloring's instance, diag(J'J) from the probes and the recovery (ct, in
// device memory; null tables for the other instances), the closed-form step
// when one color.  A family with kTorchRowSums (the generated ones, held to
// their twin bit for bit) sums as torch sums the twin's rows
// (torch_row_sum); the hand-written families keep warp_dot's order.
template <typename T, typename Fam, bool kMulti>
__global__ void solver_kernel(const SolverParams p, const SolverIO io,
                              const Fam fam, int B, int warps_per_block,
                              int ws_stride, const ColorTables ct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kTorch = TorchRowSums<Fam>::value;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * warps_per_block + w;
  if (b >= B) return;         // whole warp: b is warp-uniform

  const int d = p.d;
  const int P = param_width<Fam>(d);   // values of x
  const int nr = p.n_res;
  // x is the first value of the warp's region: a generated family finds
  // its scratch from it (GeneratedFamily::scratch)
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

  const WarpSums<T, kTorch> sums((size_t)b, B, lane, d, nr);

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
    if (p.coloring == kColorIdentity || (kMulti && p.n_colors == 1)) {
      // One color: H = J'J is exactly diagonal, the damped system solves
      // in closed form (the JAX kernel's n_colors == 1 branch).
      for (int i = lane; i < d; i += 32) dxn[i] = (-g[i]) * dinv[i];
      __syncwarp();
      return warp_all_finite(dxn, d, lane);
    }
    // Jacobi-PCG, ops/linalg.pcg_core formulas.
    auto rz_of = [=](int i) { return cr[i] * cz[i]; };
    T part = 0;
    for (int i = lane; i < d; i += 32) {
      dxn[i] = 0;
      cr[i] = -g[i];
      cz[i] = cr[i] * dinv[i];
      cp[i] = cz[i];
      part += cr[i] * cz[i];
    }
    T rz = sums.fold(part, rz_of, d);
    __syncwarp();
    for (int k = 0; k < p.cg_iters; ++k) {
      matvec(cp, chp);
      const T denom = sums.dot(cp, chp, d);
      const T alpha = denom > tiny ? rz / denom : T(0);
      part = 0;
      for (int i = lane; i < d; i += 32) {
        dxn[i] = dxn[i] + alpha * cp[i];
        cr[i] = cr[i] - alpha * chp[i];
        cz[i] = cr[i] * dinv[i];
        part += cr[i] * cz[i];
      }
      const T rz_new = sums.fold(part, rz_of, d);
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
    const T gg = sums.dot(g, g, d);
    const T gHg = sums.dot(g, chp, d);
    const bool pos_curv = gHg > T(0);
    DogLegGeometry<T> geo;
    geo.alpha = pos_curv ? gg / gHg : T(0);
    // the steepest-descent step's entry sd_of(i), and torch's sums (the
    // lanes' partials pa, pb, pc accumulate the same terms)
    const T alpha = geo.alpha;
    auto sd_of = [=](int i) { return (-alpha) * g[i]; };
    T pa = 0, pb = 0;
    for (int i = lane; i < d; i += 32) {
      const T sd = (-geo.alpha) * g[i];
      pa += dgn[i] * dgn[i];
      pb += sd * sd;
    }
    const T n_gn2 = sums.fold(pa, [=](int i) { return dgn[i] * dgn[i]; },
                              d);
    const T n_sd2 = sums.fold(pb, [=](int i) {
      const T sd = sd_of(i);
      return sd * sd;
    }, d);
    const bool gn_sane = ok_gn && (!(n_sd2 > T(0)) || n_gn2 <= kappa2 * n_sd2);
    bool ok_r1 = false, ok_r2 = false;
    if (!gn_sane) {
      ok_r1 = solve(true, lam_try);
      for (int i = lane; i < d; i += 32) tv[i] = dxn[i];
    } else {
      for (int i = lane; i < d; i += 32) tv[i] = T(0);
    }
    __syncwarp();
    const T n_r1 = sums.dot(tv, tv, d);
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
    const T n_reg2 = sums.fold(pa, [=](int i) { return tv[i] * tv[i]; }, d);
    const T qa0 = sums.fold(pb, [=](int i) {
      const T dv = dgn[i] - sd_of(i);
      return dv * dv;
    }, d);
    const T qb0 = sums.fold(pc, [=](int i) {
      const T sd = sd_of(i);
      return sd * (dgn[i] - sd);
    }, d);
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
    } else if constexpr (kMulti) {
      // Curtis-Powell-Reid: a jvp of each color's probe row, then diag_j =
      // sum over the recovery's rows (c, i), in ascending order, of
      // (J probe_c)_i^2 * recovery[c * n_res + i][j], the twin's sum and the
      // register kernel's; lanes stride over j, the tables read from device
      // memory through the read-only cache (at d = n_res = 128 and two colors
      // they are 132 KB in float32: past a block's shared memory beside the
      // warps' state).
      const T* probes = static_cast<const T*>(ct.probes);
      const T* rec = static_cast<const T*>(ct.recovery);
      for (int i = lane; i < d; i += 32) diagH[i] = T(0);
      for (int c = 0; c < p.n_colors; ++c) {
        for (int i = lane; i < d; i += 32) tv[i] = __ldg(probes + (size_t)c * d + i);
        __syncwarp();
        fam.jvp(b, x, tv, jp, lane);
        __syncwarp();
        for (int i = 0; i < nr; ++i) {
          const T sq = jp[i] * jp[i];
          const T* row = rec + ((size_t)c * nr + i) * d;
          for (int j = lane; j < d; j += 32)
            diagH[j] = diagH[j] + sq * __ldg(row + j);
        }
        __syncwarp();
      }
    } else {
      for (int j = 0; j < d; ++j) {
        for (int i = lane; i < d; i += 32) tv[i] = i == j ? T(1) : T(0);
        __syncwarp();
        fam.jvp(b, x, tv, jp, lane);
        __syncwarp();
        const T dj = sums.dot(jp, jp, nr);
        if (lane == 0) diagH[j] = dj;
        __syncwarp();
      }
    }
    T err = sums.dot(r, r, nr);
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
    const T dx_norm2 = sums.dot(dx, dx, d);
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
    const T gn2 = sums.dot(g, g, d);
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
      // every lane the same, then entry i written by lane i % 32 (xn
      // indexed by the loop's counter alone, so that it may stay in
      // registers; up to 32 entries the test is lane == i)
      T xb[Fam::kP], dd[Fam::kD], xn[Fam::kP];
      for (int i = 0; i < Fam::kP; ++i) xb[i] = roll ? best_x[i] : x[i];
      for (int i = 0; i < Fam::kD; ++i) dd[i] = apply ? dx[i] : T(0);
      fam.retract(xb, dd, xn);
      __syncwarp();
      for (int i = 0; i < Fam::kP; ++i) {
        if (Fam::kP <= 32 ? lane == i : (i & 31) == lane) {
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

// One warp per instance, `warps` a block, smem = warps * warp_stride values
// (ops/cuda_solver.k2_launch_plan: warp_values, and warp_state_values plus
// the scratch for a generated family); kMulti: the multi-color instance,
// which reads the coloring's tables.
template <typename T, typename Fam, bool kMulti>
int launch_warp(const SolverParams& p, const SolverIO& io, const Fam& fam,
                const ColorTables& tables, int B, int warps, int grid,
                int smem, cudaStream_t stream) {
  const int ws_stride = warp_stride<Fam>(param_width<Fam>(p.d), p.d, p.n_res);
  const long long need = (long long)warps * ws_stride * sizeof(T);
  if (warps < 1 || warps > 32 || smem < need || (size_t)smem > kMaxSmem ||
      (long long)grid * warps < B ||
      (kMulti && (p.n_colors < 1 || tables.probes == nullptr ||
                  tables.recovery == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto kern = solver_kernel<T, Fam, kMulti>;
  int fit = 0;
  cudaError_t e = device_fit(reinterpret_cast<const void*>(kern), warps * 32,
                             smem, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  kern<<<grid, 32 * warps, smem, stream>>>(p, io, fam, B, warps, ws_stride,
                                           tables);
  return (int)cudaGetLastError();
}

// The warp kernel's instance for the coloring: the multi-color one for the
// multi-color coloring, the other for the others.
template <typename T, typename Fam>
int launch_warp_family(const SolverParams& p, const SolverIO& io,
                       const Fam& fam, const ColorTables& tables, int B,
                       int warps, int grid, int smem, cudaStream_t s) {
  if (p.coloring == kColorMulti)
    return launch_warp<T, Fam, true>(p, io, fam, tables, B, warps, grid, smem, s);
  return launch_warp<T, Fam, false>(p, io, fam, tables, B, warps, grid, smem, s);
}

// The hand-written families on the warp kernel (csrc/solver.cu's kPathWarp),
// instantiated once a type in csrc/solver_warp_f32.cu / solver_warp_f64.cu.
template <typename T>
int launch_warp_hand(const SolverParams& p, const SolverIO& io,
                     const ColorTables& tables, int B, int warps, int grid,
                     int smem, cudaStream_t s) {
  if (p.family == kPrior) {
    PriorFamily<T> fam{static_cast<const T*>(io.data0),
                       static_cast<const T*>(io.data1), p.d};
    return launch_warp_family<T>(p, io, fam, tables, B, warps, grid, smem, s);
  }
  if (p.family == kJennrichSampson) {
    JenSamFamily<T> fam{p.fam_m};
    return launch_warp_family<T>(p, io, fam, tables, B, warps, grid, smem, s);
  }
  if (p.family == kSE3) {
    SE3Family<T> fam{static_cast<const T*>(io.data0),
                     static_cast<const T*>(io.data1), p.fam_m};
    // no coloring (csrc/solver.cu checks): no multi-color instance
    return launch_warp<T, SE3Family<T>, false>(p, io, fam, tables, B, warps,
                                               grid, smem, s);
  }
  // PowellFamily and WoodFamily have the register form only: their fixed
  // shapes always take the register kernel.
  return (int)cudaErrorInvalidValue;
}

}  // namespace tinyopt
