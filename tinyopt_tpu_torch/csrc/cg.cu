// K1: batched Jacobi-preconditioned conjugate gradients, H_b x_b = b_b.
//
// Replaces the TPU kernel tinyopt_tpu/ops/pallas_cg.py::_cg_kernel (body
// pcg_on_values, launched by batched_cg_tpu).  It computes what
// ops/linalg.pcg_core computes, with the same formulas: x0 = 0, Jacobi
// preconditioner 1/H[i,i] (1 where H[i,i] <= 0), exactly `iters`
// iterations, alpha = 0 when p'Hp <= FLT_MIN/DBL_MIN, beta = rz_new /
// max(rz, tiny).
//
// What bounds it on an H100: reading H once (d*d values per instance,
// 100 MB in float for 10k instances at d = 50, ~31 us at 3.35 TB/s); the
// arithmetic (iters*d^2 multiply-adds per instance) is small.  Two kernels,
// chosen by ops/cuda_cg.k1_launch_plan from the shape and the alignment of H
// alone (the plan's numbers arrive here as arguments):
//
// * cg_warp_kernel, d <= 64.  One warp per instance; a persistent grid of
//   as many blocks as fit at once, each warp striding over instances.
//   Every warp owns one shared-memory buffer of one instance's H, filled
//   ahead of the arithmetic: one 1-D bulk copy (cp.async.bulk, completing
//   on an mbarrier) when d*d*sizeof(T) and H's address are multiples of
//   16 bytes, else per-element cp.async whose completion arrives on the
//   same mbarrier.  Lane j owns entries j and j + 32; dot products are
//   warp butterflies (no block barrier in the loop); p is broadcast from
//   shared memory with vector loads.
//   H is taken to be SYMMETRIC (as the reference's "sublane" matvec,
//   pallas_cg.py:50-52): (Hp)_j = sum_i H[i][j] p[i], so each lane reads a
//   column and neighbouring lanes read neighbouring words, with no bank
//   conflicts.  For an H that is not bit-for-bit symmetric the result
//   agrees with the row products of the plain twin only to rounding.
//   A lane's columns go to registers once per instance where they fit:
//   all of H in float (up to 128 values a lane) and in double at d <= 32;
//   the buffer then takes the copy of the warp's next instance at once,
//   which runs under this instance's iterations, and H is read from
//   shared memory once, not `iters` times.  Double at d > 32 (2d values a
//   lane would overflow the register file) keeps column j in registers
//   and reads row j + 32 (= column j + 32) from the buffer at every
//   iteration ("split"), 16 bytes a load at fixed offsets from one
//   address; the buffer is refilled after the instance.  Read a column
//   at a time, that part held one address per row in registers and issued
//   each load just before its multiply-add (1.6x slower on an H100).
//   Time follows the warps resident on an SM (each iteration is a chain
//   of dependent butterflies), so each warp has one buffer, not a ring:
//   deeper rings and H kept in shared memory were timed slower (PERF.md,
//   PR 3).
// * cg_kernel, larger d: one block per instance, threads over rows.  The
//   block copies its H into shared memory ONCE (opted in above 48 KB) and
//   runs every CG iteration there; when H does not fit the 227 KB a block
//   may use, it reads H's rows from device memory (L2-resident after the
//   first iteration).  Dot products are block reductions.
//
// The library is built with --fmad=false (K2's bit parity).  The warp
// kernel contracts its products and updates with explicit fma(), which
// that flag does not suppress: K1 is held to a relative tolerance against
// its twin, not to bit equality.
#include <cstdint>

#include "common.cuh"

namespace tinyopt {

// ---------------------------------------------------------------------------
// Block-per-instance kernel (d > 64).

template <typename T>
__global__ void cg_kernel(const T* __restrict__ H, const T* __restrict__ b,
                          T* __restrict__ x, int d, int iters, int h_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xv = reinterpret_cast<T*>(smem_raw);
  T* rv = xv + d;
  T* zv = rv + d;
  T* pv = zv + d;
  T* hp = pv + d;
  T* dinv = hp + d;
  T* red = dinv + d;          // 33 reduction slots
  T* Hs = red + 33;           // d*d when h_in_smem

  const size_t inst = blockIdx.x;
  const T* Hg = H + inst * (size_t)d * d;
  const T* bg = b + inst * (size_t)d;
  const T* Hm = h_in_smem ? Hs : Hg;
  const T tiny = tiny_v<T>();

  if (h_in_smem)
    for (int k = threadIdx.x; k < d * d; k += blockDim.x) Hs[k] = Hg[k];
  __syncthreads();

  T part = 0;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const T di = Hm[(size_t)i * d + i];
    dinv[i] = di > T(0) ? T(1) / di : T(1);
    xv[i] = 0;
    rv[i] = bg[i];
    zv[i] = rv[i] * dinv[i];
    pv[i] = zv[i];
    part += rv[i] * zv[i];
  }
  T rz = block_sum(part, red);

  for (int k = 0; k < iters; ++k) {
    part = 0;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const T* row = Hm + (size_t)i * d;
      T s = 0;
      for (int j = 0; j < d; ++j) s += row[j] * pv[j];
      hp[i] = s;
      part += pv[i] * s;
    }
    const T denom = block_sum(part, red);
    const T alpha = denom > tiny ? rz / denom : T(0);
    part = 0;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      xv[i] = xv[i] + alpha * pv[i];
      rv[i] = rv[i] - alpha * hp[i];
      zv[i] = rv[i] * dinv[i];
      part += rv[i] * zv[i];
    }
    const T rz_new = block_sum(part, red);
    const T beta = rz_new / (rz > tiny ? rz : tiny);
    for (int i = threadIdx.x; i < d; i += blockDim.x) pv[i] = zv[i] + beta * pv[i];
    rz = rz_new;
    __syncthreads();          // p complete before the next row products
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x) x[inst * (size_t)d + i] = xv[i];
}

// ---------------------------------------------------------------------------
// Warp-per-instance kernel (d <= 64).

constexpr int kWarpMaxD = 64;        // two columns per lane
constexpr int kWarpMaxThreads = 256;

// Where K1's iterations read H: ops/cuda_cg.H_IN_CODES.
enum HIn { kDevice = 0, kShared = 1, kSplit = 2, kRegisters = 3 };

__host__ __device__ constexpr size_t round_up(size_t v, size_t m) {
  return (v + m - 1) / m * m;
}

// Row stride of an instance's H in a warp's buffer: d, or d + 1 for an odd
// d under SPLIT (double, d > 32), so that every row starts on 16 bytes.
// An odd d in double always takes the per-value copy, which pads the rows.
__host__ __device__ constexpr int buffer_ld(int d, int elem) {
  return elem == 8 && d > 32 ? d + (d & 1) : d;
}

// Shared-memory layout of one block of the warp kernel: the warps'
// mbarriers, their p buffers of 64 values, and one buffer of one
// instance's H per warp (d rows of buffer_ld values, and 8 more values
// that a row read of the last row may reach past its end), 128-byte
// aligned.  ops/cuda_cg.py (_warp_smem_bytes) computes the same total.
struct WarpLayout {
  size_t bar_bytes, pbuf_bytes, h_bytes, total;
  __host__ __device__ WarpLayout(int d, int elem, int warps)
      : bar_bytes(round_up(8 * (size_t)warps, 128)),
        pbuf_bytes((size_t)warps * kWarpMaxD * elem),
        h_bytes(round_up(((size_t)d * buffer_ld(d, elem) + 8) * elem, 128)),
        total(bar_bytes + pbuf_bytes + (size_t)warps * h_bytes) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A copy that never lands ends the launch with an error after ~5 s of
// clock cycles instead of spinning for ever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 10000000000LL) __trap();
}

// Start copying one instance's H (d x d values) into the warp's buffer,
// rows `ld` values apart; completion is reported on `bar`.  Every lane of
// the warp calls it.  The bulk copy needs ld == d.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int d, int ld,
                                           int bulk, uint64_t* bar, int lane) {
  const int n = d * d;
  if (bulk) {
    if (lane == 0) {
      const unsigned bytes = (unsigned)n * sizeof(T);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
          : "memory");
    }
  } else {
    for (int e = lane; e < n; e += 32) {
      const int i = e / d;
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                   :: "r"(smem_u32(dst + e + i * (ld - d))), "l"(src + e),
                      "n"(sizeof(T))
                   : "memory");
    }
    // each of the 32 lanes arrives once its own copies have landed
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// p[0..3] from shared memory, 16-byte aligned, in 16-byte loads.
__device__ __forceinline__ void load4(const float* p, float (&q)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  q[0] = t.x; q[1] = t.y; q[2] = t.z; q[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&q)[4]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  const double2 u = *reinterpret_cast<const double2*>(p + 2);
  q[0] = t.x; q[1] = t.y; q[2] = u.x; q[3] = u.y;
}

// COLS: columns a lane owns (j, and j + 32 when d > 32), held in
// registers for the whole instance, rows 0..ROWS-1 (ROWS >= d, zero past
// d).  SPLIT keeps only column j there; (Hp)_{j+32} is row j + 32 of H
// times p (H symmetric), read from the buffer at every iteration in
// 16-byte loads at fixed offsets from one address.  So under SPLIT the
// buffer is refilled after the instance; otherwise as soon as the
// registers are loaded.
template <typename T, int ROWS, int COLS, bool SPLIT>
__global__ void __launch_bounds__(kWarpMaxThreads)
cg_warp_kernel(const T* __restrict__ H, const T* __restrict__ b,
               T* __restrict__ x, int B, int d, int iters, int bulk) {
  static_assert(COLS == 1 || COLS == 2, "two columns per lane at most");
  static_assert(!SPLIT || COLS == 2, "a split needs two columns");
  static_assert(ROWS > 0 && ROWS % 8 == 0, "rows");
  extern __shared__ __align__(128) unsigned char warp_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const WarpLayout L(d, sizeof(T), warps);
  const int ld = buffer_ld(d, sizeof(T));
  uint64_t* bar = reinterpret_cast<uint64_t*>(warp_smem) + warp;
  T* pbuf = reinterpret_cast<T*>(warp_smem + L.bar_bytes) + warp * kWarpMaxD;
  T* Hs = reinterpret_cast<T*>(warp_smem + L.bar_bytes + L.pbuf_bytes +
                               (size_t)warp * L.h_bytes);

  const long long n = (long long)d * d;
  const long long gwarp = (long long)blockIdx.x * warps + warp;
  const long long nwarps = (long long)gridDim.x * warps;
  const T tiny = tiny_v<T>();

  if (lane == 0) mbar_init(bar, bulk ? 1u : 32u);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  pbuf[lane] = T(0);                   // entries >= d stay 0 for good
  pbuf[lane + 32] = T(0);
  __syncwarp();
  if (gwarp < B) copy_async(Hs, H + gwarp * n, d, ld, bulk, bar, lane);

  const int j0 = lane, j1 = lane + 32;
  const bool a0 = j0 < d;
  const bool a1 = COLS == 2 && j1 < d;
  // The column and row a lane reads: a lane past d reads those of lane 0
  // (column 0, row 32), the same words, so no extra shared-memory wavefront.
  const int k0 = a0 ? j0 : 0, k1 = a1 ? j1 : (COLS == 2 ? 32 : 0);
  const T* col0 = Hs + k0;
  const T* col1 = Hs + k1;
  const T* row1 = Hs + (size_t)k1 * ld;
  T bn0 = 0, bn1 = 0;                  // b of the warp's next instance
  if (gwarp < B) {
    if (a0) bn0 = b[gwarp * d + j0];
    if (a1) bn1 = b[gwarp * d + j1];
  }

  unsigned parity = 0;
  for (long long inst = gwarp; inst < B; inst += nwarps, parity ^= 1u) {
    const long long next = inst + nwarps;
    auto refill = [&]() {              // the buffer takes the next instance
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (next < B) copy_async(Hs, H + next * n, d, ld, bulk, bar, lane);
    };
    mbar_wait(bar, parity);

    T r0 = bn0, r1 = bn1;
    if (next < B) {
      if (a0) bn0 = b[next * d + j0];
      if (a1) bn1 = b[next * d + j1];
    }
    // H[i][j] of a lane's columns is read unconditionally from a valid
    // address (column k0 or k1; rows past d read row 0), then masked by a
    // select: loads guarded by `a0 && i < d` compiled to a branch each,
    // which kept them from issuing back to back (1.5x slower on an H100).
    auto h_at = [&](const T* col, bool on, int i) {
      const T v = col[(i < d ? i : 0) * ld];
      return on && i < d ? v : T(0);
    };
    const T g0v = col0[k0 * ld], g1v = col1[k1 * ld];
    const T g0 = a0 ? g0v : T(1);
    const T g1 = a1 ? g1v : T(1);
    const T dv0 = g0 > T(0) ? T(1) / g0 : T(1);
    const T dv1 = g1 > T(0) ? T(1) / g1 : T(1);

    T h0[ROWS], h1[COLS == 2 && !SPLIT ? ROWS : 1];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      h0[i] = h_at(col0, a0, i);
      if constexpr (COLS == 2 && !SPLIT) h1[i] = h_at(col1, a1, i);
    }
    if constexpr (!SPLIT) refill();

    T x0 = 0, x1 = 0;
    T z0 = r0 * dv0, z1 = r1 * dv1;
    T p0 = z0, p1 = z1;
    T rz = warp_sum(fma_t(r1, z1, r0 * z0));
    for (int k = 0; k < iters; ++k) {
      if (a0) pbuf[j0] = p0;
      if (a1) pbuf[j1] = p1;
      __syncwarp();
      T c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};   // 4 independent sums
#pragma unroll
      for (int i = 0; i < ROWS; i += 4) {
        T pv[4];
        load4(pbuf + i, pv);
        T hr[4];                       // row j + 32, entries i..i+3
        if constexpr (SPLIT) load4(row1 + i, hr);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c0[q] = fma_t(h0[i + q], pv[q], c0[q]);
          if constexpr (SPLIT) {
            // entries past d (rows ROWS - 8 .. ROWS - 1 only) are masked
            const bool live = i + q < ROWS - 8 || i + q < d;
            c1[q] = fma_t(live ? hr[q] : T(0), pv[q], c1[q]);
          } else if constexpr (COLS == 2) {
            c1[q] = fma_t(h1[i + q], pv[q], c1[q]);
          }
        }
      }
      const T hp0 = (c0[0] + c0[1]) + (c0[2] + c0[3]);
      // a lane without entry j + 32 read lane 0's row under SPLIT
      const T hp1 = !SPLIT || a1 ? (c1[0] + c1[1]) + (c1[2] + c1[3]) : T(0);
      const T denom = warp_sum(fma_t(p1, hp1, p0 * hp0));
      const T alpha = denom > tiny ? rz / denom : T(0);
      x0 = fma_t(alpha, p0, x0);
      x1 = fma_t(alpha, p1, x1);
      r0 = fma_t(-alpha, hp0, r0);
      r1 = fma_t(-alpha, hp1, r1);
      z0 = r0 * dv0;
      z1 = r1 * dv1;
      const T rz_new = warp_sum(fma_t(r1, z1, r0 * z0));
      const T beta = rz_new / (rz > tiny ? rz : tiny);
      p0 = fma_t(beta, p0, z0);
      p1 = fma_t(beta, p1, z1);
      rz = rz_new;
      __syncwarp();                    // every lane has read p
    }
    if (a0) x[inst * d + j0] = x0;
    if (a1) x[inst * d + j1] = x1;
    if constexpr (SPLIT) refill();
  }
}

template <typename T>
using WarpKernel = void (*)(const T*, const T*, T*, int, int, int, int);

// The kernel for COLS columns a lane, rows rounded up to a multiple of 8.
template <typename T, int COLS, bool SPLIT>
WarpKernel<T> by_rows(int d) {
  if constexpr (COLS == 1) {
    switch ((d + 7) / 8) {
      case 1: return cg_warp_kernel<T, 8, 1, false>;
      case 2: return cg_warp_kernel<T, 16, 1, false>;
      case 3: return cg_warp_kernel<T, 24, 1, false>;
      case 4: return cg_warp_kernel<T, 32, 1, false>;
    }
  } else {
    switch ((d + 7) / 8) {
      case 5: return cg_warp_kernel<T, 40, 2, SPLIT>;
      case 6: return cg_warp_kernel<T, 48, 2, SPLIT>;
      case 7: return cg_warp_kernel<T, 56, 2, SPLIT>;
      case 8: return cg_warp_kernel<T, 64, 2, SPLIT>;
    }
  }
  return nullptr;
}

// All of H in registers (h_in kRegisters: float; double at d <= 32), or
// column j in registers and j + 32 in the buffer (kSplit: double, d > 32).
template <typename T>
WarpKernel<T> warp_kernel_for(int d, int h_in) {
  if (d < 1 || d > kWarpMaxD) return nullptr;
  const bool split = sizeof(T) == 8 && d > 32;
  if (h_in != (split ? kSplit : kRegisters)) return nullptr;
  if (d <= 32) return by_rows<T, 1, false>(d);
  return by_rows<T, 2, sizeof(T) == 8>(d);
}

// path 1: the warp kernel, h_in kRegisters or kSplit (warp_kernel_for);
// path 0: the block kernel, h_in kShared (H in shared memory) or kDevice
// (H's rows from device memory).  warps*32 threads and smem bytes of
// dynamic shared memory a block, as ops/cuda_cg.k1_launch_plan sets them.
template <typename T>
int launch_cg(const void* H, const void* b, void* x, int B, int d, int iters,
              int path, int h_in, int bulk, int warps, int smem, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const T* Hp = static_cast<const T*>(H);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  if (warps < 1 || warps * 32 > kWarpMaxThreads || smem < 0 ||
      (size_t)smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t e;
  if (path == 1) {
    WarpKernel<T> kern = warp_kernel_for<T>(d, h_in);
    if (kern == nullptr || (size_t)smem < WarpLayout(d, sizeof(T), warps).total ||
        (bulk && ((reinterpret_cast<uintptr_t>(H) | (size_t)d * d * sizeof(T)) & 15)))
      return (int)cudaErrorInvalidValue;
    if ((e = device_fit(reinterpret_cast<const void*>(kern), warps * 32, smem,
                        &fit)) != cudaSuccess)
      return (int)e;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    const long long need = ((long long)B + warps - 1) / warps;
    const int grid = (int)(need < fit ? need : fit);
    kern<<<grid, warps * 32, smem, st>>>(Hp, bp, xp, B, d, iters, bulk);
    return (int)cudaGetLastError();
  }
  const size_t need = (6 * (size_t)d + 33) * sizeof(T) +
                      (h_in == kShared ? (size_t)d * d * sizeof(T) : 0);
  if (path != 0 || (h_in != kShared && h_in != kDevice) || (size_t)smem < need)
    return (int)cudaErrorInvalidValue;
  if ((e = device_fit(reinterpret_cast<const void*>(cg_kernel<T>), warps * 32,
                      smem, &fit)) != cudaSuccess)
    return (int)e;
  cg_kernel<T><<<B, warps * 32, smem, st>>>(Hp, bp, xp, d, iters, h_in == kShared);
  return (int)cudaGetLastError();
}

}  // namespace tinyopt

extern "C" int tinyopt_cg_f32(const void* H, const void* b, void* x, int B,
                              int d, int iters, int path, int h_in, int bulk,
                              int warps, int smem, void* stream) {
  return tinyopt::launch_cg<float>(H, b, x, B, d, iters, path, h_in, bulk,
                                   warps, smem, stream);
}

extern "C" int tinyopt_cg_f64(const void* H, const void* b, void* x, int B,
                              int d, int iters, int path, int h_in, int bulk,
                              int warps, int smem, void* stream) {
  return tinyopt::launch_cg<double>(H, b, x, B, d, iters, path, h_in, bulk,
                                    warps, smem, stream);
}

extern "C" const char* tinyopt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
