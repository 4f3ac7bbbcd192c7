// K1: batched Jacobi-preconditioned conjugate gradients, H_b x_b = b_b.
//
// Replaces the TPU kernel tinyopt_tpu/ops/pallas_cg.py::_cg_kernel (body
// pcg_on_values, launched by batched_cg_tpu).  It computes what
// ops/linalg.pcg_core computes, with the same formulas: x0 = 0, Jacobi
// preconditioner 1/H[i,i] (1 where H[i,i] <= 0), exactly `iters`
// iterations, alpha = 0 when p'Hp <= FLT_MIN/DBL_MIN, beta = rz_new /
// max(rz, tiny).
//
// What bounds it on an H100: at d <= 64 and few iterations, reading H
// once (d*d values per instance, 100 MB in float for 10k instances at
// d = 50, ~31 us at 3.35 TB/s); at larger d and d iterations, the
// arithmetic (2d^2 + 11d flops an iteration: 28 us in float at
// (1000, 96, 96), 96 iterations) and each iteration's chain of dependent
// sums.  No tensor cores: each instance multiplies its own H by one
// vector, so nothing is reused for an MMA.  Three kernels,
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
// * cg_block_kernel, d > 64.  One block per instance at a time, a
//   persistent grid of as many blocks as fit at once, each block striding
//   over instances; d threads (rounded up to a warp).  Thread j owns
//   column j, for the same reason as above: neighbouring threads read
//   neighbouring words, with no bank conflict (rows read by threads, d
//   words apart, conflicted 32-way at d = 96 and ran 0.006 of the bound,
//   PERF.md §6).  The block's buffer takes one instance's H by one bulk
//   copy on an mbarrier (per-value cp.async when unaligned).  In float at
//   d <= 128, and in double at d <= 96, a thread holds its whole column in
//   registers, so H is read from shared memory once an instance and the
//   buffer takes the next instance's copy at once ("registers"); above,
//   rows 0..63 of the column stay in registers and the rest is read from
//   the buffer at every iteration ("split").  Where H does not fit the
//   227 KB a block may use, its columns are read from device memory
//   ("device", coalesced).  Each dot product is one barrier: warp sums
//   into alternating slot sets, then every thread adds the slots in one
//   order; with the barrier that publishes p, three an iteration.
// * cg_block_wide_kernel, d > 1024: the same iteration with several
//   columns a thread, looped over at run time, their state in shared
//   memory, H read from device memory.
//
// The library is built with --fmad=false (K2's bit parity).  Both kernels
// contract their products and updates with explicit fma(), which
// that flag does not suppress: K1 is held to a relative tolerance against
// its twin, not to bit equality.
#include <cstdint>

#include "common.cuh"

namespace tinyopt {

// ---------------------------------------------------------------------------
// Warp-per-instance kernel (d <= 64).

constexpr int kWarpMaxD = 64;        // two columns per lane
constexpr int kWarpMaxThreads = 256;

// Where K1's iterations read H: ops/cuda_cg.H_IN_CODES.
enum HIn { kDevice = 0, kSplit = 1, kRegisters = 2 };

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

// ---------------------------------------------------------------------------
// Block kernel (d > 64).

constexpr int kBlockMaxThreads = 1024;
constexpr int kBlockRegThreads = 256;  // kernels that hold rows in registers
constexpr int kBlockSlots = 32;        // reduction slots a set: one a warp
constexpr int kWideVectors = 5;        // p, Hp, r, x and 1/H[j][j]

// Shared-memory layout of one block of the block kernels: its mbarrier,
// two sets of 32 reduction slots, `vecs` vectors of d values each rounded
// up to 8 (p, the tail 0; the wide kernel's column state after it), and,
// unless H is read from device memory, one buffer of one instance's H
// (d rows of d values), each 128-byte aligned.  ops/cuda_cg.py
// (_block_smem_bytes) computes the same total.
struct BlockLayout {
  size_t red_off, p_off, vec, h_off, total;
  __host__ __device__ BlockLayout(int d, int elem, bool h_in_smem, int vecs)
      : red_off(128),
        p_off(red_off + round_up(2 * kBlockSlots * (size_t)elem, 128)),
        vec(round_up(round_up(d, 8) * (size_t)elem, 128)),
        h_off(p_off + vecs * vec),
        total(h_off + (h_in_smem ? round_up((size_t)d * d * elem, 128) : 0)) {}
};

// Start copying one instance's H (n values) into the block's buffer;
// completion is reported on `bar`.  Every thread of the block calls it:
// one bulk copy by thread 0 (16-byte aligned H and size), else per-value
// cp.async by every thread, each arriving on `bar` once its copies landed.
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const T* src, long long n,
                                           int bulk, uint64_t* bar) {
  if (bulk) {
    if (threadIdx.x == 0) {
      const unsigned bytes = (unsigned)(n * (long long)sizeof(T));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
          : "memory");
    }
  } else {
    for (long long e = threadIdx.x; e < n; e += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                   :: "r"(smem_u32(dst + e)), "l"(src + e), "n"(sizeof(T))
                   : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
  }
}

// Sum over the block with one barrier.  Each warp's butterfly total goes
// to its slot of the current set; after the barrier every thread adds the
// nw totals in warp order, so every thread holds the same value and the
// control flow that follows stays uniform.  The two sets alternate: a set
// is written again two sums later, after a barrier that every thread
// reaches only once it has read the set.
template <typename T>
__device__ __forceinline__ T block_sum1(T v, T* slots, unsigned& set, int nw) {
  v = warp_sum(v);
  T* s = slots + set * kBlockSlots;
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  set ^= 1u;
  __syncthreads();
  T t = s[0];
  for (int w = 1; w < nw; ++w) t += s[w];
  return t;
}

// (Hp)_j = sum_i H[i][j] p[i] for rows from..d-1 of column `col` (its row i
// at col[i * d]), added to acc: four independent sums, p broadcast from
// shared memory in 16-byte loads (`from` a multiple of 4).
template <typename T>
__device__ __forceinline__ void column_dot(const T* col, const T* pbuf,
                                           int from, int d, T (&acc)[4]) {
  int i = from;
#pragma unroll 4
  for (; i + 4 <= d; i += 4) {
    T pv[4], hv[4];
    load4(pbuf + i, pv);
#pragma unroll
    for (int q = 0; q < 4; ++q) hv[q] = col[(size_t)(i + q) * d];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = fma_t(hv[q], pv[q], acc[q]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)    // the last d % 4 rows
    if (i + q < d) acc[q] = fma_t(col[(size_t)(i + q) * d], pbuf[i + q], acc[q]);
}

// Thread j owns column j of each instance's H, so (Hp)_j = sum_i H[i][j]
// p[i] (H symmetric) reads neighbouring words across a warp, with no bank
// conflict in shared memory and coalesced in device memory.  R: rows of
// the column held in registers (a multiple of 8, zero past d), read from
// the buffer once an instance; rows R..d-1 are read at every iteration
// from the buffer (h_in_smem) or from device memory.  R >= d holds the
// whole column ("registers"): the buffer then takes the copy of the
// block's next instance at once, which runs under this instance's
// iterations; otherwise ("split") it is refilled after the instance.  p
// is broadcast from shared memory in 16-byte loads.  Three barriers an
// iteration: p written, and one a sum.
//
// Registers a thread may use (__maxnreg__), by the rows R it holds.
// Uncapped, ptxas issued every load of p ahead of the multiply-adds and
// held about twice the registers the column needs, which cut the blocks
// an SM.  The caps: float R + 56 up to 168, double 2R + 96 for a split
// column, none for the whole double column.  R = 0: 64, set by the launch
// bounds.
template <typename T, int R>
struct BlockRegCap {
  static constexpr int value =
      R == 0 ? 64
      : sizeof(T) == 4 ? (R + 56 < 168 ? R + 56 : 168)
      : (R <= 64 ? 2 * R + 96 : 255);
};

template <typename T, int R>
__global__ void __launch_bounds__(R > 0 ? kBlockRegThreads : kBlockMaxThreads)
    __maxnreg__((BlockRegCap<T, R>::value))
cg_block_kernel(const T* __restrict__ H, const T* __restrict__ b,
                T* __restrict__ x, int B, int d, int iters, int h_in_smem,
                int bulk) {
  static_assert(R % 8 == 0, "rows");
  extern __shared__ __align__(128) unsigned char blk_smem[];
  const BlockLayout L(d, sizeof(T), h_in_smem != 0, 1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(blk_smem);
  T* slots = reinterpret_cast<T*>(blk_smem + L.red_off);
  T* pbuf = reinterpret_cast<T*>(blk_smem + L.p_off);
  T* Hs = reinterpret_cast<T*>(blk_smem + L.h_off);
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const long long n = (long long)d * d;
  const bool all_regs = R >= d;
  const T tiny = tiny_v<T>();

  if (h_in_smem && tid == 0) mbar_init(bar, bulk ? 1u : (unsigned)nt);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = tid; i < (int)round_up(d, 8); i += nt) pbuf[i] = T(0);
  __syncthreads();
  if (h_in_smem && blockIdx.x < B) copy_block(Hs, H + blockIdx.x * n, n, bulk, bar);

  // The thread's column; a thread past d reads column 0, masked by `on`.
  const bool on = tid < d;
  const int j = on ? tid : 0;
  // b of the block's next instance
  T bn = on && blockIdx.x < B ? b[blockIdx.x * (long long)d + j] : T(0);

  unsigned parity = 0, set = 0;
  for (long long inst = blockIdx.x; inst < B; inst += gridDim.x, parity ^= 1u) {
    const long long next = inst + gridDim.x;
    const T* Hm = h_in_smem ? Hs : H + inst * n;
    auto refill = [&]() {              // the buffer takes the next instance
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (next < B) copy_block(Hs, H + next * n, n, bulk, bar);
    };
    if (h_in_smem) mbar_wait(bar, parity);

    T r = bn;
    if (next < B && on) bn = b[next * d + j];
    const T g = on ? Hm[(size_t)j * d + j] : T(1);
    const T dv = g > T(0) ? T(1) / g : T(1);
    T h[R > 0 ? R : 1];
    if constexpr (R > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const T v = Hm[(size_t)(i < d ? i : 0) * d + j];
        h[i] = on && i < d ? v : T(0);
      }
    }
    if (h_in_smem && all_regs) refill();

    T xv = 0, z = r * dv, p = z;
    T rz = block_sum1(fma_t(r, z, T(0)), slots, set, nw);
    for (int k = 0; k < iters; ++k) {
      if (on) pbuf[j] = p;
      __syncthreads();                 // p complete
      T acc[4] = {0, 0, 0, 0};         // 4 independent sums
      if constexpr (R > 0) {
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          T pv[4];
          load4(pbuf + i, pv);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fma_t(h[i + q], pv[q], acc[q]);
        }
      }
      if (!all_regs) column_dot(Hm + j, pbuf, R, d, acc);
      const T s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      const T hp = on ? s : T(0);
      const T denom = block_sum1(fma_t(p, hp, T(0)), slots, set, nw);
      const T alpha = denom > tiny ? rz / denom : T(0);
      xv = fma_t(alpha, p, xv);
      r = fma_t(-alpha, hp, r);
      z = r * dv;
      const T rz_new = block_sum1(fma_t(r, z, T(0)), slots, set, nw);
      const T beta = rz_new / (rz > tiny ? rz : tiny);
      p = fma_t(beta, p, z);
      rz = rz_new;
    }
    if (on) x[inst * d + j] = xv;
    if (h_in_smem && !all_regs) refill();
  }
}

// More columns than a block has threads (d > 1024): thread t owns columns
// t, t + nt, ..., a number known only at run time, so a column's state (p,
// Hp, r, x and 1/H[j][j]) lives in shared memory, where cg_block_kernel
// keeps it in registers, and any d whose five vectors fit a block's
// shared memory runs.  H, far larger than shared memory here, is read by
// columns from device memory (coalesced).  One barrier a sum and one that
// publishes p: three an iteration.  Each thread touches only its own
// columns' state; p, read by every thread, is rewritten only after the
// barrier of the sum that follows the last read.
template <typename T>
__global__ void __launch_bounds__(kBlockMaxThreads)
cg_block_wide_kernel(const T* __restrict__ H, const T* __restrict__ b,
                     T* __restrict__ x, int B, int d, int iters, int, int) {
  extern __shared__ __align__(128) unsigned char blk_smem[];
  const BlockLayout L(d, sizeof(T), false, kWideVectors);
  T* slots = reinterpret_cast<T*>(blk_smem + L.red_off);
  T* ps = reinterpret_cast<T*>(blk_smem + L.p_off);
  T* hps = reinterpret_cast<T*>(blk_smem + L.p_off + L.vec);
  T* rs = reinterpret_cast<T*>(blk_smem + L.p_off + 2 * L.vec);
  T* xs = reinterpret_cast<T*>(blk_smem + L.p_off + 3 * L.vec);
  T* dvs = reinterpret_cast<T*>(blk_smem + L.p_off + 4 * L.vec);
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const long long n = (long long)d * d;
  const T tiny = tiny_v<T>();

  unsigned set = 0;
  for (long long inst = blockIdx.x; inst < B; inst += gridDim.x) {
    const T* Hm = H + inst * n;
    T part = 0;
    for (int j = tid; j < d; j += nt) {
      const T g = Hm[(size_t)j * d + j];
      const T dv = g > T(0) ? T(1) / g : T(1);
      const T r = b[inst * d + j];
      const T z = r * dv;
      dvs[j] = dv;
      rs[j] = r;
      xs[j] = T(0);
      ps[j] = z;
      part = fma_t(r, z, part);
    }
    T rz = block_sum1(part, slots, set, nw);  // its barrier publishes p
    for (int k = 0; k < iters; ++k) {
      part = 0;
      for (int j = tid; j < d; j += nt) {
        T acc[4] = {0, 0, 0, 0};
        column_dot(Hm + j, ps, 0, d, acc);
        const T hp = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        hps[j] = hp;
        part = fma_t(ps[j], hp, part);
      }
      const T denom = block_sum1(part, slots, set, nw);
      const T alpha = denom > tiny ? rz / denom : T(0);
      part = 0;
      for (int j = tid; j < d; j += nt) {
        xs[j] = fma_t(alpha, ps[j], xs[j]);
        const T r = fma_t(-alpha, hps[j], rs[j]);
        rs[j] = r;
        part = fma_t(r, r * dvs[j], part);
      }
      const T rz_new = block_sum1(part, slots, set, nw);
      const T beta = rz_new / (rz > tiny ? rz : tiny);
      for (int j = tid; j < d; j += nt)
        ps[j] = fma_t(beta, ps[j], rs[j] * dvs[j]);
      __syncthreads();                 // p complete
      rz = rz_new;
    }
    for (int j = tid; j < d; j += nt) x[inst * d + j] = xs[j];
  }
}

template <typename T>
using BlockKernel = void (*)(const T*, const T*, T*, int, int, int, int, int);

// The block kernel for `rows` rows of a column in registers: 0 (H from
// device memory), 64 ("split"), or a multiple of 8 from 72 to 128 in
// float and to 96 in double ("registers").
template <typename T>
BlockKernel<T> block_kernel_for(int rows) {
  switch (rows) {
    case 0: return cg_block_kernel<T, 0>;
    case 64: return cg_block_kernel<T, 64>;
    case 72: return cg_block_kernel<T, 72>;
    case 80: return cg_block_kernel<T, 80>;
    case 88: return cg_block_kernel<T, 88>;
    case 96: return cg_block_kernel<T, 96>;
  }
  if constexpr (sizeof(T) == 4) {
    switch (rows) {
      case 104: return cg_block_kernel<T, 104>;
      case 112: return cg_block_kernel<T, 112>;
      case 120: return cg_block_kernel<T, 120>;
      case 128: return cg_block_kernel<T, 128>;
    }
  }
  return nullptr;
}

// path 1: the warp kernel, h_in kRegisters or kSplit (warp_kernel_for);
// rows and cols are not read.  path 0, cols 1: cg_block_kernel, h_in
// kRegisters (rows >= d), kSplit (0 < rows < d, the rest from the buffer)
// or kDevice (rows 0, H from device memory).  path 0, cols > 1:
// cg_block_wide_kernel, kDevice, rows 0.  warps*32 threads and smem bytes
// of dynamic shared memory a block, as ops/cuda_cg.k1_launch_plan sets
// them; both paths launch a persistent grid of at most the blocks that
// fit the device at once.
template <typename T>
int launch_cg(const void* H, const void* b, void* x, int B, int d, int iters,
              int path, int h_in, int bulk, int rows, int cols, int warps,
              int smem, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const T* Hp = static_cast<const T*>(H);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  if (warps < 1 || smem < 0 || (size_t)smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const bool misaligned =
      ((reinterpret_cast<uintptr_t>(H) | (size_t)d * d * sizeof(T)) & 15) != 0;
  int fit = 0;
  cudaError_t e;
  if (path == 1) {
    WarpKernel<T> kern = warp_kernel_for<T>(d, h_in);
    if (warps * 32 > kWarpMaxThreads || kern == nullptr ||
        (size_t)smem < WarpLayout(d, sizeof(T), warps).total || (bulk && misaligned))
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
  const int threads = warps * 32;
  const bool in_smem = h_in != kDevice;
  const bool wide = cols > 1;
  const bool rows_ok = h_in == kRegisters ? rows >= d
                       : h_in == kSplit   ? rows > 0 && rows < d
                                          : h_in == kDevice && rows == 0;
  BlockKernel<T> kern = !wide ? block_kernel_for<T>(rows)
                        : in_smem ? nullptr : cg_block_wide_kernel<T>;
  if (path != 0 || !rows_ok || kern == nullptr || (size_t)rows > round_up(d, 8) ||
      cols < 1 || threads > (rows > 0 ? kBlockRegThreads : kBlockMaxThreads) ||
      (long long)threads * cols < d ||
      (size_t)smem < BlockLayout(d, sizeof(T), in_smem, wide ? kWideVectors : 1).total ||
      (bulk && (misaligned || !in_smem)))
    return (int)cudaErrorInvalidValue;
  if ((e = device_fit(reinterpret_cast<const void*>(kern), threads, smem,
                      &fit)) != cudaSuccess)
    return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = B < fit ? B : fit;
  kern<<<grid, threads, smem, st>>>(Hp, bp, xp, B, d, iters, in_smem, bulk);
  return (int)cudaGetLastError();
}

}  // namespace tinyopt

extern "C" int tinyopt_cg_f32(const void* H, const void* b, void* x, int B,
                              int d, int iters, int path, int h_in, int bulk,
                              int rows, int cols, int warps, int smem,
                              void* stream) {
  return tinyopt::launch_cg<float>(H, b, x, B, d, iters, path, h_in, bulk,
                                   rows, cols, warps, smem, stream);
}

extern "C" int tinyopt_cg_f64(const void* H, const void* b, void* x, int B,
                              int d, int iters, int path, int h_in, int bulk,
                              int rows, int cols, int warps, int smem,
                              void* stream) {
  return tinyopt::launch_cg<double>(H, b, x, B, d, iters, path, h_in, bulk,
                                    rows, cols, warps, smem, stream);
}

extern "C" const char* tinyopt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
