// Shared device helpers of the tinyopt_tpu_torch CUDA kernels.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include <mutex>

namespace tinyopt {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum over the 32 lanes of a warp by an xor butterfly.  Every lane ends
// with the bit-identical total (each pairwise add is commutative), so
// control flow that branches on the result stays warp-uniform.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// finfo(T).tiny / finfo(T).eps, the constants the JAX package uses.
template <typename T> __device__ __forceinline__ T tiny_v();
template <> __device__ __forceinline__ float tiny_v<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny_v<double>() { return DBL_MIN; }
template <typename T> __device__ __forceinline__ T eps_v();
template <> __device__ __forceinline__ float eps_v<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_v<double>() { return DBL_EPSILON; }
// The reference's FloatEpsilon policy (math.h:297-301).
template <typename T> __device__ __forceinline__ T float_epsilon_v();
template <> __device__ __forceinline__ float float_epsilon_v<float>() { return 1e-4f; }
template <> __device__ __forceinline__ double float_epsilon_v<double>() { return 1e-7; }

// Largest dynamic shared memory a block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;

// The blocks of `kern` (threads a block, smem bytes of dynamic shared
// memory) that fit the current device at once, worked out at the first
// launch of each (device, kernel, threads, smem) and kept, so a launch
// makes no query of the device after that.  The kernel's limit on dynamic
// shared memory is one attribute of the kernel, whatever size launched
// last: it is raised to smem where it is lower, never lowered.
constexpr int kMaxFits = 256;
inline cudaError_t device_fit(const void* kern, int threads, int smem,
                              int* blocks) {
  struct Fit { int dev; const void* kern; int threads, smem, blocks; };
  struct Limit { int dev; const void* kern; int smem; };
  static std::mutex mu;
  static Fit fits[kMaxFits];
  static Limit limits[kMaxFits];
  static int n_fits = 0, n_limits = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Limit* lim = nullptr;
  for (int i = 0; i < n_limits; ++i)
    if (limits[i].dev == dev && limits[i].kern == kern) lim = &limits[i];
  if (lim == nullptr && n_limits < kMaxFits) {
    lim = &limits[n_limits++];
    *lim = {dev, kern, -1};
  }
  if (lim == nullptr || lim->smem < smem) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
      return e;
    if (lim != nullptr) lim->smem = smem;
  }
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    if (f.dev == dev && f.kern == kern && f.threads == threads && f.smem == smem) {
      *blocks = f.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                         smem)) != cudaSuccess)
    return e;
  *blocks = per_sm * sms;
  if (n_fits < kMaxFits) fits[n_fits++] = {dev, kern, threads, smem, *blocks};
  return cudaSuccess;
}

}  // namespace tinyopt
