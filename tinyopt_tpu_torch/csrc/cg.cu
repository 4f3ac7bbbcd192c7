// K1: batched Jacobi-preconditioned conjugate gradients, H_b x_b = b_b.
//
// Replaces the TPU kernel tinyopt_tpu/ops/pallas_cg.py::_cg_kernel (body
// pcg_on_values, launched by batched_cg_tpu).  It computes what
// ops/linalg.pcg_core computes, with the same formulas: x0 = 0, Jacobi
// preconditioner 1/H[i,i] (1 where H[i,i] <= 0), exactly `iters`
// iterations, alpha = 0 when p'Hp <= FLT_MIN/DBL_MIN, beta = rz_new /
// max(rz, tiny).
//
// Layout: one block per instance, threads over rows.  The block copies its
// H (d*d values, 10 KB at d = 50 in float) from device memory into shared
// memory ONCE and runs every CG iteration there, so device-memory traffic
// is |H| + 2|b| per solve instead of iters*|H|.  Above 48 KB the shared
// memory is opted in with cudaFuncSetAttribute; when H does not fit the
// 227 KB a block may use, the same kernel reads H's rows from device memory
// (L2-resident after the first iteration).  Dot products are block
// reductions.  The grid has exactly B blocks, so the ragged edge needs no
// padding.
//
// What bounds it on an H100: at d = 50 the H load (100 MB for 10k
// instances, ~30 us at 3.35 TB/s) and the latency of the d-long serial
// row dot products per iteration; the arithmetic (iters*d^2 FMAs per
// instance) is small.  Faster variants (several instances per block,
// warp-per-row dots) are later work.
#include "common.cuh"

namespace tinyopt {

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

template <typename T>
int launch_cg(const void* H, const void* b, void* x, int B, int d, int iters,
              void* stream) {
  if (B <= 0 || d <= 0) return 0;
  const size_t vec_bytes = (6 * (size_t)d + 33) * sizeof(T);
  const size_t h_bytes = (size_t)d * d * sizeof(T);
  const int h_in_smem = vec_bytes + h_bytes <= kMaxSmem;
  const size_t smem = vec_bytes + (h_in_smem ? h_bytes : 0);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        cg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((d + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  cg_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(b), static_cast<T*>(x),
      d, iters, h_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace tinyopt

extern "C" int tinyopt_cg_f32(const void* H, const void* b, void* x, int B,
                              int d, int iters, void* stream) {
  return tinyopt::launch_cg<float>(H, b, x, B, d, iters, stream);
}

extern "C" int tinyopt_cg_f64(const void* H, const void* b, void* x, int B,
                              int d, int iters, void* stream) {
  return tinyopt::launch_cg<double>(H, b, x, B, d, iters, stream);
}

extern "C" const char* tinyopt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
