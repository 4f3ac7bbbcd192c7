// K2 on a family generated from a traced residual (kGenerated): the entry
// point of one generated family's library.  _build.py writes a translation
// unit per family and instance that defines
//   K2G_T      float or double
//   K2G_DL     1 for the dogleg, 0 for GN / LM
//   K2G_HIST   1 with the history rows, 0 without
//   K2G_COLOR  kColorNone, kColorIdentity or kColorMulti
//   K2G_PATH   0: the warp kernel (kPathWarp), 1: the register kernel
//              (kPathSegment)
// includes the emitted header (ops/residual_codegen.py: struct
// tinyopt::k2gen::Residual) and then this file, and compiles it into a
// library of its own under _build/, so only the instance a call needs is
// built.  The kernel is one of K2's two, unchanged but for the family:
// csrc/solver_seg.cuh's solver_seg_kernel one instance a thread (S = 1) for
// max(P, d, n_res) <= 64, csrc/solver_warp.cuh's solver_kernel one instance
// a warp past it (the header's warp form).  K2 has no other kernel for
// generated residuals.
#pragma once

#if K2G_PATH == 0
#include "solver_warp.cuh"
#else
#include "solver_seg.cuh"
#endif

namespace tinyopt {

using GenFam = GeneratedFamily<K2G_T, k2gen::Residual>;

// The plan (ops/cuda_solver.k2_launch_plan: on the register path S = 1,
// E = max(P, d, n_res), one warp a block, a grid that covers B, no shared
// memory; on the warp path S = 32, E = ceil(max(P, d, n_res) / 32), up to 4
// warps a block, one an instance, and their state and scratch in smem
// bytes) and the parameters the family and this instance were built for
// (P arrives as fam_m, ops/cuda_solver.k2_params); anything else is refused
// with cudaErrorInvalidValue.
inline int launch_generated(const SolverParams* p, const SolverIO* io,
                            const ColorTables& tables, int B, int S, int E,
                            int warps, int grid, int smem,
                            cudaStream_t stream) {
  if (B <= 0) return 0;
  if (p->family != kGenerated || p->d != GenFam::kD ||
      p->fam_m != GenFam::kP || p->n_res != GenFam::kNRes ||
      p->coloring != K2G_COLOR ||
      (p->solver == kSolverDogLeg) != (K2G_DL != 0) ||
      p->solver < kSolverGN || p->solver > kSolverDogLeg ||
      (p->cap > 0) != (K2G_HIST != 0) ||
      (p->cap > 0 && p->cap != p->max_iters_total) ||
      (K2G_COLOR == kColorMulti && p->n_colors < 1) || grid < 1 ||
      (k2gen::Residual::kQ > 0 && io->data0 == nullptr))
    return (int)cudaErrorInvalidValue;
  GenFam fam{static_cast<const K2G_T*>(io->data0)};
#if K2G_PATH == 0
  static_assert(k2gen::Residual::kWarp, "the warp path runs the warp form");
  // launch_warp checks smem against the family's state and scratch
  if (S != 32 || E != (GenFam::kSegE + 31) / 32)
    return (int)cudaErrorInvalidValue;
  return launch_warp<K2G_T, GenFam, K2G_COLOR == kColorMulti>(
      *p, *io, fam, tables, B, warps, grid, smem, stream);
#else
  if (S != 1 || E != GenFam::kSegE || warps < 1 ||
      warps * 32 > kSegMaxThreads || (long long)grid * warps * 32 < B ||
      smem != 0)
    return (int)cudaErrorInvalidValue;
  return launch_seg_family<K2G_T, GenFam, K2G_COLOR, K2G_DL != 0,
                           K2G_HIST != 0>(*p, *io, fam, tables, B, S, E, warps,
                                          grid, stream);
#endif
}

}  // namespace tinyopt

// probes and recovery: the multi-color coloring's tables, null for the
// other colorings; the plan's path is the library's own (K2G_PATH).
extern "C" int tinyopt_gen_solver(const tinyopt::SolverParams* p,
                                  const tinyopt::SolverIO* io,
                                  const void* probes, const void* recovery,
                                  int B, int S, int E, int warps, int grid,
                                  int smem, void* stream) {
  return tinyopt::launch_generated(p, io, {probes, recovery}, B, S, E, warps,
                                   grid, smem,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* tinyopt_gen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
