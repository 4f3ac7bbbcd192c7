// K2 on a family generated from a traced residual (kGenerated): the entry
// point of one generated family's library.  _build.py writes a translation
// unit per family and instance that defines
//   K2G_T      float or double
//   K2G_DL     1 for the dogleg, 0 for GN / LM
//   K2G_HIST   1 with the history rows, 0 without
//   K2G_COLOR  kColorNone, kColorIdentity or kColorMulti
// includes the emitted header (ops/residual_codegen.py: struct
// tinyopt::k2gen::Residual) and then this file, and compiles it into a
// library of its own under _build/, so only the instance a call needs is
// built.  The kernel is csrc/solver_seg.cuh's solver_seg_kernel, one
// instance a thread (S = 1), unchanged but for the family: K2 has no second
// kernel for generated residuals.
#pragma once

#include "solver_seg.cuh"

namespace tinyopt {

using GenFam = GeneratedFamily<K2G_T, k2gen::Residual>;

// The plan (ops/cuda_solver.k2_launch_plan: S = 1, E = max(P, d, n_res),
// one warp a block, a grid that covers B) and the parameters the family and
// this instance were built for (P arrives as fam_m, ops/cuda_solver.
// k2_params); anything else is refused with cudaErrorInvalidValue.
inline int launch_generated(const SolverParams* p, const SolverIO* io,
                            const ColorTables& tables, int B, int S, int E,
                            int warps, int grid, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (p->family != kGenerated || p->d != GenFam::kD ||
      p->fam_m != GenFam::kP || p->n_res != GenFam::kNRes ||
      p->coloring != K2G_COLOR ||
      (p->solver == kSolverDogLeg) != (K2G_DL != 0) ||
      p->solver < kSolverGN || p->solver > kSolverDogLeg ||
      (p->cap > 0) != (K2G_HIST != 0) ||
      (p->cap > 0 && p->cap != p->max_iters_total) ||
      (K2G_COLOR == kColorMulti && p->n_colors < 1) || S != 1 ||
      E != GenFam::kSegE || warps < 1 || warps * 32 > kSegMaxThreads ||
      grid < 1 || (long long)grid * warps * 32 < B ||
      (k2gen::Residual::kQ > 0 && io->data0 == nullptr))
    return (int)cudaErrorInvalidValue;
  GenFam fam{static_cast<const K2G_T*>(io->data0)};
  return launch_seg_family<K2G_T, GenFam, K2G_COLOR, K2G_DL != 0,
                           K2G_HIST != 0>(*p, *io, fam, tables, B, S, E, warps,
                                          grid, stream);
}

}  // namespace tinyopt

// probes and recovery: the multi-color coloring's tables, null for the
// other colorings; the plan's path is the register kernel's and its
// shared memory 0, so neither is passed.
extern "C" int tinyopt_gen_solver(const tinyopt::SolverParams* p,
                                  const tinyopt::SolverIO* io,
                                  const void* probes, const void* recovery,
                                  int B, int S, int E, int warps, int grid,
                                  void* stream) {
  return tinyopt::launch_generated(p, io, {probes, recovery}, B, S, E, warps,
                                   grid, static_cast<cudaStream_t>(stream));
}

extern "C" const char* tinyopt_gen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
