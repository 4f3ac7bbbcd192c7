// K2: the whole batched GN / LM / DogLeg solve.  This file holds the C entry
// points and the hand-written families' instances of K2's warp kernel
// (csrc/solver_warp.cuh: max(P, d, n_res) > 64, one warp per instance with
// its state in shared memory); csrc/solver_seg.cuh holds the kernel for
// max(d, n_res) <= 64 (the bench prior, Jennrich-Sampson, Powell, Wood) and
// csrc/solver_se3.cuh the SE3 family's (pose refinement up to 21 points),
// state in registers; csrc/solver_gen.cuh a generated family's entry.
// ops/cuda_solver.k2_launch_plan picks one and its geometry.
//
// Replaces the TPU kernel tinyopt_tpu/ops/pallas_solver.py::_solver_kernel
// (launched by fused_batched_solver).  Per instance, x0 -> converged x:
// linearize at x, g = J'r, diag(J'J) (identity coloring: one jvp of the
// all-ones probe; Curtis-Powell-Reid coloring: one jvp a color's probe and
// the recovery sum; otherwise one jvp per tangent dimension), the damped
// normal equations solved in closed form when the coloring has one color
// (H diagonal), else by Jacobi-PCG applying H as J'(J p); the Powell dogleg
// from up to three such solves; the propose / lambda-escalating retry
// loop, accept / reject, rollback and probe, the lambda schedule, the
// failure budgets, the priority-ordered stop cascade and the optional
// per-iteration history of the JAX kernel (and of the carry_system=False
// loop, optimizers/loop.py).
// The plain twin is ops/cuda_solver.py::fused_solve_plain, with the same
// op order.
//
// CUDA has no automatic differentiation, so the kernels are templated on a
// residual FAMILY that provides residual / jvp / vjp as device functions
// (csrc/solver.cuh), written by hand — PriorFamily (models/problems.
// prior_residual, r = (x - y) * inv_std), JenSamFamily
// (jennrich_sampson_residuals, r_i = 2 + 2i - exp(i x1) - exp(i x2)),
// PowellFamily and WoodFamily (powell_singular_residuals, wood_residuals:
// 4 parameters, 4 and 6 residuals, two colors each; register kernel only)
// and SE3Family (models/se3_refinement.se3_residual, r_k = R p_k + t - q_k on
// an SE3 pose: P = 7 stored values, a tangent of D = 6, the jvp and vjp of
// d -> r(x (+) d) at 0, and the retraction that applies a step: the JAX
// kernel's manifold branch, ret_flat) — or generated from a traced residual
// (GeneratedFamily, ops/residual_codegen.py).
#include "solver.cuh"

namespace tinyopt {

// path kPathSegment: solver_seg_kernel (S lanes and E entries a lane per
// instance, max(d, n_res) <= 64), or for the SE3 family solver_se3_kernel
// (S lanes and E points a lane); kPathWarp: solver_kernel (its kMulti
// instance for the multi-color coloring).  The plan's
// numbers come from ops/cuda_solver.k2_launch_plan; one the kernels cannot
// run is refused with cudaErrorInvalidValue.
template <typename T>
int launch_solver(const SolverParams* p, const SolverIO* io,
                  const ColorTables& tables, int B, int path, int S, int E,
                  int warps, int grid, int smem, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->d < 1 || p->n_res < 1 || grid < 1 ||
      p->coloring < kColorNone || p->coloring > kColorMulti ||
      (p->coloring == kColorMulti && p->n_colors < 1) ||
      (p->family == kPowell && (p->d != 4 || p->n_res != 4)) ||
      (p->family == kWood && (p->d != 4 || p->n_res != 6)) ||
      (p->family == kJennrichSampson && (p->d != 2 || p->fam_m != p->n_res)) ||
      (p->family == kSE3 && (p->d != SE3Family<T>::kD || p->fam_m < 1 ||
                             p->n_res != 3 * p->fam_m ||
                             p->coloring != kColorNone)))
    return (int)cudaErrorInvalidValue;
  if (p->solver < kSolverGN || p->solver > kSolverDogLeg || p->cap < 0 ||
      (p->cap > 0 && p->cap != p->max_iters_total))
    return (int)cudaErrorInvalidValue;
  if (path == kPathSegment) {
    if (smem != 0) return (int)cudaErrorInvalidValue;
    const bool dl = p->solver == kSolverDogLeg, hist = p->cap > 0;
    if (dl)
      return hist ? launch_segment<T, true, true>(*p, *io, tables, B, S, E, warps, grid, s)
                  : launch_segment<T, true, false>(*p, *io, tables, B, S, E, warps, grid, s);
    return hist ? launch_segment<T, false, true>(*p, *io, tables, B, S, E, warps, grid, s)
                : launch_segment<T, false, false>(*p, *io, tables, B, S, E, warps, grid, s);
  }
  if (path != kPathWarp) return (int)cudaErrorInvalidValue;
  return launch_warp_hand<T>(*p, *io, tables, B, warps, grid, smem, s);
}

}  // namespace tinyopt

// probes and recovery: the multi-color coloring's tables (ColorTables),
// null for the other colorings.
extern "C" int tinyopt_solver_f32(const tinyopt::SolverParams* p,
                                  const tinyopt::SolverIO* io,
                                  const void* probes, const void* recovery,
                                  int B, int path, int S, int E, int warps,
                                  int grid, int smem, void* stream) {
  return tinyopt::launch_solver<float>(p, io, {probes, recovery}, B, path, S, E,
                                       warps, grid, smem, stream);
}

extern "C" int tinyopt_solver_f64(const tinyopt::SolverParams* p,
                                  const tinyopt::SolverIO* io,
                                  const void* probes, const void* recovery,
                                  int B, int path, int S, int E, int warps,
                                  int grid, int smem, void* stream) {
  return tinyopt::launch_solver<double>(p, io, {probes, recovery}, B, path, S,
                                        E, warps, grid, smem, stream);
}
