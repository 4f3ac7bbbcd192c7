// K2's warp kernel (csrc/solver_warp.cuh) on the hand-written families, in
// double: a translation unit of its own, so that nvcc builds it beside the
// other sources.
#include "solver_warp.cuh"

namespace tinyopt {
template int launch_warp_hand<double>(const SolverParams&, const SolverIO&,
                                  const ColorTables&, int, int, int, int,
                                  cudaStream_t);
}  // namespace tinyopt
