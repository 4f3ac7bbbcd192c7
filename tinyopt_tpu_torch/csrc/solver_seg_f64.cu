// K2's register kernels (csrc/solver_seg.cuh) in double, a translation unit
// of their own so that nvcc builds them beside the other sources.
#include "solver_seg.cuh"

namespace tinyopt {
template int launch_segment<double>(const SolverParams&, const SolverIO&, int,
                                 int, int, int, int, cudaStream_t);
}  // namespace tinyopt
