// K2's register kernels (csrc/solver_seg.cuh, csrc/solver_se3.cuh), GN / LM
// with history, in float: a translation unit of their own, so that nvcc
// builds them beside the other sources.
#include "solver_se3.cuh"

namespace tinyopt {
K2_SEG_INSTANCE(, float, false, true)
}  // namespace tinyopt
