// K2's register kernels (csrc/solver_seg.cuh, csrc/solver_se3.cuh), dogleg
// with history, in double: a translation unit of their own, so that nvcc
// builds them beside the other sources.
#include "solver_se3.cuh"

namespace tinyopt {
K2_SEG_INSTANCE(, double, true, true)
}  // namespace tinyopt
