// K2's register kernels (csrc/solver_seg.cuh), dogleg, in float: a
// translation unit of their own, so that nvcc builds them beside the
// other sources.
#include "solver_seg.cuh"

namespace tinyopt {
K2_SEG_INSTANCE(, float, true, false)
}  // namespace tinyopt
