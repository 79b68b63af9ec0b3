// Error text for the codes the other entry points return (cudaGetLastError()),
// and an empty kernel: the launch floor that chip_smoke.py and
// tools/keys_pose_ab.py time beside the port's kernels (no path launches it).
#include "lk_common.cuh"

namespace {
__global__ void empty_kernel() {}
}  // namespace

LK_API const char* lk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

LK_API int lk_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
