// Error text for the codes the kernel entry points return.
#include "moby_kernels.cuh"

MOBY_API const char* moby_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
