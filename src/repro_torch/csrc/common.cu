// C entry shared by the kernel wrappers: the text of a cudaError_t code, so
// a failed launch raises with CUDA's own message.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
