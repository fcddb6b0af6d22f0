// The one C entry point that every kernel source shares: the text of a CUDA error code
// that a launch function returned.

#include <cuda_runtime.h>

extern "C" const char* blindno_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
