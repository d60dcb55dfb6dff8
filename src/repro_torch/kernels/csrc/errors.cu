// Readable CUDA error names for the Python wrappers of the kernel library.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
