// Readable error names for the Python wrappers of the kernel library: CUDA
// runtime errors, and the launchers' own codes (sm90.cuh): 1000 + the
// CUresult of a failed tensor-map encode, 2000 for a launch plan that the
// kernel does not take.
#include <cuda_runtime.h>

#include <cstdio>

#include "sm90.cuh"

extern "C" const char* repro_cuda_error_string(int status) {
  static thread_local char buf[96];
  if (status == repro::sm90::kPlanError) return "launch plan not taken by the kernel";
  if (status >= repro::sm90::kEncodeError && status < repro::sm90::kPlanError) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             status - repro::sm90::kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
