// Exports of the kernel library that belong to no one kernel.
#include "common.cuh"

// Names a cudaError_t returned by an entry point, for the Python wrapper.
REPRO_EXPORT const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
