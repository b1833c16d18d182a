// The message of a CUDA error code, for the Python wrappers' exceptions.
// Compiled into each kernel library (ops/cuda/_build.py), so a library
// reports its own errors without loading the other.

#include <cuda_runtime.h>

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
