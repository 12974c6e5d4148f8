// What every kernel library of repro_torch shares: the launch-error code
// each C entry point returns, and the C function that turns it into text
// (`_build.function` binds `kernel_error_string` in every library).
// Include it from exactly one translation unit per library.
#pragma once

#include <cuda_runtime.h>

static inline int last_error() { return (int)cudaGetLastError(); }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
