// The error-string entry point every kernel library exports (kernels/
// __init__.py binds it); include it in exactly one source per library.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* rtxpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
