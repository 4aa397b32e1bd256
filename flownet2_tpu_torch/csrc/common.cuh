// Shared by the kernel sources.  Each csrc/*.cu is compiled into its own
// shared library and includes this header once, so the definition below
// appears once in each library.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* fnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Selects the device the tensors live on (each library links its own CUDA
// runtime, whose current device starts at 0) and returns the error, if any.
static inline int fnet_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
