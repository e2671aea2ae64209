// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by ska_sdp_func_python_torch/kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SKA_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point returns cudaGetLastError() after its launch, so a
// launch refused for its configuration (threads, shared memory) surfaces
// in the Python wrapper instead of silently never running.
static inline int ska_last_error() { return (int)cudaGetLastError(); }
