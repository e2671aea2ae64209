// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by ska_sdp_func_python_torch/kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#define SKA_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point returns cudaGetLastError() after its launch, so a
// launch refused for its configuration (threads, shared memory) surfaces
// in the Python wrapper instead of silently never running.
static inline int ska_last_error() { return (int)cudaGetLastError(); }

// Asynchronous copies global -> shared (sm_80+): N bytes, N in {4, 8, 16},
// both addresses N-aligned. A thread waits for its own copies with
// ska_cp_async_wait_all(); a barrier then makes them visible to the block.
template <int N>
__device__ __forceinline__ void ska_cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
}
__device__ __forceinline__ void ska_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void ska_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (value, index) argmax step: the larger value wins, ties go to the
// smaller index (the first index in the JAX package's argmax order).
__device__ __forceinline__ void ska_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide (max value, min index) reduction of kThreads threads; every
// thread gets the result. s_v and s_i hold 33 entries.
template <int kThreads>
__device__ void ska_block_argmax(float& v, int& idx, float* s_v, int* s_i) {
  constexpr int kWarps = kThreads / 32;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    ska_better(v, idx, ov, oi);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // s_v/s_i free from the previous reduction
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_v[lane] : -FLT_MAX;
    idx = lane < kWarps ? s_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      ska_better(v, idx, ov, oi);
    }
    if (lane == 0) {
      s_v[32] = v;
      s_i[32] = idx;
    }
  }
  __syncthreads();
  v = s_v[32];
  idx = s_i[32];
}
