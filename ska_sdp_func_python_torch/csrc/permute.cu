// K4: apply a fixed permutation to up to four payloads in one pass; the
// payloads may mix float32 and complex64.
//
// Replaces ska_sdp_func_python_tpu/ops/permute_pallas.py:benes_apply_tpu
// (_mid_kernel and _col_kernel, the Benes butterfly passes) and the
// lax.sort-based sort_values/unsort_values of gridding_plan.py. The TPU
// needed a Benes network because it has no fast gather; the card has one,
// so the port keeps the plan's int32 permutation and moves each element
// once: forward out[i] = x[perm[i]] (a gather), inverse
// out[perm[i]] = x[i] (a scatter). Elements are copied, never computed,
// so the result is bit-exact with the plain version.
//
// What bounds it on the card: device-memory bandwidth. The side indexed
// by i is coalesced; the other side is a random 4- or 8-byte access per
// element, which costs a 32-byte sector each, so the pass reads or writes
// up to 8x the payload bytes on that side. One launch moves all payloads
// so the permutation itself is read once.
#include "common.cuh"

namespace {

// Moves element src of one payload to dst; wide payloads are complex64
// (8 bytes), narrow ones float32.
__device__ __forceinline__ void move(const void* s, void* d, bool wide,
                                     long long src, long long dst) {
  if (wide) {
    ((float2*)d)[dst] = ((const float2*)s)[src];
  } else {
    ((float*)d)[dst] = ((const float*)s)[src];
  }
}

__global__ void permute_kernel(const int* __restrict__ perm, long long n,
                               int npay, int wide, int inverse, const void* s0,
                               const void* s1, const void* s2, const void* s3,
                               void* d0, void* d1, void* d2, void* d3) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = perm[i];
  const long long src = inverse ? i : j;
  const long long dst = inverse ? j : i;
  move(s0, d0, wide & 1, src, dst);
  if (npay > 1) move(s1, d1, wide & 2, src, dst);
  if (npay > 2) move(s2, d2, wide & 4, src, dst);
  if (npay > 3) move(s3, d3, wide & 8, src, dst);
}

}  // namespace

SKA_EXPORT const char* ska_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// wide: bit k set when payload k is complex64 (8 bytes), clear for f32
SKA_EXPORT int ska_permute(const void* perm, long long n, int npay, int wide,
                           int inverse, const void* s0, const void* s1,
                           const void* s2, const void* s3, void* d0, void* d1,
                           void* d2, void* d3, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  permute_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)perm, n, npay, wide, inverse, s0, s1, s2, s3, d0, d1, d2,
      d3);
  return ska_last_error();
}
