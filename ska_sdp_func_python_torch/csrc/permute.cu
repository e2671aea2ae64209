// K4: apply a stack of fixed permutations, one per channel, to up to four
// payloads in one pass; the payloads may mix float32 and complex64.
//
// Replaces ska_sdp_func_python_tpu/ops/permute_pallas.py:benes_apply_tpu
// (_mid_kernel and _col_kernel, the Benes butterfly passes, vmapped over
// the channel-stacked plans of the cube cycle) and the lax.sort-based
// sort_values/unsort_values of gridding_plan.py. The TPU needed a Benes
// network because it has no fast gather; the card has one, so the port
// keeps each plan's int32 permutation and moves each element once:
// forward out[c, i] = x[c, perm[c, i]] (a gather), inverse
// out[c, perm[c, i]] = x[c, i] (a scatter). A forward payload may be one
// source shared by every channel, out[c, i] = x[perm[c, i]] (the gain
// factors of the cube cycle, one per (time, baseline) for all channels).
// Elements are copied, never computed, so the result is bit-exact with the
// plain version.
//
// What bounds it on the card: device-memory bandwidth. The side indexed
// by i is coalesced; the other side is a random 4- or 8-byte access per
// element, which costs a 32-byte sector each, so the pass reads or writes
// up to 8x the payload bytes on that side. One launch moves all payloads
// of all channels so the permutations are read once and a cube's channels
// are one launch-sized piece of work; blockIdx.y is the channel, so a
// channel's random side (2.35 MB of complex64 in a config-4 cube channel)
// stays in L2 while its blocks run, and a shared source (the same size)
// stays there for all of them.
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
                               int npay, int wide, int shared, int inverse,
                               const void* s0, const void* s1, const void* s2,
                               const void* s3, void* d0, void* d1, void* d2,
                               void* d3) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long base = (long long)blockIdx.y * n;
  const long long j = perm[base + i];
  const long long src = inverse ? base + i : base + j;
  const long long dst = inverse ? base + j : base + i;
  // a shared source (forward only) is indexed by j alone
  move(s0, d0, wide & 1, shared & 1 ? j : src, dst);
  if (npay > 1) move(s1, d1, wide & 2, shared & 2 ? j : src, dst);
  if (npay > 2) move(s2, d2, wide & 4, shared & 4 ? j : src, dst);
  if (npay > 3) move(s3, d3, wide & 8, shared & 8 ? j : src, dst);
}

}  // namespace

SKA_EXPORT const char* ska_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// perm: int32 [nchan, n]; payload k is [nchan, n], or [n] when bit k of
// shared is set (forward only). wide: bit k set when payload k is
// complex64 (8 bytes), clear for f32.
SKA_EXPORT int ska_permute(const void* perm, long long n, int nchan, int npay,
                           int wide, int shared, int inverse, const void* s0,
                           const void* s1, const void* s2, const void* s3,
                           void* d0, void* d1, void* d2, void* d3,
                           void* stream) {
  if (n == 0 || nchan == 0) return 0;
  const int threads = 256;
  const dim3 grd((unsigned)((n + threads - 1) / threads), (unsigned)nchan);
  permute_kernel<<<grd, threads, 0, (cudaStream_t)stream>>>(
      (const int*)perm, n, npay, wide, shared, inverse, s0, s1, s2, s3, d0,
      d1, d2, d3);
  return ska_last_error();
}
