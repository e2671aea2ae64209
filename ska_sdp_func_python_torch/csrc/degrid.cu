// K3: plan-sorted w-stacked degridding, the adjoint of K1.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_degrid_kernel.
//
// One thread per sorted entry gathers the 8x8 window at (iv0, iu0) from
// its lower and upper complex plane grids, applies the stored separable
// taps, val = sum_x (sum_r G[r, x] kv[r]) ku[x], weights the two planes
// by (1 - frac, frac) and writes the value in sorted order. No atomics:
// every output has one writer, so the result is deterministic. Entries
// past n_in (outside the grid) give zero, as the TPU kernel's trash
// segment does.
//
// What bounds it on the card: the 2 x 64 complex reads of each entry's
// windows. The plan sorts entries by (plane, tile), so neighbouring
// threads read overlapping windows of the same tile and the reads are
// served mostly from L1/L2; the taps stream once, coalesced.
#include "common.cuh"

namespace {

__device__ __forceinline__ float2 window_sum(const float2* __restrict__ g,
                                             int npix, const float* kv,
                                             const float* ku) {
  float lr = 0.f, li = 0.f;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 v = g[(size_t)r * npix + x];
      ar += v.x * kv[r];
      ai += v.y * kv[r];
    }
    lr += ar * ku[x];
    li += ai * ku[x];
  }
  return make_float2(lr, li);
}

__global__ void degrid_kernel(const float2* __restrict__ grid,
                              const int* __restrict__ iu0,
                              const int* __restrict__ iv0,
                              const int* __restrict__ plane,
                              const float* __restrict__ frac,
                              const float* __restrict__ ku,
                              const float* __restrict__ kv,
                              float2* __restrict__ out, long long n,
                              long long n_in, int npix, int wstacked) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i >= n_in) {
    out[i] = make_float2(0.f, 0.f);
    return;
  }
  float kvr[8], kur[8];
  const float4* kv4 = reinterpret_cast<const float4*>(kv + 8 * i);
  const float4* ku4 = reinterpret_cast<const float4*>(ku + 8 * i);
  const float4 a = kv4[0], b = kv4[1], c = ku4[0], d = ku4[1];
  kvr[0] = a.x; kvr[1] = a.y; kvr[2] = a.z; kvr[3] = a.w;
  kvr[4] = b.x; kvr[5] = b.y; kvr[6] = b.z; kvr[7] = b.w;
  kur[0] = c.x; kur[1] = c.y; kur[2] = c.z; kur[3] = c.w;
  kur[4] = d.x; kur[5] = d.y; kur[6] = d.z; kur[7] = d.w;
  const size_t plane_size = (size_t)npix * npix;
  const float2* g0 = grid + (size_t)plane[i] * plane_size +
                     (size_t)iv0[i] * npix + iu0[i];
  const float2 lo = window_sum(g0, npix, kvr, kur);
  if (!wstacked) {
    out[i] = lo;
    return;
  }
  const float2 hi = window_sum(g0 + plane_size, npix, kvr, kur);
  const float f = frac[i];
  const float w0 = 1.f - f;
  out[i] = make_float2(lo.x * w0 + hi.x * f, lo.y * w0 + hi.y * f);
}

}  // namespace

SKA_EXPORT int ska_degrid(const void* grid, const void* iu0, const void* iv0,
                          const void* plane, const void* frac, const void* ku,
                          const void* kv, void* out, long long n,
                          long long n_in, int npix, int wstacked,
                          void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  degrid_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const int*)iu0, (const int*)iv0,
      (const int*)plane, (const float*)frac, (const float*)ku,
      (const float*)kv, (float2*)out, n, n_in, npix, wstacked);
  return ska_last_error();
}
