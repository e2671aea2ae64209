// A design of K3 that was measured and not kept: one thread an entry, each segment walked in korder.
// k3_designs.py builds it alone and times it beside the package's
// kernel (ska_sdp_func_python_torch/csrc/degrid.cu) on the same inputs.
//
// K3: plan-sorted w-stacked degridding, the adjoint of K1, over a stack
// of channel plans in one launch.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_degrid_kernel
// (vmapped over the channel-stacked plans of the cube cycle, which Mosaic
// lifts into a batched grid).
//
// Each entry gathers the 8x8 window at (iv0, iu0) from its lower and
// upper complex plane grids, applies the stored separable taps,
// val = sum_x (sum_r G[r, x] kv[r]) ku[x], weights the two planes by
// (1 - frac, frac) and writes the value in sorted order. No atomics: every
// output has one writer, so the result is deterministic. Entries past
// n_in (outside the grid) give zero, as the TPU kernel's trash segment
// does.
//
// Design: one thread serves one entry (2 x 64 separate 8-byte loads), and
// the threads walk each segment in the grid kernel's order (GridPlan.korder:
// by window corner, row then column), so that a warp's windows overlap and
// its reads hit L1; the per-entry arrays are read through the walk order
// and each value is written to its plan position.
//
// Channel axis: blockIdx.y is the channel. Every channel has the same n
// entries, planes and grid size; only n_in differs, read from a device
// array (a single plan passes none and its n_in as a scalar). A stack's
// walk orders are rows of n entries (the first n_in used). Offsets of the
// channel bases are 64-bit.
#include "../ska_sdp_func_python_torch/csrc/common.cuh"

namespace {

constexpr int kThreads = 256;

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

template <bool kWStacked>
__global__ void __launch_bounds__(kThreads)
    degrid_kernel(const float2* __restrict__ grid, const int* __restrict__ iu0,
                  const int* __restrict__ iv0, const int* __restrict__ plane,
                  const float* __restrict__ frac, const float* __restrict__ ku,
                  const float* __restrict__ kv, const int* __restrict__ korder,
                  const int* __restrict__ n_in_c, long long n_in0,
                  float2* __restrict__ out, long long n, int npix,
                  int nplanes) {
  const int c = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long base = (long long)c * n;
  const long long n_in = n_in_c ? (long long)n_in_c[c] : n_in0;
  if (t >= n_in) {
    out[base + t] = make_float2(0.f, 0.f);
    return;
  }
  const long long i = base + korder[base + t];
  float kvr[8], kur[8];
  const float4* kv4 = reinterpret_cast<const float4*>(kv + 8 * i);
  const float4* ku4 = reinterpret_cast<const float4*>(ku + 8 * i);
  const float4 a = kv4[0], b = kv4[1], d = ku4[0], e = ku4[1];
  kvr[0] = a.x; kvr[1] = a.y; kvr[2] = a.z; kvr[3] = a.w;
  kvr[4] = b.x; kvr[5] = b.y; kvr[6] = b.z; kvr[7] = b.w;
  kur[0] = d.x; kur[1] = d.y; kur[2] = d.z; kur[3] = d.w;
  kur[4] = e.x; kur[5] = e.y; kur[6] = e.z; kur[7] = e.w;
  const size_t plane_size = (size_t)npix * npix;
  const float2* g0 = grid + ((size_t)c * nplanes + plane[i]) * plane_size +
                     (size_t)iv0[i] * npix + iu0[i];
  const float2 lo = window_sum(g0, npix, kvr, kur);
  if (!kWStacked) {
    out[i] = lo;
    return;
  }
  const float2 hi = window_sum(g0 + plane_size, npix, kvr, kur);
  const float f = frac[i];
  const float w0 = 1.f - f;
  out[i] = make_float2(lo.x * w0 + hi.x * f, lo.y * w0 + hi.y * f);
}

}  // namespace

// grid: [nchan, nplanes, npix, npix] complex64; iu0, iv0, plane, frac,
// out: [nchan, n]; ku, kv: [nchan, n, 8], 16-byte aligned; korder: the
// walk order, [nchan, n] (a single plan: [n_in]); n_in: int32 [nchan] on
// the device, or null for one channel whose n_in is n_in0.
SKA_EXPORT int ska_degrid(const void* grid, const void* iu0, const void* iv0,
                          const void* plane, const void* frac, const void* ku,
                          const void* kv, const void* korder, const void* n_in,
                          long long n_in0, void* out, long long n, int nchan,
                          int npix, int nplanes, int wstacked, void* stream) {
  if (n == 0 || nchan == 0) return 0;
  const dim3 grd((unsigned)((n + kThreads - 1) / kThreads), (unsigned)nchan);
  auto kernel = wstacked ? degrid_kernel<true> : degrid_kernel<false>;
  kernel<<<grd, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const int*)iu0, (const int*)iv0,
      (const int*)plane, (const float*)frac, (const float*)ku,
      (const float*)kv, (const int*)korder, (const int*)n_in, n_in0,
      (float2*)out, n, npix, nplanes);
  return ska_last_error();
}
