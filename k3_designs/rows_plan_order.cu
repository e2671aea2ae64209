// A design of K3 that was measured and not kept: 8 lanes an entry reading whole window rows, entries in plan order.
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
// What bounds it on the card: the window reads. One thread per entry
// issued 2 x 64 separate 8-byte loads, and the 32 threads of a warp read
// 32 unrelated windows of a tile, so each load touched up to 32 sectors:
// L1 request throughput, not DRAM, set its time. Here a group of 8 lanes
// serves one entry (4 entries a warp): lane x reads column x of each
// window row, so a row is one 64-byte run (2-3 sectors) and an entry needs
// about 16 x 2.5 sectors in place of 128. Lane x loads its own taps
// ku[x] and kv[x] (one 32-byte read each per entry), takes kv[r] from lane
// r by a shuffle, sums its column over the rows, scales by ku[x] and the
// plane weight, and three xor-shuffles reduce the 8 columns; one lane
// writes the value.
//
// Channel axis: blockIdx.y is the channel. Every channel has the same n
// entries, planes and grid size; only n_in differs, read from a device
// array (a single plan passes none and its n_in as a scalar). Offsets of
// the channel bases are 64-bit.
#include "../ska_sdp_func_python_torch/csrc/common.cuh"

namespace {

constexpr int kLanes = 8;  // lanes of the group that serves one entry
constexpr int kThreads = 256;

template <bool kWStacked>
__global__ void __launch_bounds__(kThreads)
    degrid_kernel(const float2* __restrict__ grid, const int* __restrict__ iu0,
                  const int* __restrict__ iv0, const int* __restrict__ plane,
                  const float* __restrict__ frac, const float* __restrict__ ku,
                  const float* __restrict__ kv, const int* __restrict__ n_in_c,
                  long long n_in0, float2* __restrict__ out, long long n,
                  int npix, int nplanes) {
  const int c = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = t / kLanes;
  if (e >= n) return;  // whole groups leave together
  const int x = threadIdx.x % kLanes;
  const unsigned gmask = 0xffu << (threadIdx.x & 31 & ~(kLanes - 1));
  const long long ce = (long long)c * n + e;
  const long long n_in = n_in_c ? (long long)n_in_c[c] : n_in0;
  if (e >= n_in) {
    if (x == 0) out[ce] = make_float2(0.f, 0.f);
    return;
  }
  const float kvx = kv[ce * kLanes + x];
  const float kux = ku[ce * kLanes + x];
  const size_t plane_size = (size_t)npix * npix;
  const float2* g0 = grid + ((size_t)c * nplanes + plane[ce]) * plane_size +
                     (size_t)iv0[ce] * npix + iu0[ce] + x;
  // every row's loads issued before any is used
  float2 lo[kLanes], hi[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    lo[r] = g0[(size_t)r * npix];
    if (kWStacked) hi[r] = g0[plane_size + (size_t)r * npix];
  }
  float lr = 0.f, li = 0.f, hr = 0.f, hq = 0.f;
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const float k = __shfl_sync(gmask, kvx, r, kLanes);
    lr += lo[r].x * k;
    li += lo[r].y * k;
    if (kWStacked) {
      hr += hi[r].x * k;
      hq += hi[r].y * k;
    }
  }
  float sr = lr * kux, si = li * kux;
  if (kWStacked) {
    const float f = frac[ce];
    const float w0 = 1.f - f;
    sr = sr * w0 + (hr * kux) * f;
    si = si * w0 + (hq * kux) * f;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    sr += __shfl_xor_sync(gmask, sr, off, kLanes);
    si += __shfl_xor_sync(gmask, si, off, kLanes);
  }
  if (x == 0) out[ce] = make_float2(sr, si);
}

}  // namespace

// grid: [nchan, nplanes, npix, npix] complex64; iu0, iv0, plane, frac,
// out: [nchan, n]; ku, kv: [nchan, n, 8]; n_in: int32 [nchan] on the
// device, or null for one channel whose n_in is n_in0.
SKA_EXPORT int ska_degrid(const void* grid, const void* iu0, const void* iv0,
                          const void* plane, const void* frac, const void* ku,
                          const void* kv, const void* n_in, long long n_in0,
                          void* out, long long n, int nchan, int npix,
                          int nplanes, int wstacked, void* stream) {
  if (n == 0 || nchan == 0) return 0;
  const long long blocks = (n * kLanes + kThreads - 1) / kThreads;
  const dim3 grd((unsigned)blocks, (unsigned)nchan);
  auto kernel = wstacked ? degrid_kernel<true> : degrid_kernel<false>;
  kernel<<<grd, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const int*)iu0, (const int*)iv0,
      (const int*)plane, (const float*)frac, (const float*)ku,
      (const float*)kv, (const int*)n_in, n_in0, (float2*)out, n, npix,
      nplanes);
  return ska_last_error();
}
