// K3: plan-sorted w-stacked degridding, the adjoint of K1, over a stack
// of channel plans in one launch.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_degrid_kernel
// (vmapped over the channel-stacked plans of the cube cycle, which Mosaic
// lifts into a batched grid).
//
// Each entry gathers the S x S window at (iv0, iu0) (S the plan's
// support) from its lower and upper complex plane grids, applies the
// stored separable taps, val = sum_x (sum_r G[r, x] kv[r]) ku[x], weights
// the two planes by (1 - frac, frac) and writes the value in sorted order.
// A nearest-plane plan (and a single-plane one) reads the entry's one
// plane only, never plane + 1. No atomics: every output has one writer,
// so the result is deterministic. Entries past n_in (outside the grid)
// give zero, as the TPU kernel's trash segment does.
//
// What bounds it on the card: the window reads. One thread per entry
// issues 2 x 64 separate 8-byte loads, and the 32 threads of a warp read
// 32 unrelated windows of a tile, so each load touches up to 32 sectors:
// L1 request throughput, not DRAM, sets its time. Here a group of W lanes
// serves one entry (W = 8 for S <= 8, 16 for S <= 16, the width of the
// plan's tap rows): lane x reads column x of each window row, so a row is
// one 8W-byte run (2-3 sectors at W = 8) and an entry needs about 16 x 2.5
// sectors in place of 128. Lane x loads its own taps ku[x] and kv[x] (one
// 4W-byte read each per entry), takes kv[r] from lane r by a shuffle, sums
// its column over the rows, scales by ku[x] and the plane weight, and
// log2(W) xor-shuffles reduce the W columns; one lane writes the value.
// Lanes and rows at or past S load nothing: the window never reaches past
// the grid's last row or column, though its W-wide frame would.
//
// Entries are served in the grid kernel's walk order (GridPlan.korder: by
// window corner within each segment), so the 4 entries a warp serves at
// once read overlapping windows and share sectors. A warp takes 32
// consecutive walk positions: each lane loads one entry's index, window
// offset and fraction (one coalesced read of korder, gathers within a
// segment), and the 32 / W groups then serve the 32 entries in W steps,
// each group taking its entry's fields from the owning lane by a shuffle. So
// the chain korder -> fields -> window is paid once per 32 entries, not
// once per entry.
//
// Channel axis: blockIdx.y is the channel. Every channel has the same n
// entries, planes and grid size; only n_in differs, read from a device
// array (a single plan passes none and its n_in as a scalar). A stack's
// walk orders are rows of n entries (the first n_in used). Offsets of the
// channel bases are 64-bit; a window's offset within its channel's planes
// is 32-bit (the wrapper refuses larger planes).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// kLanes: the lanes of the group that serves one entry, the tap rows'
// width; kFull: the window is kLanes cells wide, so no load is guarded
template <int kLanes, bool kWStacked, bool kFull>
__global__ void __launch_bounds__(kThreads)
    degrid_kernel(const float2* __restrict__ grid, const int* __restrict__ iu0,
                  const int* __restrict__ iv0, const int* __restrict__ plane,
                  const float* __restrict__ frac, const float* __restrict__ ku,
                  const float* __restrict__ kv, const int* __restrict__ korder,
                  const int* __restrict__ n_in_c, long long n_in0,
                  float2* __restrict__ out, long long n, int npix,
                  int nplanes, int support) {
  constexpr int kGroups = 32 / kLanes;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long t0 =
      ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31));
  if (t0 >= n) return;  // whole warps leave together
  const long long t = t0 + lane;
  const long long base = (long long)c * n;
  const long long n_in = n_in_c ? (long long)n_in_c[c] : n_in0;
  const int plane_size = npix * npix;
  // this lane's walk position: its entry (-1 for none), window offset
  // within the channel's planes and plane fraction
  int e = -1, off = 0;
  float f = 0.f;
  if (t < n_in) {
    e = korder[base + t];
    const long long i = base + e;
    off = plane[i] * plane_size + iv0[i] * npix + iu0[i];
    if (kWStacked) f = frac[i];
  } else if (t < n) {
    out[base + t] = make_float2(0.f, 0.f);
  }
  if (t0 >= n_in) return;
  const int g = lane / kLanes;
  const int x = lane % kLanes;
  const unsigned gmask = ((1u << kLanes) - 1u) << (g * kLanes);
  const bool col = x < support;
  const float2* gc = grid + (size_t)c * nplanes * plane_size + x;
#pragma unroll 1
  for (int j = 0; j < 32 / kGroups; ++j) {
    // step j: group g serves the entry of lane kGroups j + g, so the
    // warp's kGroups entries are consecutive in the walk
    const int src = j * kGroups + g;
    const int es = __shfl_sync(0xffffffffu, e, src);
    const int os = __shfl_sync(0xffffffffu, off, src);
    const float fs = __shfl_sync(0xffffffffu, f, src);
    if (es < 0) continue;  // past n_in: uniform within the group
    const long long i = base + es;
    const float kvx = kv[i * kLanes + x];
    const float kux = ku[i * kLanes + x];
    const float2* w = gc + os;
    // every row's loads issued before any is used
    float2 lo[kLanes], hi[kLanes];
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      const bool in = kFull || (col && r < support);
      lo[r] = in ? w[r * npix] : make_float2(0.f, 0.f);
      if (kWStacked) hi[r] = in ? w[plane_size + r * npix] : make_float2(0.f, 0.f);
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
      const float w0 = 1.f - fs;
      sr = sr * w0 + (hr * kux) * fs;
      si = si * w0 + (hq * kux) * fs;
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      sr += __shfl_xor_sync(gmask, sr, o, kLanes);
      si += __shfl_xor_sync(gmask, si, o, kLanes);
    }
    if (x == 0) out[i] = make_float2(sr, si);
  }
}

}  // namespace

// grid: [nchan, nplanes, npix, npix] complex64 with nplanes * npix^2 <
// 2^31; iu0, iv0, plane, frac, out: [nchan, n]; ku, kv: [nchan, n, W], W =
// 8 for support <= 8 and 16 for support <= 16; korder: the walk order,
// [nchan, n] (a single plan: [n_in]); n_in: int32 [nchan] on the device,
// or null for one channel whose n_in is n_in0. wstacked 1: plane pairs
// (linear w); 0: one plane an entry (single-plane and nearest plans).
SKA_EXPORT int ska_degrid(const void* grid, const void* iu0, const void* iv0,
                          const void* plane, const void* frac, const void* ku,
                          const void* kv, const void* korder, const void* n_in,
                          long long n_in0, void* out, long long n, int nchan,
                          int npix, int nplanes, int support, int wstacked,
                          void* stream) {
  if (support < 1 || support > 16) return (int)cudaErrorInvalidValue;
  if (n == 0 || nchan == 0) return 0;
  const dim3 grd((unsigned)((n + kThreads - 1) / kThreads), (unsigned)nchan);
  auto kernel = wstacked ? degrid_kernel<8, true, true> : degrid_kernel<8, false, true>;
  if (support < 8)
    kernel = wstacked ? degrid_kernel<8, true, false> : degrid_kernel<8, false, false>;
  else if (support == 16)
    kernel = wstacked ? degrid_kernel<16, true, true> : degrid_kernel<16, false, true>;
  else if (support > 8)
    kernel = wstacked ? degrid_kernel<16, true, false> : degrid_kernel<16, false, false>;
  kernel<<<grd, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const int*)iu0, (const int*)iv0,
      (const int*)plane, (const float*)frac, (const float*)ku,
      (const float*)kv, (const int*)korder, (const int*)n_in, n_in0,
      (float2*)out, n, npix, nplanes, support);
  return ska_last_error();
}
