// A design of K3 that was measured and not kept: rows_plan_order.cu plus each segment's tile staged in shared memory.
// k3_designs.py builds it alone and times it beside the package's
// kernel (ska_sdp_func_python_torch/csrc/degrid.cu) on the same inputs.
//
// K3: plan-sorted w-stacked degridding, the adjoint of K1, over a stack
// of channel plans in one launch.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_degrid_kernel
// (one program per chunk slot over a [buf, buf] tile, vmapped over the
// channel-stacked plans of the cube cycle, which Mosaic lifts into a
// batched grid).
//
// Each entry gathers the 8x8 window at (iv0, iu0) from its lower and
// upper complex plane grids, applies the stored separable taps,
// val = sum_x (sum_r G[r, x] kv[r]) ku[x], weights the two planes by
// (1 - frac, frac) and writes the value in sorted order. No atomics: every
// output has one writer, so the result is deterministic. Entries past
// n_in (outside the grid) give zero, as the TPU kernel's trash segment
// does.
//
// What bounds it on the card: moving the windows to the SMs. Each entry
// reads 2 x 64 complex values (1 KiB), and neighbouring entries of a
// segment read overlapping windows of one tile, but a segment's entries
// spread over every SM, so an SM's L1 rarely holds what its next entry
// reads. So a CTA takes a range of kRange
// consecutive plan-order entries, finds in it the runs of one (plane
// pair, tile) segment (entries are sorted by segment), and for each run
// of at least kMinRun entries stages the tile and its 7-wide halo of both
// planes in shared memory with cp.async ((tile + 7)^2 x 16 bytes: 63.5 KB
// at tile 56, 80.6 KB at 64) and serves the run from there; the entries
// of shorter runs (sparse tiles) read their windows from device memory.
// Within a run, a group of 8 lanes serves one entry (4 entries a warp):
// lane x reads column x of each window row, takes kv[r] from lane r by a
// shuffle, sums its column over the rows, scales by ku[x] and the plane
// weight, and three xor-shuffles reduce the 8 columns; one lane writes.
//
// Channel axis: blockIdx.y is the channel. Every channel has the same n
// entries, planes and grid size; only n_in differs, read from a device
// array (a single plan passes none and its n_in as a scalar). Offsets of
// the channel bases are 64-bit.
#include "../ska_sdp_func_python_torch/csrc/common.cuh"

namespace {

constexpr int kLanes = 8;  // lanes of the group that serves one entry
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLanes;
constexpr int kRange = 2048;   // plan-order entries a CTA takes
constexpr int kMinRun = 128;   // shortest run served from a staged tile
constexpr int kMaxRuns = kRange / kMinRun;

// One entry's value from its window: ``w`` points at column x of the
// first window row of the lower plane, rows ``row`` apart, the upper
// plane ``plane_stride`` further. Every lane of the group returns it.
template <bool kWStacked>
__device__ __forceinline__ float2 entry_value(const float2* w, size_t row,
                                              size_t plane_stride, float kvx,
                                              float kux, float f,
                                              unsigned gmask) {
  // every row's loads issued before any is used
  float2 lo[kLanes], hi[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    lo[r] = w[r * row];
    if (kWStacked) hi[r] = w[plane_stride + r * row];
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
    const float w0 = 1.f - f;
    sr = sr * w0 + (hr * kux) * f;
    si = si * w0 + (hq * kux) * f;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    sr += __shfl_xor_sync(gmask, sr, off, kLanes);
    si += __shfl_xor_sync(gmask, si, off, kLanes);
  }
  return make_float2(sr, si);
}

template <bool kWStacked>
__global__ void __launch_bounds__(kThreads)
    degrid_kernel(const float2* __restrict__ grid, const int* __restrict__ iu0,
                  const int* __restrict__ iv0, const int* __restrict__ plane,
                  const float* __restrict__ frac, const float* __restrict__ ku,
                  const float* __restrict__ kv, const int* __restrict__ n_in_c,
                  long long n_in0, float2* __restrict__ out, long long n,
                  int npix, int nplanes, int tile) {
  extern __shared__ float4 smem[];
  __shared__ int s_nruns;
  __shared__ int2 s_runs[kMaxRuns];
  const int c = blockIdx.y;
  const long long a = (long long)blockIdx.x * kRange;
  const long long n_in = n_in_c ? (long long)n_in_c[c] : n_in0;
  const long long e0 = (long long)c * n + a;  // the range's first entry
  const int m = (int)max(0LL, min((long long)kRange, n_in - a));
  const int mall = (int)min((long long)kRange, n - a);
  for (int i = m + threadIdx.x; i < mall; i += kThreads)
    out[e0 + i] = make_float2(0.f, 0.f);
  if (m == 0) return;  // the whole CTA
  const int g = threadIdx.x / kLanes;
  const int x = threadIdx.x % kLanes;
  const unsigned gmask = 0xffu << (threadIdx.x & 31 & ~(kLanes - 1));
  const size_t plane_size = (size_t)npix * npix;
  const float2* gc = grid + (size_t)c * nplanes * plane_size;
  const int nta = npix / tile;
  const int buf = tile + kLanes - 1;  // tile rows and the window halo
  float2* s_tile = reinterpret_cast<float2*>(smem);
  int* s_seg = reinterpret_cast<int*>(s_tile + (kWStacked ? 2 : 1) * buf * buf);

  // the runs of one segment: entries are sorted by (plane, tile row,
  // tile column), so a run starts where the key changes and a binary
  // search finds its end
  for (int i = threadIdx.x; i < m; i += kThreads)
    s_seg[i] = (plane[e0 + i] * nta + iv0[e0 + i] / tile) * nta + iu0[e0 + i] / tile;
  if (threadIdx.x == 0) s_nruns = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int key = s_seg[i];
    if (i > 0 && s_seg[i - 1] == key) continue;
    int lo = i + 1, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_seg[mid] == key) lo = mid + 1;
      else hi = mid;
    }
    if (lo - i >= kMinRun) s_runs[atomicAdd(&s_nruns, 1)] = make_int2(i, lo);
  }
  __syncthreads();
  const int nruns = s_nruns;

  for (int k = 0; k < nruns; ++k) {
    const int2 run = s_runs[k];
    const long long es = e0 + run.x;
    const int u0 = iu0[es] / tile * tile;
    const int v0 = iv0[es] / tile * tile;
    const int p = plane[es];
    const int rows = min(buf, npix - v0);
    const int cols = min(buf, npix - u0);
    const int per_plane = rows * cols;
    for (int i = threadIdx.x; i < (kWStacked ? 2 : 1) * per_plane; i += kThreads) {
      const int pl = i / per_plane;
      const int j = i - pl * per_plane;
      const int r = j / cols;
      const int col = j - r * cols;
      ska_cp_async<8>(s_tile + (pl * buf + r) * buf + col,
                      gc + (size_t)(p + pl) * plane_size + (size_t)(v0 + r) * npix + u0 + col);
    }
    ska_cp_async_commit();
    ska_cp_async_wait_all();
    __syncthreads();
    for (int i = run.x + g; i < run.y; i += kGroups) {
      const long long e = e0 + i;
      const float2* w = s_tile + (iv0[e] - v0) * buf + (iu0[e] - u0) + x;
      const float2 val = entry_value<kWStacked>(
          w, buf, (size_t)buf * buf, kv[e * kLanes + x], ku[e * kLanes + x],
          kWStacked ? frac[e] : 0.f, gmask);
      if (x == 0) out[e] = val;
    }
    __syncthreads();  // the tile is free for the next run
  }

  // entries of short runs: windows from device memory
  for (int i = g; i < m; i += kGroups) {
    bool staged = false;
    for (int k = 0; k < nruns; ++k)
      staged |= i >= s_runs[k].x && i < s_runs[k].y;
    if (staged) continue;  // the whole group
    const long long e = e0 + i;
    const float2* w = gc + (size_t)plane[e] * plane_size +
                      (size_t)iv0[e] * npix + iu0[e] + x;
    const float2 val = entry_value<kWStacked>(
        w, npix, plane_size, kv[e * kLanes + x], ku[e * kLanes + x],
        kWStacked ? frac[e] : 0.f, gmask);
    if (x == 0) out[e] = val;
  }
}

template <bool kWStacked>
int launch(const float2* grid, const int* iu0, const int* iv0,
           const int* plane, const float* frac, const float* ku,
           const float* kv, const int* n_in, long long n_in0, float2* out,
           long long n, int nchan, int npix, int nplanes, int tile,
           cudaStream_t s) {
  const int buf = tile + kLanes - 1;
  const size_t smem = (size_t)(kWStacked ? 2 : 1) * buf * buf * sizeof(float2) +
                      kRange * sizeof(int);
  cudaFuncSetAttribute(degrid_kernel<kWStacked>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grd((unsigned)((n + kRange - 1) / kRange), (unsigned)nchan);
  degrid_kernel<kWStacked><<<grd, kThreads, smem, s>>>(
      grid, iu0, iv0, plane, frac, ku, kv, n_in, n_in0, out, n, npix,
      nplanes, tile);
  return ska_last_error();
}

}  // namespace

// grid: [nchan, nplanes, npix, npix] complex64; iu0, iv0, plane, frac,
// out: [nchan, n]; ku, kv: [nchan, n, 8]; n_in: int32 [nchan] on the
// device, or null for one channel whose n_in is n_in0; tile: the plan's
// segment tile (at most 64, dividing npix).
SKA_EXPORT int ska_degrid(const void* grid, const void* iu0, const void* iv0,
                          const void* plane, const void* frac, const void* ku,
                          const void* kv, const void* n_in, long long n_in0,
                          void* out, long long n, int nchan, int npix,
                          int nplanes, int tile, int wstacked, void* stream) {
  if (n == 0 || nchan == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  auto run = wstacked ? launch<true> : launch<false>;
  return run((const float2*)grid, (const int*)iu0, (const int*)iv0,
             (const int*)plane, (const float*)frac, (const float*)ku,
             (const float*)kv, (const int*)n_in, n_in0, (float2*)out, n,
             nchan, npix, nplanes, tile, s);
}
