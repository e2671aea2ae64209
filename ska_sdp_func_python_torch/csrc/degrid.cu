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
//
// Windows of 17 to 64 cells (supports 17 to 64) take
// degrid_wide_kernel. A CTA of 512 threads (one an SM: its shared memory
// is nearly full) serves 2048 consecutive walk positions. It loads their
// fields once, then serves them in pieces: the longest run of positions
// on one plane whose windows' bounding box fits 154 KiB, found by one
// prefix scan of the corners, is staged into shared memory with cp.async,
// both planes of a pair. A warp takes 8 positions at a time (4 past a span
// of 32), their kv and ku rows fetched into registers a batch ahead.
// Entries on one corner row whose corners lie close enough form a run
// that shares one pass over the window rows: lane x reads column x of each
// row once for all of them, and each entry weights it by its kv tap (a
// broadcast float4 of four rows), so the box is read once a run, not once
// an entry. Past 32 columns a lane reads a second column (spans past 40),
// or a tail pass spreads the few columns past 32 over the lanes, a
// (column, row) a lane. One transposed reduction sums a run's columns,
// each step halving the values a lane holds. Every output has one writer.
//
// What bounds it (NVIDIA H100 80GB HBM3, wide_designs.py, PERF.md): the
// design it replaced (a warp an entry, eight rows of loads at a time from
// device memory, 32 walk positions one after another) spent a third or
// more of its time waiting on those loads (reading the rows from shared
// memory instead took 57-65% of its time on the flagship). Here filling
// the box costs 2% or less; the pass over the rows is left: four FMAs a cell and
// plane pair, a broadcast load of kv a row, the lanes past the span idle,
// with 16 warps an SM to hide their latencies.
//
// Windows past 64 cells (supports 65 to the tile) take degrid_long_kernel,
// the wide variant's design past a box that fits: a CTA of 512 threads
// serves 1024 consecutive walk positions in pieces, each the longest run
// of positions on one plane whose windows' box is at most four bands (at
// 128 cells a window alone is 256 KiB on a plane pair, more than a
// block's shared memory), and stages the box into shared memory band
// after band of rows (198 KiB a band) with cp.async. Every entry whose
// window meets the band takes the band's rows of it, clipped: lane x holds
// columns x + 32 c of the window rows (c < 3 to 5, by span, so that the
// lanes cover the window and 16 columns or more of corner spread in one
// pass; spans past 144 in chunks of 160 columns), and two entries of one
// corner row whose corners lie that close share the pass. A lane's kv tap
// of 32 rows goes round by a shuffle, the ku taps are read once a band.
// Each band's value of an entry comes from one transposed reduction over
// the warp, and one lane adds it to the entry's sum in shared memory, band
// after band, so two launches give the same bits. ska_degrid_route names
// the route of a span, ska_degrid_long_geometry this kernel's geometry.
// What holds it (NVIDIA H100 80GB HBM3, 700 W; route4_designs.py,
// PERF.md): 4.6-5.9 times its bound on phase 18's streams at 72-128 cells,
// 2.3-5.3 times faster than the design it replaced (a warp an entry,
// every window row from device memory, most lanes idle in its last piece
// of 32 columns); the pieces' scan and staging take 2-7% of it, the
// passes over the band's rows the rest: two shared loads for four (two
// entries) FMAs a column and plane, the shuffled kv taps, the lanes past
// the run's span idle. Runs of 4 and 8 entries on 256 threads were 5-17%
// faster past 97 cells and 9-31% slower at 72, and were not kept.
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

// ---------------------------------------------------------------------------
// The wide variant: windows of 17 to 64 cells.

constexpr int kWideThreads = 512;  // 16 warps; one CTA an SM
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideBlock = 2048;   // walk positions of a CTA
// float2 cells of the shared box: what a block's shared memory holds
// beside the block's fields, the warps' tap batches and the scan (154 KiB)
constexpr int kBoxCells =
    (232448 - 20 * kWideBlock - (2 * 256 + 6) * 4 * kWideWarps - 28) / 16 * 2;

struct WideSmem {
  float2 box[kBoxCells];  // [planes][rows][cols]: the piece's grid cells
  int e[kWideBlock];      // the block's entries: index in the channel's plan,
  int u[kWideBlock];      // window corner,
  int v[kWideBlock];
  int p[kWideBlock];      // lower plane
  float f[kWideBlock];    // and plane fraction
  float kvs[kWideWarps][256];  // a warp's batch of entries: their kv rows
  float kus[kWideWarps][256];  // and ku rows
  int scan[kWideWarps][6];
  int piece[6];  // size, umin, vmin, rows, cols, plane
};
// kBoxCells counts the other members by hand: a change to them must not
// take the struct past a block's shared memory
static_assert(sizeof(WideSmem) <= 232448, "WideSmem exceeds a block's shared memory");

// The piece of the block from position pos: the longest run (at most one
// entry a thread) of entries on one plane whose windows' bounding box fits
// the shared box (one window always does).
__device__ __forceinline__ void wide_piece(WideSmem& sm, int pos, int cnt,
                                           int span, int np) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = pos + tid;
  const bool has = j < cnt;
  int b[6];  // umin, -umax, vmin, -vmax, pmin, -pmax
  b[0] = has ? sm.u[j] : INT_MAX;
  b[1] = has ? -sm.u[j] : INT_MAX;
  b[2] = has ? sm.v[j] : INT_MAX;
  b[3] = has ? -sm.v[j] : INT_MAX;
  b[4] = has ? sm.p[j] : INT_MAX;
  b[5] = has ? -sm.p[j] : INT_MAX;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int x = __shfl_up_sync(0xffffffffu, b[k], o);
      if (lane >= o) b[k] = min(b[k], x);
    }
  if (lane == 31)
#pragma unroll
    for (int k = 0; k < 6; ++k) sm.scan[warp][k] = b[k];
  __syncthreads();
  for (int w = 0; w < warp; ++w)
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = min(b[k], sm.scan[w][k]);
  const int rows = span - b[3] - b[2];
  const int cols = span - b[1] - b[0];
  const long long cells = (long long)np * rows * cols;
  // the box grows with the prefix, so the prefixes that fit are the first
  const bool fits = has && b[4] == -b[5] && cells <= kBoxCells;
  const int size = __syncthreads_count(fits);
  if (tid == size - 1) {
    sm.piece[0] = size;
    sm.piece[1] = b[0];
    sm.piece[2] = b[2];
    sm.piece[3] = rows;
    sm.piece[4] = cols;
    sm.piece[5] = b[4];
  }
  __syncthreads();
}

// One warp serves the run of m entries at positions [j, j + m) (rows
// [t0, t0 + m) of its tap batch): one plane, one corner row v0, corners
// within [ulo, ulo + spread], spread <= 32 kCols - span. Lane x holds
// column ulo + x of the window rows, read from g0 (row 0 at row v0,
// column ulo; row stride ld, upper plane at + pstride, cmax readable
// columns) once for all m entries: each entry weights it by its kv taps
// (broadcast from the warp's batch) and, lane by lane, by its ku tap where
// the column lies in its window. Past 32 columns a lane holds a second
// column, ulo + x + 32, or (kTail, spans to 40) a tail pass takes the
// columns ulo + 32 + c, c < spread + span - 32 <= 16: lane l serves column
// c = l mod that width of every (32 / width)-th row, so that the few
// columns past 32 keep the warp's lanes busy. One transposed reduction
// over the warp sums every entry's columns.
template <int kCols, bool kTail, bool kWStacked>
__device__ __forceinline__ void wide_run(const WideSmem& sm, int j, int m, int t0, int ulo,
                                         int spread, const float2* g0, int ld, int pstride,
                                         int cmax, long long base, float2* __restrict__ out,
                                         int span) {
  constexpr int W = 32 * kCols;    // tap row width
  constexpr int kRun = 8 / kCols;  // the most entries of a run
  constexpr int kC = kCols == 2 && !kTail ? 2 : 1;  // columns a lane in the main pass
  constexpr int kRows = 8 / kC;    // rows of loads in flight
  constexpr int V = 2 * kRun;      // values of the transposed reduction
  constexpr int kShift = V == 16 ? 1 : V == 8 ? 2 : 3;  // 5 - log2(V)
  const int lane = threadIdx.x & 31;
  const float* kvs = sm.kvs[threadIdx.x >> 5];
  const float* kus = sm.kus[threadIdx.x >> 5];
  bool colok[kC];
#pragma unroll
  for (int cc = 0; cc < kC; ++cc) colok[cc] = lane + 32 * cc < cmax;
  float acc[kRun][kC][4];
#pragma unroll
  for (int t = 0; t < kRun; ++t)
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      acc[t][cc][0] = acc[t][cc][1] = acc[t][cc][2] = acc[t][cc][3] = 0.f;
  const float2* gl = g0 + lane;
#pragma unroll 1
  for (int rb = 0; rb < span; rb += kRows) {
    float2 lo[kRows][kC], hi[kRows][kC];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const bool in = colok[cc] && rb + rr < span;
        const float2* q = gl + (rb + rr) * ld + 32 * cc;
        lo[rr][cc] = in ? q[0] : make_float2(0.f, 0.f);
        if (kWStacked) hi[rr][cc] = in ? q[pstride] : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int t = 0; t < kRun; ++t) {
      if (t >= m) break;  // uniform in the warp
      float k[kRows];     // the entry's kv taps of these rows (zero past the span)
#pragma unroll
      for (int rr = 0; rr < kRows; rr += 4) {
        const float4 q = *reinterpret_cast<const float4*>(&kvs[(t0 + t) * W + rb + rr]);
        k[rr] = q.x;
        k[rr + 1] = q.y;
        k[rr + 2] = q.z;
        k[rr + 3] = q.w;
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          acc[t][cc][0] = fmaf(lo[rr][cc].x, k[rr], acc[t][cc][0]);
          acc[t][cc][1] = fmaf(lo[rr][cc].y, k[rr], acc[t][cc][1]);
          if (kWStacked) {
            acc[t][cc][2] = fmaf(hi[rr][cc].x, k[rr], acc[t][cc][2]);
            acc[t][cc][3] = fmaf(hi[rr][cc].y, k[rr], acc[t][cc][3]);
          }
        }
    }
  }
  // each lane's share of every entry: its column weighted by ku and the
  // planes; value 2t is entry t's real part, 2t + 1 its imaginary part
  float val[V];
  auto add = [&](int t, int x, const float (&a)[4]) {
    // x: the column's index in entry t's window
    const float fs = kWStacked ? sm.f[j + t] : 0.f;
    const float kx = kus[(t0 + t) * W + x];
    float ar = a[0] * kx, ai = a[1] * kx;
    if (kWStacked) {
      const float w0 = 1.f - fs;
      ar = ar * w0 + (a[2] * kx) * fs;
      ai = ai * w0 + (a[3] * kx) * fs;
    }
    val[2 * t] += ar;
    val[2 * t + 1] += ai;
  };
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    val[2 * t] = val[2 * t + 1] = 0.f;
    if (t >= m) continue;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const int x = lane + 32 * cc - (sm.u[j + t] - ulo);
      if (x >= 0 && x < span) add(t, x, acc[t][cc]);
    }
  }
  if (kTail) {
    // the tail: columns 32 + c of rows r0, r0 + per, ...
    const int width = spread + span - 32;
    const int per = 32 / width;
    const int c = lane % width, r0 = lane / width;
    if (r0 < per && 32 + c < cmax) {
      float tacc[kRun][4];
#pragma unroll
      for (int t = 0; t < kRun; ++t) tacc[t][0] = tacc[t][1] = tacc[t][2] = tacc[t][3] = 0.f;
      const float2* gt = g0 + 32 + c;
      for (int r = r0; r < span; r += per) {
        const float2 lo = gt[r * ld];
        const float2 hi = kWStacked ? gt[r * ld + pstride] : make_float2(0.f, 0.f);
#pragma unroll
        for (int t = 0; t < kRun; ++t) {
          if (t >= m) break;
          const float k = kvs[(t0 + t) * W + r];
          tacc[t][0] = fmaf(lo.x, k, tacc[t][0]);
          tacc[t][1] = fmaf(lo.y, k, tacc[t][1]);
          if (kWStacked) {
            tacc[t][2] = fmaf(hi.x, k, tacc[t][2]);
            tacc[t][3] = fmaf(hi.y, k, tacc[t][3]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kRun; ++t) {
        if (t >= m) continue;
        const int x = 32 + c - (sm.u[j + t] - ulo);
        if (x >= 0 && x < span) add(t, x, tacc[t]);
      }
    }
  }
  // transposed reduction: at each of the first log2(V) steps a lane keeps
  // half of its values and adds its partner's share of them, so lane L
  // ends with value L >> kShift summed over the warp
  int n = V;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i >= n / 2) break;
        const float send = up ? val[i] : val[i + n / 2];
        const float keep = up ? val[i + n / 2] : val[i];
        val[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      n /= 2;
    } else {
      val[0] += __shfl_xor_sync(0xffffffffu, val[0], o);
    }
  }
  const int idx = lane >> kShift;
  if ((lane & ((1 << kShift) - 1)) == 0 && (idx >> 1) < m)
    reinterpret_cast<float*>(out)[2 * (base + sm.e[j + (idx >> 1)]) + (idx & 1)] = val[0];
}

// kCols: the tap rows are 32 kCols wide; kTail: windows of 33 to 40
// cells, whose columns past 32 take a tail pass
template <int kCols, bool kTail, bool kWStacked>
__global__ void __launch_bounds__(kWideThreads, 1)
    degrid_wide_kernel(const float2* __restrict__ grid,
                       const int* __restrict__ iu0, const int* __restrict__ iv0,
                       const int* __restrict__ plane,
                       const float* __restrict__ frac,
                       const float* __restrict__ ku,
                       const float* __restrict__ kv,
                       const int* __restrict__ korder,
                       const int* __restrict__ n_in_c, long long n_in0,
                       float2* __restrict__ out, long long n, int npix,
                       int nplanes, int span) {
  constexpr int W = 32 * kCols;
  constexpr int kRun = 8 / kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideSmem& sm = *reinterpret_cast<WideSmem*>(smem_raw);
  constexpr int np = kWStacked ? 2 : 1;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long base = (long long)c * n;
  const long long n_in = n_in_c ? (long long)n_in_c[c] : n_in0;
  const long long p0 = (long long)blockIdx.x * kWideBlock;
  for (int k = tid; k < kWideBlock; k += kWideThreads) {
    const long long pt = p0 + k;
    if (pt < n_in) {
      const int e = korder[base + pt];
      const long long i = base + e;
      sm.e[k] = e;
      sm.u[k] = iu0[i];
      sm.v[k] = iv0[i];
      sm.p[k] = plane[i];
      sm.f[k] = kWStacked ? frac[i] : 0.f;
    } else if (pt < n) {
      out[base + pt] = make_float2(0.f, 0.f);
    }
  }
  const int cnt = (int)max(0LL, min((long long)kWideBlock, n_in - p0));
  if (cnt == 0) return;  // the whole CTA
  const int plane_size = npix * npix;
  const float2* gc = grid + (size_t)c * nplanes * plane_size;
  const int warp = tid >> 5, lane = tid & 31;
  const int slack = (kTail ? 48 : W) - span;  // corner spread one pass covers
  float* kvs = sm.kvs[warp];
  float* kus = sm.kus[warp];
  // a batch's tap rows: lane x holds columns x + 32 cc of its entries' kv
  // and ku rows, fetched from device memory
  float pkv[kRun][kCols], pku[kRun][kCols];
  auto fetch = [&](int q0, int qend) {
#pragma unroll
    for (int t = 0; t < kRun; ++t)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int col = lane + 32 * cc;
        const bool in = q0 + t < qend && col < span;
        const long long i = base + (q0 + t < qend ? sm.e[q0 + t] : 0);
        pkv[t][cc] = in ? kv[i * W + col] : 0.f;
        pku[t][cc] = in ? ku[i * W + col] : 0.f;
      }
  };
  __syncthreads();
  for (int pos = 0; pos < cnt;) {
    wide_piece(sm, pos, min(cnt, pos + kWideThreads), span, np);
    const int size = sm.piece[0];
    const int umin = sm.piece[1], vmin = sm.piece[2];
    const int rows = sm.piece[3], cols = sm.piece[4], pl = sm.piece[5];
    const int pend = pos + size;
    // warps take kRun positions at a time; each batch's taps are fetched
    // while the one before it is served
    int q0 = pos + warp * kRun;
    fetch(q0, min(q0 + kRun, pend));
    // the box's rows, each plane, one warp a row
    for (int pr = warp; pr < np * rows; pr += kWideWarps) {
      const int hi = pr >= rows;
      const float2* src = gc + (size_t)(pl + hi) * plane_size +
                          (size_t)(vmin + pr - hi * rows) * npix + umin;
      for (int x = lane; x < cols; x += 32) ska_cp_async<8>(&sm.box[pr * cols + x], src + x);
    }
    ska_cp_async_commit();
    ska_cp_async_wait_all();
    __syncthreads();
    for (; q0 < pend; q0 += kWideWarps * kRun) {
      const int qend = min(q0 + kRun, pend);
      __syncwarp();  // the warp's previous batch is served
#pragma unroll
      for (int t = 0; t < kRun; ++t)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          kvs[t * W + lane + 32 * cc] = pkv[t][cc];
          kus[t * W + lane + 32 * cc] = pku[t][cc];
        }
      __syncwarp();
      const int qn = q0 + kWideWarps * kRun;
      if (qn < pend) fetch(qn, min(qn + kRun, pend));
      for (int j = q0; j < qend;) {
        const int v0 = sm.v[j], pj = sm.p[j];
        int ulo = sm.u[j], uhi = ulo, m = 1;
        while (j + m < qend && sm.v[j + m] == v0 && sm.p[j + m] == pj) {
          const int uu = sm.u[j + m];
          const int lo = min(ulo, uu), hi = max(uhi, uu);
          if (hi - lo > slack) break;
          ulo = lo;
          uhi = hi;
          ++m;
        }
        wide_run<kCols, kTail, kWStacked>(sm, j, m, j - q0, ulo, uhi - ulo,
                                          &sm.box[(v0 - vmin) * cols + ulo - umin], cols,
                                          rows * cols, cols - (ulo - umin), base, out, span);
        j += m;
      }
    }
    pos += size;
    __syncthreads();  // the box and the piece are free again
  }
}

// ---------------------------------------------------------------------------
// Windows past 64 cells: the piece's window rows staged in bands.

constexpr int kLongThreads = 512;  // 16 warps; one CTA an SM
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kLongBlock = 1024;   // walk positions of a CTA
constexpr int kLongRun = 2;        // the most entries of a run
constexpr int kLongBands = 4;      // a piece's box is at most this many bands
// float2 cells of a band: what a block's shared memory holds beside the
// block's fields and partial sums, the scan and the piece (198 KiB)
constexpr int kLongBandCells = (232448 - 28 * kLongBlock - 24 * kLongWarps - 24) / 8;

struct LongSmem {
  float2 box[kLongBandCells];  // [planes][band rows][cols]: a band of the piece's box
  int e[kLongBlock];           // the block's entries: index in the channel's plan,
  int u[kLongBlock];           // window corner,
  int v[kLongBlock];
  int p[kLongBlock];           // lower plane
  float f[kLongBlock];         // and plane fraction
  float2 acc[kLongBlock];      // each position's value, summed band by band
  int scan[kLongWarps][6];
  int piece[6];  // size, umin, vmin, rows, cols, plane
};
static_assert(sizeof(LongSmem) <= 232448, "LongSmem exceeds a block's shared memory");

// Columns a lane holds in a pass over a run's rows: the window and at
// least 16 columns of corner spread in 32 kCols columns, at most 5 (spans
// past 144 take their columns in chunks of 160)
inline int long_cols(int span) { return span + 16 <= 96 ? 3 : span + 16 <= 128 ? 4 : 5; }

// Chunks of 32 kCols columns a run's pass takes: one up to a span of 144
__host__ __device__ inline int long_chunks(int span, int cols) {
  return (span + 16 + 32 * cols - 1) / (32 * cols);
}

// The piece of the block from position pos: the longest run (at most one
// entry a thread, at least one) of entries on one plane whose windows'
// bounding box is at most kLongBands bands.
__device__ __forceinline__ void long_piece(LongSmem& sm, int pos, int cnt, int span, int np) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = pos + tid;
  const bool has = j < cnt;
  int b[6];  // umin, -umax, vmin, -vmax, pmin, -pmax
  b[0] = has ? sm.u[j] : INT_MAX;
  b[1] = has ? -sm.u[j] : INT_MAX;
  b[2] = has ? sm.v[j] : INT_MAX;
  b[3] = has ? -sm.v[j] : INT_MAX;
  b[4] = has ? sm.p[j] : INT_MAX;
  b[5] = has ? -sm.p[j] : INT_MAX;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int x = __shfl_up_sync(0xffffffffu, b[k], o);
      if (lane >= o) b[k] = min(b[k], x);
    }
  if (lane == 31)
#pragma unroll
    for (int k = 0; k < 6; ++k) sm.scan[warp][k] = b[k];
  __syncthreads();
  for (int w = 0; w < warp; ++w)
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = min(b[k], sm.scan[w][k]);
  const int rows = span - b[3] - b[2];
  const int cols = span - b[1] - b[0];
  const long long cells = (long long)np * rows * cols;
  // the box grows with the prefix, so the prefixes that fit are the first
  const bool fits =
      has && (tid == 0 || (b[4] == -b[5] && cells <= (long long)kLongBands * kLongBandCells));
  const int size = __syncthreads_count(fits);
  if (tid == size - 1) {
    sm.piece[0] = size;
    sm.piece[1] = b[0];
    sm.piece[2] = b[2];
    sm.piece[3] = rows;
    sm.piece[4] = cols;
    sm.piece[5] = b[4];
  }
  __syncthreads();
}

// One warp serves the run of m (1 or 2) entries at positions [j, j + m)
// on the band's rows [ra, rb) of their windows (one corner row v0,
// corners within [ulo, ulo + spread], spread + span <= 32 kCols chunks):
// lane x holds columns ulo + x + 32 c of chunk ch (c < kCols) of those rows,
// read from g0 (window row ra at column ulo; row stride ld, upper plane at
// + pstride, cmax readable columns) once for both entries, each entry
// weighting it by its kv tap (a lane's tap of 32 rows handed round by a
// shuffle) and then, column by column, by its ku tap and the plane
// weights. A transposed reduction over the warp gives each entry's value
// on these rows, which one lane adds to the entry's sum in shared memory.
template <int kCols, bool kWStacked>
__device__ __forceinline__ void long_run(LongSmem& sm, int j, int m, int ulo, int ra, int rb,
                                         const float2* g0, int ld, int pstride, int cmax,
                                         const float* __restrict__ ku,
                                         const float* __restrict__ kv, long long base, int W,
                                         int span, int nch) {
  constexpr int kRows = kCols <= 3 ? 4 : 2;  // rows of loads in flight
  const int lane = threadIdx.x & 31;
  const float* kvp[kLongRun];
  const float* kup[kLongRun];
  int off[kLongRun];  // the entry's first window column from ulo
  float fs[kLongRun];
#pragma unroll
  for (int t = 0; t < kLongRun; ++t) {
    const int jj = j + (t < m ? t : 0);
    const long long i = base + sm.e[jj];
    kvp[t] = kv + i * W;
    kup[t] = ku + i * W;
    off[t] = sm.u[jj] - ulo;
    fs[t] = kWStacked ? sm.f[jj] : 0.f;
  }
  // value 2t is entry t's real part, 2t + 1 its imaginary part
  float val[2 * kLongRun];
#pragma unroll
  for (int q = 0; q < 2 * kLongRun; ++q) val[q] = 0.f;
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    const int cb = ch * 32 * kCols;  // the chunk's first column from ulo
    bool colok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) colok[c] = cb + lane + 32 * c < cmax;
    float acc[kLongRun][kCols][4];
#pragma unroll
    for (int t = 0; t < kLongRun; ++t)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[t][c][0] = acc[t][c][1] = acc[t][c][2] = acc[t][c][3] = 0.f;
    const float2* gl = g0 + cb + lane;
#pragma unroll 1
    for (int rg = ra; rg < rb; rg += 32) {
      const int nr = min(32, rb - rg);
      // lane r holds row rg + r's kv tap of each entry
      float kvl[kLongRun];
#pragma unroll
      for (int t = 0; t < kLongRun; ++t) kvl[t] = t < m && lane < nr ? kvp[t][rg + lane] : 0.f;
      const float2* gr = gl + (size_t)(rg - ra) * ld;
#pragma unroll 1
      for (int r0 = 0; r0 < nr; r0 += kRows) {
        float2 lo[kRows][kCols], hi[kRows][kCols];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const bool in = colok[c] && r0 + q < nr;
            const float2* s = gr + (r0 + q) * ld + 32 * c;
            lo[q][c] = in ? s[0] : make_float2(0.f, 0.f);
            if (kWStacked) hi[q][c] = in ? s[pstride] : make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int t = 0; t < kLongRun; ++t) {
          if (t >= m) break;  // uniform in the warp
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            // rows past nr load zero, and their tap is zero
            const float k = __shfl_sync(0xffffffffu, kvl[t], r0 + q);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              acc[t][c][0] = fmaf(lo[q][c].x, k, acc[t][c][0]);
              acc[t][c][1] = fmaf(lo[q][c].y, k, acc[t][c][1]);
              if (kWStacked) {
                acc[t][c][2] = fmaf(hi[q][c].x, k, acc[t][c][2]);
                acc[t][c][3] = fmaf(hi[q][c].y, k, acc[t][c][3]);
              }
            }
          }
        }
      }
    }
    // each lane's share of every entry: its columns weighted by ku and the
    // planes
#pragma unroll
    for (int t = 0; t < kLongRun; ++t) {
      if (t >= m) break;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int x = cb + lane + 32 * c - off[t];  // the column in entry t's window
        if (x < 0 || x >= span) continue;
        const float kx = kup[t][x];
        float ar = acc[t][c][0] * kx, ai = acc[t][c][1] * kx;
        if (kWStacked) {
          const float w0 = 1.f - fs[t];
          ar = ar * w0 + (acc[t][c][2] * kx) * fs[t];
          ai = ai * w0 + (acc[t][c][3] * kx) * fs[t];
        }
        val[2 * t] += ar;
        val[2 * t + 1] += ai;
      }
    }
  }
  // transposed reduction: at each of the first two steps a lane keeps half
  // of its values and adds its partner's share of them, so lane L ends
  // with value L >> 3 summed over the warp
  int n = 2 * kLongRun;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < kLongRun; ++i) {
        if (i >= n / 2) break;
        const float send = up ? val[i] : val[i + n / 2];
        const float keep = up ? val[i + n / 2] : val[i];
        val[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      n /= 2;
    } else {
      val[0] += __shfl_xor_sync(0xffffffffu, val[0], o);
    }
  }
  const int idx = lane >> 3;
  if ((lane & 7) == 0 && (idx >> 1) < m)
    reinterpret_cast<float*>(sm.acc)[2 * (j + (idx >> 1)) + (idx & 1)] += val[0];
}

// kCols: columns a lane holds in a pass (long_cols). A CTA serves
// kLongBlock consecutive walk positions of its channel (blockIdx.y) in
// pieces (long_piece); each piece's box is staged band after band of rows
// (as many as a band's cells hold at the box's width), both planes of a
// pair, and every entry whose window meets the band takes that band's
// rows of it: the warps take kLongRun positions at a time, and two
// entries of one corner row whose corners lie within the slack share a
// pass (long_run). Each entry's value is the sum of its bands' values,
// added band after band by one lane, so two launches give the same bits.
template <int kCols, bool kWStacked>
__global__ void __launch_bounds__(kLongThreads, 1)
    degrid_long_kernel(const float2* __restrict__ grid, const int* __restrict__ iu0,
                       const int* __restrict__ iv0, const int* __restrict__ plane,
                       const float* __restrict__ frac, const float* __restrict__ ku,
                       const float* __restrict__ kv, const int* __restrict__ korder,
                       const int* __restrict__ n_in_c, long long n_in0,
                       float2* __restrict__ out, long long n, int npix, int nplanes,
                       int span, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LongSmem& sm = *reinterpret_cast<LongSmem*>(smem_raw);
  constexpr int np = kWStacked ? 2 : 1;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long base = (long long)c * n;
  const long long n_in = n_in_c ? (long long)n_in_c[c] : n_in0;
  const long long p0 = (long long)blockIdx.x * kLongBlock;
  for (int k = tid; k < kLongBlock; k += kLongThreads) {
    const long long pt = p0 + k;
    if (pt < n_in) {
      const int e = korder[base + pt];
      const long long i = base + e;
      sm.e[k] = e;
      sm.u[k] = iu0[i];
      sm.v[k] = iv0[i];
      sm.p[k] = plane[i];
      sm.f[k] = kWStacked ? frac[i] : 0.f;
    } else if (pt < n) {
      out[base + pt] = make_float2(0.f, 0.f);
    }
  }
  const int cnt = (int)max(0LL, min((long long)kLongBlock, n_in - p0));
  if (cnt == 0) return;  // the whole CTA
  const int plane_size = npix * npix;
  const float2* gc = grid + (size_t)c * nplanes * plane_size;
  const int warp = tid >> 5, lane = tid & 31;
  const int nch = long_chunks(span, kCols);
  const int slack = 32 * kCols * nch - span;  // corner spread one pass covers
  __syncthreads();
  for (int pos = 0; pos < cnt;) {
    long_piece(sm, pos, min(cnt, pos + kLongThreads), span, np);
    const int size = sm.piece[0];
    const int umin = sm.piece[1], vmin = sm.piece[2];
    const int rows = sm.piece[3], cols = sm.piece[4], pl = sm.piece[5];
    const int pend = pos + size;
    for (int k = pos + tid; k < pend; k += kLongThreads) sm.acc[k] = make_float2(0.f, 0.f);
    // band height: the rows of the box's width that a band holds
    const int hmax = min(rows, kLongBandCells / (np * cols));
    for (int y0 = 0; y0 < rows; y0 += hmax) {
      const int hb = min(hmax, rows - y0);
      const int bv = vmin + y0;  // the band's first grid row
      __syncthreads();  // the previous band is served (and the sums zeroed)
      for (int pr = warp; pr < np * hb; pr += kLongWarps) {
        const int hi = pr >= hb;
        const float2* src = gc + (size_t)(pl + hi) * plane_size +
                            (size_t)(bv + pr - hi * hb) * npix + umin;
        for (int x = lane; x < cols; x += 32) ska_cp_async<8>(&sm.box[pr * cols + x], src + x);
      }
      ska_cp_async_commit();
      ska_cp_async_wait_all();
      __syncthreads();
      for (int q0 = pos + warp * kLongRun; q0 < pend; q0 += kLongWarps * kLongRun) {
        const int qend = min(q0 + kLongRun, pend);
        for (int j = q0; j < qend;) {
          const int v0 = sm.v[j];
          // the window's rows in the band
          const int ra = max(0, bv - v0), rb = min(span, bv + hb - v0);
          if (ra >= rb) {
            ++j;
            continue;
          }
          int ulo = sm.u[j], m = 1;
          if (j + 1 < qend && sm.v[j + 1] == v0 && abs(sm.u[j + 1] - ulo) <= slack) {
            ulo = min(ulo, sm.u[j + 1]);
            m = 2;
          }
          long_run<kCols, kWStacked>(sm, j, m, ulo, ra, rb,
                                     &sm.box[(v0 + ra - bv) * cols + ulo - umin], cols,
                                     hb * cols, cols - (ulo - umin), ku, kv, base, W, span, nch);
          j += m;
        }
      }
    }
    __syncthreads();  // every band's sums are in
    for (int k = pos + tid; k < pend; k += kLongThreads) out[base + sm.e[k]] = sm.acc[k];
    pos = pend;
  }
}

// How ska_degrid serves windows of `span` cells: 1 the narrow kernel (16
// or fewer), 2 the wide variant (17 to 64), 4 the long-window kernel (past
// 64); 0 below one cell.
inline int degrid_route(int span) {
  return span < 1 ? 0 : span <= 16 ? 1 : span <= 64 ? 2 : 4;
}

}  // namespace

// grid: [nchan, nplanes, npix, npix] complex64 with nplanes * npix^2 <
// 2^31; iu0, iv0, plane, frac, out: [nchan, n]; ku, kv: [nchan, n, W], W
// = 8, 16, 32 or 64, the power of two from 8 up that holds the window
// (`support`, the window's span), past a window of 64 cells the span
// rounded up to a multiple of 8; korder: the walk order,
// [nchan, n] (a single plan: [n_in]); n_in: int32 [nchan] on the device,
// or null for one channel whose n_in is n_in0. wstacked 1: plane pairs
// (linear w); 0: one plane an entry (single-plane and nearest plans).
SKA_EXPORT int ska_degrid(const void* grid, const void* iu0, const void* iv0,
                          const void* plane, const void* frac, const void* ku,
                          const void* kv, const void* korder, const void* n_in,
                          long long n_in0, void* out, long long n, int nchan,
                          int npix, int nplanes, int support, int wstacked,
                          void* stream) {
  const int route = degrid_route(support);
  if (route == 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || nchan == 0) return 0;
  const dim3 grd((unsigned)((n + kThreads - 1) / kThreads), (unsigned)nchan);
  if (route == 4) {
    const int kc = long_cols(support);
    auto lng = wstacked ? degrid_long_kernel<5, true> : degrid_long_kernel<5, false>;
    if (kc == 3)
      lng = wstacked ? degrid_long_kernel<3, true> : degrid_long_kernel<3, false>;
    else if (kc == 4)
      lng = wstacked ? degrid_long_kernel<4, true> : degrid_long_kernel<4, false>;
    const cudaError_t e = cudaFuncSetAttribute(
        lng, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(LongSmem));
    if (e != cudaSuccess) return (int)e;
    const dim3 grl((unsigned)((n + kLongBlock - 1) / kLongBlock), (unsigned)nchan);
    lng<<<grl, kLongThreads, sizeof(LongSmem), (cudaStream_t)stream>>>(
        (const float2*)grid, (const int*)iu0, (const int*)iv0,
        (const int*)plane, (const float*)frac, (const float*)ku,
        (const float*)kv, (const int*)korder, (const int*)n_in, n_in0,
        (float2*)out, n, npix, nplanes, support, (support + 7) / 8 * 8);
    return ska_last_error();
  }
  if (route == 2) {
    auto wide = wstacked ? degrid_wide_kernel<1, false, true>
                         : degrid_wide_kernel<1, false, false>;
    if (support > 40)
      wide = wstacked ? degrid_wide_kernel<2, false, true> : degrid_wide_kernel<2, false, false>;
    else if (support > 32)
      wide = wstacked ? degrid_wide_kernel<2, true, true> : degrid_wide_kernel<2, true, false>;
    const cudaError_t e = cudaFuncSetAttribute(
        wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(WideSmem));
    if (e != cudaSuccess) return (int)e;
    const dim3 grw((unsigned)((n + kWideBlock - 1) / kWideBlock), (unsigned)nchan);
    wide<<<grw, kWideThreads, sizeof(WideSmem), (cudaStream_t)stream>>>(
        (const float2*)grid, (const int*)iu0, (const int*)iv0,
        (const int*)plane, (const float*)frac, (const float*)ku,
        (const float*)kv, (const int*)korder, (const int*)n_in, n_in0,
        (float2*)out, n, npix, nplanes, support);
    return ska_last_error();
  }
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

// How ska_degrid serves windows of `span` cells, decided before any
// launch: 1 the narrow kernel, 2 the wide variant, 4 the long-window
// kernel; 0 refused (below one cell).
SKA_EXPORT int ska_degrid_route(int span) { return degrid_route(span); }

// The wide variant's launch geometry: what 0 the threads of a CTA, 1 its
// dynamic shared bytes, 2 the walk positions it serves; 0 past them.
SKA_EXPORT int ska_degrid_wide_geometry(int what) {
  const int v[] = {kWideThreads, (int)sizeof(WideSmem), kWideBlock};
  return what >= 0 && what < 3 ? v[what] : 0;
}

// The long-window kernel's launch geometry at windows of `span` cells
// (past 64): what 0 the threads of a CTA, 1 its dynamic shared bytes, 2
// the walk positions it serves, 3 the columns a lane holds in a pass, 4
// the passes (chunks of columns) a run takes, 5 the float2 cells of a
// band; 0 past them or at 64 cells or fewer.
SKA_EXPORT int ska_degrid_long_geometry(int span, int what) {
  if (degrid_route(span) != 4) return 0;
  const int kc = long_cols(span);
  const int v[] = {kLongThreads, (int)sizeof(LongSmem), kLongBlock, kc, long_chunks(span, kc),
                   kLongBandCells};
  return what >= 0 && what < 6 ? v[what] : 0;
}
