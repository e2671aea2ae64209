// K1+K2: plan-sorted w-stacked gridding with the overlap-add folded in.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_grid_slot_kernel
// (the per-slot [buf, buf] tile accumulation) and the inner kernel of
// _assemble_execute (the overlap-add of each tile's halo into its
// neighbours).
//
// Each CTA takes one chunk of one (plane-pair, tile) segment of the
// plan-sorted entry stream and accumulates sum kv * val * w * ku^T for the
// lower and upper w-plane (re, im) of its [buf, buf] tile (buf = tile + S,
// S the plan's window: its support, one more for an odd support, whose
// window starts a cell early where that cell is in the tile). On a
// nearest-plane plan a segment is one (plane, tile) and the CTA
// accumulates that one plane (NACC 2).
// It then adds the tile, halo included, into the plane grids with global
// atomics, which replaces the TPU's sequential grid-carried accumulator and
// its separate assemble pass. Only touched cells are flushed.
//
// The result does not depend on the order of the atomics, so it is the
// same bit for bit from run to run, as the TPU's sequential accumulator is:
// the shared tile and the global grid accumulate integers, whose sums do
// not depend on the order of the adds. A thread's register sums are f32
// FMA in a fixed order (no TF32, no bf16); each flush adds them to the
// shared tile rounded to int64 in units of 2^-kg, where 2^(61 - kg) bounds
// every cell of the launch (the wrapper's sum of |re| + |im| over vals
// times GridPlan.tap_bound, the largest taps and plane-weight product).
// The tiles go into an int64 grid in the same units, and a second kernel
// writes the complex64 grids from it. A unit is at most 2^-60 of that
// bound: a cell is as exact as its f32 register sums unless it is below
// ~1e-12 of the bound, where the units' absolute rounding shows. At the
// flagship the grids agree with the plain version accumulated in f64 to
// 4e-7 of every cell (f32 atomics: 2e-5). A non-finite value in vals (a
// non-finite bound) makes every cell NaN.
//
// Work distribution (Romein 2012): the S x S window of an entry touches at
// most one cell of each residue class (x mod P, y mod P), P = 8 for S <= 8
// and 16 for 8 < S <= 16 (the template parameter; the plan's taps are
// stored P wide, zero past S). Each of the P^2 threads of a group owns one
// class (a, b), finds the cell of each entry's window in its class (none
// when the window's S columns or rows miss it, so no cell outside the
// window, and none past the grid edge, is touched) and sums tap * value in
// registers for as long as consecutive entries hit that cell; it adds its
// registers to the shared tile only when the cell changes, after kRunCap
// entries (which bounds the length of a sequential f32 sum) and at the
// end. A CTA runs 1024 / P^2 such groups (16 or 4), each over a contiguous
// share of its chunk.
//
// The walk order is K1's own: plan.korder permutes the entries of each
// segment by window corner (row, then column), so consecutive entries of a
// group share most cells; the plan order itself (perm) stays the JAX
// plan's. Entries reach shared memory through the gather korder[j] with
// cp.async, double-buffered: the next batch is in flight while a batch is
// summed.
//
// What bounds it on the card: the issue rate of the accumulate loop (four
// shared loads and nine f32 operations per entry and thread), then the
// global atomics of the flush. The bytes it must move (each entry once, the
// grids once) are an order of magnitude less. The int64 tile (128 KiB at
// buf 64) leaves room for one CTA an SM, so a CTA runs sixteen groups.
// At S > 8 the P = 16 stages hold 64 entries (9 KiB) in place of 256
// (21 KiB), so that the tile of buf 80 (tile 64, S 16: 200 KiB unpadded)
// still fits beside them; where the padded row stride would not fit, the
// rows go unpadded (ld = buf), which costs bank conflicts, not results.
//
// Windows of 17 to 64 cells (supports 17 to 64, each up to the plan's
// tile) take grid_wide_kernel: Romein's walk at the residue period of the
// window's own span, so every class has exactly one cell in every window
// and no thread walks an entry for nothing. A thread owns K consecutive
// rows of one column (K 8, 6 or 4 by span, wide_choice): per entry it
// finds its column from the corner's residue mod span (staged with the
// entry), reads ku once, and weights its K rows by kv read from the
// entry's kv row staged twice over, so that no row wraps. A walk of span
// x ceil(span / K) threads takes a contiguous share of its cluster's
// entries; a CTA runs as many walks as its 512, 768 or 1024 threads hold.
// The register runs (at most kRunCap entries, every thread's ending on
// the same entry) are flushed into an int64 tile in shared memory, held in
// bands of rows by a thread block cluster (the least of 1, 2, 4 or 8 CTAs
// whose bands fit beside the staged batches; at tile 64 one CTA at span
// 18, 2 from 24 to 48, 4 at 64); a flush into another CTA's band goes
// through distributed shared memory. Where 8 CTAs cannot hold the whole
// tile (tile 256 on a linear plan), they hold as many rows as fit and a
// run is served in turns of consecutive entries whose windows those rows
// hold; a tile whose rows cannot hold one window (span 64 at tile 1024 on
// a linear plan) takes the device-memory route below. Every flush is a
// 64-bit atomic add on the cluster
// address, which the card performs in one instruction, where the same add
// on the CTA's own shared address is a compare-and-swap loop. A cluster
// serves a few consecutive chunks, each run of them on one segment as one
// stream, so that its walks flush every class once at the run's end, not
// once a chunk; the overlap-add into grid64 is grid_kernel's. The units,
// the conversion and the bits are grid_kernel's (a flush's product by
// 2^kg is exact in f32 as in f64 and rounds to the same integer).
//
// What bounds it (NVIDIA H100 80GB HBM3, wide_designs.py, PERF.md): the
// design it replaced, period 32 or 64 with every one of 1024 threads
// walking every entry and flushing with int64 atomics into device memory,
// was bound by that walk: with its flushes compiled out it kept most of its
// time (92-95%). Here the walk itself takes most of it: four FMAs a class
// and entry, and its share of the entry's overhead. The flushes take the
// rest (with them compiled out it runs 9-15% faster), most of that the
// kRunCap cuts, since dense windows keep one cell for hundreds of entries
// (6-12% faster without them, which would loosen the numerics).
//
// Windows of 16 cells or fewer on tiles whose int64 rows one block cannot
// hold (a linear plan's tile past 65-74 cells, by span, a nearest or
// single-plane plan's past 99-106) take grid_wide_kernel too, chosen by geometry before the
// launch (grid_route): a thread owns every row of its column up to 8 (K =
// span, one row block) or two blocks of 6 or 8 rows, a CTA of 512 threads
// runs a walk of span x ceil(span / K) threads for each of them, and a
// batch stages at most one entry a thread (down to 2 entries a walk), so
// that one loader thread stages each entry. The units, the turns and the
// bits are the wide variant's; where the narrow kernel holds the tile it
// stays the route.
//
// Windows past 64 cells, and tiles of which a cluster's bands cannot hold
// one window's rows (a linear plan's tile past 3159 cells at span 8, 793
// at span 64), take grid_dev_kernel, the device-memory route: the wide
// variant's walk (period = span, K rows of a column a thread, K 8 past a
// span of 64) with no shared tile, each register run flushed straight into
// grid64 by a 64-bit integer add on device memory (one RED.E.ADD.64), so
// the sums stay order-free and two launches give the same bits. Where one
// walk's classes need more threads than a CTA runs (span 128 at K 8: 2048),
// they are split in slices of a CTA's threads, blockIdx.y, each slice
// walking the same entries. A CTA serves a few consecutive chunks, each
// run of them on one segment as one stream. It has no tile limit; the
// tile only orders the stream. The units, the conversion and the bits'
// independence of the order are grid_kernel's.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kStage = 16;   // entries a group stages per batch
constexpr int kRunCap = 64;  // the most entries one register sum takes
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block
constexpr int kWideWaves = 32;  // about this many wide-variant clusters an SM serves

// one batch of staged entries of all groups, for residue period P
template <int P>
struct Stage {
  static constexpr int kGroups = kThreads / (P * P);  // entry walks of a CTA
  static constexpr int kSlots = kGroups * kStage;
  float4 taps[kSlots][P / 2];  // ku[0:P], kv[0:P]
  float4 meta[kSlots];         // val.re, val.im, iu0, iv0 (int bits)
  float frac[kSlots];
};

// Row stride of the shared tile and its column swizzle. For one entry a
// warp touches 8 consecutive columns of 4 rows with distinct y mod 4; those
// 32 cells lie in 32 distinct banks when the stride is 8 or 24 mod 32 (the
// rows shift by 8 banks), or when it is a multiple of 32 and the 8-column
// blocks are XOR-swizzled by y mod 4. Only a stride of 16 mod 32 is padded
// (by 8), so buf 64 keeps 64 KiB of tile and buf 72 keeps 81 KiB.
__host__ __device__ inline int tile_ld(int buf) {
  return buf % 32 == 16 ? buf + 8 : buf;
}
__device__ __forceinline__ int swz(int y, int x, int ld) {
  return ld % 32 == 0 ? x ^ ((y & 3) << 3) : x;
}

// kg of the int64 units 2^-kg: 2^(61 - kg) > bound, which bounds every
// cell of the launch. Every CTA and the conversion compute it alike.
__device__ __forceinline__ int grid_exponent(float bound) {
  int e = 0;
  frexpf(bound, &e);  // bound < 2^e
  return 61 - e;
}

// kFull: the window is P cells wide (span 8 or 16), so every class has a
// cell in every window and the test for it compiles away
template <int P, int NACC, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    grid_kernel(const float2* __restrict__ vals, const int* __restrict__ iu0,
                const int* __restrict__ iv0, const float* __restrict__ frac,
                const float4* __restrict__ ku, const float4* __restrict__ kv,
                const int* __restrict__ order,
                const int* __restrict__ chunk_seg,
                const int* __restrict__ chunk_start,
                const int* __restrict__ chunk_count,
                const float* __restrict__ tap_bound,
                const float* __restrict__ vsum,
                unsigned long long* __restrict__ grid64, int npix, int tile,
                int nta, int support, int ld) {
  using St = Stage<P>;
  constexpr int kGroups = St::kGroups;
  constexpr int kPer = kThreads / St::kSlots;  // loader threads of a slot
  constexpr int kTapVec = P / 2;               // float4s of taps a slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  St* stage = reinterpret_cast<St*>(smem_raw);  // [2]
  // [NACC][buf][ld]: re_lo, im_lo, re_hi, im_hi, in units of 2^-kg
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(stage + 2);
  const int buf = tile + support;
  const int nb = buf * ld;

  const float total = vsum[0] * tap_bound[0];
  if (!isfinite(total)) return;  // the conversion writes NaN

  const double unit = ldexp(1.0, grid_exponent(total));

  const int seg = chunk_seg[blockIdx.x];
  const int start = chunk_start[blockIdx.x];
  const int end = start + chunk_count[blockIdx.x];
  const int ntiles = nta * nta;
  const int plane = seg / ntiles;
  const int t = seg - plane * ntiles;
  const int tv0 = (t / nta) * tile;
  const int tu0 = (t % nta) * tile;
  // the chunk's rows of the tile: its entries follow the walk order, by
  // window corner row first, so its first and last entries bound them
  const int y0 = iv0[order[start]] - tv0;
  const int y1 = min(buf, iv0[order[end - 1]] - tv0 + support);
  const int span = (y1 - y0) * ld;
  for (int i = threadIdx.x; i < NACC * span; i += kThreads) {
    const int p = i / span;
    acc[p * nb + y0 * ld + (i - p * span)] = 0;
  }
  // group g walks [start + g q, start + (g + 1) q) of the chunk
  const int q = (chunk_count[blockIdx.x] + kGroups - 1) / kGroups;
  const int nbatch = (q + kStage - 1) / kStage;

  // loader role: thread stages piece (threadIdx % kPer) of slot
  // (threadIdx / kPer): the slot's tap vectors, then its value, corner and
  // fraction, one task after another over the slot's kPer threads
  const int slot = threadIdx.x / kPer;
  const int piece = threadIdx.x % kPer;
  const int lbeg = start + (slot / kStage) * q + slot % kStage;
  const int lend = min(start + (slot / kStage + 1) * q, end);
  auto entry_of = [&](int k) {
    const int p = lbeg + k * kStage;
    return p < lend ? order[p] : -1;
  };
  auto issue = [&](int k, int e) {
    if (e >= 0) {
      St& s = stage[k & 1];
      float* m = reinterpret_cast<float*>(&s.meta[slot]);
#pragma unroll
      for (int task = piece; task < kTapVec + 4; task += kPer) {
        if (task < kTapVec / 2)
          ska_cp_async<16>(&s.taps[slot][task], ku + (size_t)e * (P / 4) + task);
        else if (task < kTapVec)
          ska_cp_async<16>(&s.taps[slot][task],
                           kv + (size_t)e * (P / 4) + (task - kTapVec / 2));
        else if (task == kTapVec)
          ska_cp_async<8>(m, vals + e);
        else if (task == kTapVec + 1)
          ska_cp_async<4>(m + 2, iu0 + e);
        else if (task == kTapVec + 2)
          ska_cp_async<4>(m + 3, iv0 + e);
        else if (NACC == 4)
          ska_cp_async<4>(&s.frac[slot], frac + e);
      }
    }
    ska_cp_async_commit();
  };

  // compute role: residue class (a, b) of group g
  const int g = threadIdx.x / (P * P);
  const int a = threadIdx.x % P;
  const int b = (threadIdx.x / P) % P;
  const int gbeg = start + g * q;
  const int gend = min(gbeg + q, end);
  int cur = -1, run = 0;
  float r0 = 0.f, i0 = 0.f, r1 = 0.f, i1 = 0.f;
  // integer adds commute: the tile is the same whatever their order
  auto fixed = [&](float r) {
    return (unsigned long long)__double2ll_rn((double)r * unit);
  };
  auto flush = [&]() {
    if (cur >= 0) {
      atomicAdd(&acc[cur], fixed(r0));
      atomicAdd(&acc[nb + cur], fixed(i0));
      if (NACC == 4) {
        atomicAdd(&acc[2 * nb + cur], fixed(r1));
        atomicAdd(&acc[3 * nb + cur], fixed(i1));
      }
    }
  };

  int e_next = entry_of(0);
  issue(0, e_next);
  e_next = entry_of(1);
  for (int k = 0; k < nbatch; ++k) {
    ska_cp_async_wait_all();
    // batch k is visible; every thread is done with batch k - 1's buffer
    // (and, at k = 0, with zeroing the tile)
    __syncthreads();
    if (k + 1 < nbatch) {
      issue(k + 1, e_next);
      e_next = entry_of(k + 2);
    }
    const St& s = stage[k & 1];
    const int j0 = gbeg + k * kStage;
    const int nj = min(kStage, gend - j0);
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const int sl = g * kStage + j;
      const float4 m = s.meta[sl];
      const int ru = __float_as_int(m.z) - tu0;
      const int rv = __float_as_int(m.w) - tv0;
      const int dx = (a - ru) & (P - 1);
      const int dy = (b - rv) & (P - 1);
      if (!kFull && (dx >= support || dy >= support)) continue;  // no cell of the class
      const int y = rv + dy;
      const int cell = y * ld + swz(y, ru + dx, ld);
      const float* tp = reinterpret_cast<const float*>(&s.taps[sl][0]);
      const float kk = tp[P + dy] * tp[dx];
      if (cell != cur || run == kRunCap) {
        flush();
        cur = cell;
        run = 0;
        r0 = i0 = r1 = i1 = 0.f;
      }
      ++run;
      if (NACC == 4) {
        const float f = s.frac[sl];
        const float w0 = 1.f - f;
        r0 = fmaf(kk, m.x * w0, r0);
        i0 = fmaf(kk, m.y * w0, i0);
        r1 = fmaf(kk, m.x * f, r1);
        i1 = fmaf(kk, m.y * f, i1);
      } else {
        r0 = fmaf(kk, m.x, r0);
        i0 = fmaf(kk, m.y, i0);
      }
    }
  }
  flush();
  __syncthreads();

  // overlap-add: the chunk's rows of the tile and its right/bottom halo
  // go straight into the int64 plane grids; untouched cells are zero and
  // skipped, halo cells past the grid edge are zero by construction
  // (entries are clipped in-grid)
  for (int i = threadIdx.x; i < (y1 - y0) * buf; i += kThreads) {
    const int y = y0 + i / buf;
    const int x = i - (y - y0) * buf;
    const int gy = tv0 + y;
    const int gx = tu0 + x;
    if (gy >= npix || gx >= npix) continue;
    const int cell = y * ld + swz(y, x, ld);
#pragma unroll
    for (int p = 0; p < NACC / 2; ++p) {
      const unsigned long long re = acc[2 * p * nb + cell];
      const unsigned long long im = acc[(2 * p + 1) * nb + cell];
      if (re != 0 || im != 0) {
        unsigned long long* gp =
            grid64 + 2 * (((size_t)(plane + p) * npix + gy) * npix + gx);
        atomicAdd(gp, re);
        atomicAdd(gp + 1, im);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide variant: windows of 17 to 64 cells.

// Launch geometry of the wide variant at window span `span` (even, 2 to
// 64) on tiles of `tile` cells, `nacc` words a cell.
struct WideGeom {
  int k;        // classes a thread owns: k consecutive rows of one column
  int threads;  // of a CTA
  int nbb;      // row blocks of a column
  int group;    // threads of one walk: span columns times nbb row blocks
  int groups;   // walks of a CTA
  int stage;    // entries a walk stages a batch
  int tv;       // float4s of a staged ku row (span taps, zero past)
  int meta;     // float4 offset of a staged entry's fields, past ku and kv twice over
  int slot;     // float4s of one staged entry
  int slots;    // entries a CTA stages a batch
  int cs;       // CTAs of a cluster: each holds a band of rb rows of the tile
  int rb;
  int ld;       // row stride of the shared tile, in words
  size_t stage_bytes, smem;
};

__host__ __device__ inline WideGeom wide_geom(int span, int tile, int nacc, int k,
                                              int threads, int cs, int stage) {
  WideGeom g;
  g.k = k;
  g.threads = threads;
  g.nbb = (span + k - 1) / k;
  g.group = span * g.nbb;
  g.groups = threads / g.group;
  g.stage = stage;
  g.tv = (span + 3) / 4;
  g.meta = g.tv + span / 2;
  g.slot = g.meta + 2;
  g.slots = g.groups * stage;
  g.cs = cs;
  const int buf = tile + span;
  g.ld = buf + 1;  // odd: a row starts two banks on from the one above
  g.stage_bytes = 2 * (size_t)g.slots * g.slot * sizeof(float4);
  // a CTA's band: its share of the tile's rows, or as many as fit
  const size_t row = (size_t)nacc * g.ld * sizeof(long long);
  const int fit = g.stage_bytes < kMaxSmem ? (int)((kMaxSmem - g.stage_bytes) / row) : 0;
  g.rb = min((buf + cs - 1) / cs, fit);
  g.smem = g.stage_bytes + row * g.rb;
  return g;
}

// The most threads a CTA of K classes a thread runs: its registers (6 or
// 8 classes of 4 words spill at 64 a thread)
template <int K>
constexpr int wide_threads() {
  return K <= 4 ? 1024 : 768;
}

// float4s of a stored tap row: the plan's tap width (8, 16, 32 or 64
// floats, the power of two from 8 up that holds the span; past a span of
// 64 the span rounded up to a multiple of 8) over 4
__host__ __device__ inline int tap_vecs(int span) {
  return span <= 8 ? 2 : span <= 16 ? 4 : span <= 32 ? 8 : span <= 64 ? 16 : (span + 7) / 8 * 2;
}

// Classes a thread and threads a CTA (measured on the flagship's plans,
// PERF.md): 8 rows a thread where they tile the span and 16 does (spans
// 32, 48, 64), else 6 or 4, whichever leaves fewer rows idle; the fewest
// threads (512, 768, 1024) that give 8 walks a CTA, or with 8 rows a
// thread that keep three quarters of them walking. Fewer walks a chunk
// end fewer runs (a walk flushes every class at its end); too few leave
// the SM short of work. Windows of 16 cells or fewer: every row of a
// column a thread up to a span of 8, else two blocks of 6 (spans 10, 12)
// or 8 rows (14, 16), and 512 threads.
inline void wide_choice(int span, int& k, int& threads) {
  if (span <= 16) {
    k = span <= 8 ? span : span <= 12 ? 6 : 8;
    threads = 512;
    return;
  }
  const int w6 = (6 - span % 6) % 6, w4 = (4 - span % 4) % 4;
  k = span % 16 == 0 ? 8 : w6 <= w4 ? 6 : 4;
  const int group = span * ((span + k - 1) / k);
  const int most = k == 4 ? wide_threads<4>() : wide_threads<6>();
  for (threads = 512; threads < most; threads += 256) {
    const int groups = threads / group;
    if (k == 8 ? 4 * groups * group >= 3 * threads : groups >= 8) return;
  }
}

// The least cluster (1, 2, 4 or 8 CTAs) whose bands of the tile fit a
// block's shared memory beside batches of 32, 16 or 8 entries a walk (at
// windows of 16 cells or fewer down to 2), the largest batch that fits
// with at most one staged entry a thread. Fewer CTAs a cluster keep more
// of the flushes in the CTA's own shared memory. Where no cluster holds
// the whole tile, 8 CTAs with batches of 8 (fewer where the threads need
// it) hold as many rows as fit, and the kernel serves each run in turns;
// cs 0 when those rows cannot hold one window's span.
inline WideGeom wide_plan(int span, int tile, int nacc) {
  int k, threads;
  wide_choice(span, k, threads);
  const int least = span > 16 ? 8 : 2;
  auto valid = [](const WideGeom& g) { return g.groups >= 1 && g.slots <= g.threads; };
  for (int cs = 1; cs <= 8; cs *= 2)
    for (int stage = 32; stage >= least; stage /= 2) {
      const WideGeom g = wide_geom(span, tile, nacc, k, threads, cs, stage);
      if (valid(g) && g.cs * g.rb >= tile + span) return g;
    }
  int stage = 8;
  while (stage > least && !valid(wide_geom(span, tile, nacc, k, threads, 8, stage))) stage /= 2;
  WideGeom g = wide_geom(span, tile, nacc, k, threads, 8, stage);
  if (!valid(g) || g.cs * g.rb < span) g.cs = 0;
  return g;
}

// K classes a thread (wide_choice), NACC as grid_kernel's; wv: float4s of a
// stored tap row (tap_vecs). A cluster of CTAs serves the chunks [per c,
// per (c + 1)), one run of consecutive chunks of one segment at a time:
// a run's entries are one walk's stream, so a walk's registers are flushed
// once at its end, not once a chunk.
template <int K, int NACC>
__global__ void __launch_bounds__(wide_threads<K>(), 1)
    grid_wide_kernel(const float2* __restrict__ vals,
                     const int* __restrict__ iu0, const int* __restrict__ iv0,
                     const float* __restrict__ frac,
                     const float4* __restrict__ ku,
                     const float2* __restrict__ kv,
                     const int* __restrict__ order,
                     const int* __restrict__ chunk_seg,
                     const int* __restrict__ chunk_start,
                     const int* __restrict__ chunk_count,
                     const float* __restrict__ tap_bound,
                     const float* __restrict__ vsum,
                     unsigned long long* __restrict__ grid64, int npix,
                     int tile, int nta, int span, int wv, int stage,
                     int nchunks, int per) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int threads = blockDim.x;
  const WideGeom gm = wide_geom(span, tile, NACC, K, threads, cs, stage);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* stg = reinterpret_cast<float4*>(smem_raw);  // [2][slots][slot]
  // [NACC][rb][ld]: rows [rank rb, (rank + 1) rb) of the tile's re_lo,
  // im_lo, re_hi, im_hi, in units of 2^-kg
  unsigned long long* acc =
      reinterpret_cast<unsigned long long*>(smem_raw + gm.stage_bytes);
  const int nb = gm.rb * gm.ld;
  const int buf = tile + span;
  const int rows = cs * gm.rb;  // the bands' rows: the tile's, or fewer

  const float total = vsum[0] * tap_bound[0];
  if (!isfinite(total)) return;  // the whole cluster leaves; the conversion writes NaN
  const int kg = grid_exponent(total);
  const double unit = ldexp(1.0, kg);
  // a sum times 2^kg is below 2^61, so it is exact in f32 as in f64 and
  // rounds to the same integer: one conversion in place of three, where
  // 2^kg is a float
  const float unitf = kg <= 127 ? ldexpf(1.f, kg) : 0.f;
  const int ntiles = nta * nta;

  // loader role: thread stages piece (threadIdx % kper) of slot
  // (threadIdx / kper): the ku row, and the kv row twice over (taps
  // kv[d mod span] at d < 2 span), by cp.async; piece 0 also loads the
  // entry's fields into registers and publishes them, in the form the walk
  // reads, before the batch's barrier. The walk order is read two batches
  // ahead, so no copy waits on it.
  const int kper = threads / gm.slots;
  const int slot = threadIdx.x / kper;
  const int piece = threadIdx.x - slot * kper;
  const bool loader = slot < gm.slots;
  const int lw = rank * gm.groups + slot / stage;
  const int half = span / 2;
  const int ntask = gm.tv + span;
  // walk role: walk g of the CTA; the thread owns the classes (a, b0 + j),
  // j < nvalid, of residue period span. Each class has exactly one cell
  // in every window: (x, rv + dy_j), x the column of class a in
  // [ru, ru + span), dy_j = (b0 + j - rv) mod span = wrap(dy0 + j).
  const int g = threadIdx.x / gm.group;
  const bool walker = g < gm.groups;
  const int r = threadIdx.x - g * gm.group;
  const int b0 = (r % gm.nbb) * K;
  const int a = r / gm.nbb;
  const int nvalid = walker ? min(K, span - b0) : 0;
  const float rinv = 1.f / gm.rb;
  auto wrap = [&](int d) { return d >= span ? d - span : d; };

  const int c1 = min(nchunks, (int)(blockIdx.x / cs + 1) * per);
  for (int c0 = (blockIdx.x / cs) * per; c0 < c1;) {
    // the run: chunks [c0, ce) of one segment, entries [start, end)
    const int seg = chunk_seg[c0];
    int ce = c0 + 1;
    while (ce < c1 && chunk_seg[ce] == seg) ++ce;
    const int rstart = chunk_start[c0];
    const int rend = chunk_start[ce - 1] + chunk_count[ce - 1];
    c0 = ce;
    const int plane = seg / ntiles;
    const int t = seg - plane * ntiles;
    const int tv0 = (t / nta) * tile;
    const int tu0 = (t % nta) * tile;
    // Where the bands hold fewer rows than the tile (large tiles), the run
    // is served in turns: the longest stretch of its entries whose windows
    // span at most the bands' rows (the walk order is by corner row), the
    // bands starting at the stretch's first row. Each turn is a run of its
    // own: its walks flush at its end, the overlap-add follows.
    for (int start = rstart, end; start < rend; start = end) {
      end = rend;
      // the turn's rows of the tile (its entries follow the walk order), the
      // bands' first row, and this CTA's band of them
      const int y0 = iv0[order[start]] - tv0;
      const int yb = rows < buf ? y0 : 0;
      if (rows < buf) {
        const int last = iv0[order[start]] + rows - span;  // the last corner row that fits
        int lo = start + 1, hi = rend;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (iv0[order[mid]] > last) hi = mid;
          else lo = mid + 1;
        }
        end = lo;
      }
      const int count = end - start;
      const int y1 = min(buf, iv0[order[end - 1]] - tv0 + span);
      const int z0 = max(y0, yb + rank * gm.rb);
      const int z1 = min(y1, yb + (rank + 1) * gm.rb);
      const int zn = max(0, z1 - z0) * gm.ld;
      __syncthreads();  // the previous run's overlap-add has read the band
      for (int i = threadIdx.x; i < NACC * zn; i += threads) {
        const int p = i / zn;
        acc[p * nb + (z0 - yb - rank * gm.rb) * gm.ld + (i - p * zn)] = 0;
      }
      // every band is zero before any CTA of the cluster adds to it
      cluster.sync();

      // walk w of the cluster's cs * groups takes [start + w q, start + (w + 1) q)
      const int walks = cs * gm.groups;
      const int q = (count + walks - 1) / walks;
      const int nbatch = (q + stage - 1) / stage;
      const int lbeg = start + lw * q + slot % stage;
      const int lend = min(start + (lw + 1) * q, end);
      auto entry_of = [&](int k) {
        const int p = lbeg + k * stage;
        return loader && p < lend ? order[p] : -1;
      };
      int e_pend = -1, u_pend = 0, v_pend = 0;
      float2 val_pend = make_float2(0.f, 0.f);
      float f_pend = 0.f;
      auto slot_of = [&](int k) {
        return stg + ((size_t)(k & 1) * gm.slots + slot) * gm.slot;
      };
      auto issue = [&](int k, int e) {
        e_pend = e;
        if (e >= 0) {
          float4* s = slot_of(k);
          float2* s2 = reinterpret_cast<float2*>(s + gm.tv);
          for (int task = piece; task < ntask; task += kper) {
            if (task < gm.tv) {
              ska_cp_async<16>(s + task, ku + (size_t)e * wv + task);
            } else {
              const int i = task - gm.tv;
              const int pair = i < half ? i : i - half;
              ska_cp_async<8>(s2 + i, kv + (size_t)e * 2 * wv + pair);
            }
          }
          if (piece == 0) {
            val_pend = vals[e];
            u_pend = iu0[e];
            v_pend = iv0[e];
            if (NACC == 4) f_pend = frac[e];
          }
        }
        ska_cp_async_commit();
      };
      // the values weighted for the lower and upper plane; the corner in the
      // tile and its residues mod span
      auto publish = [&](int k) {
        if (e_pend >= 0 && piece == 0) {
          float4* s = slot_of(k) + gm.meta;
          const float w0 = 1.f - f_pend;
          s[0] = make_float4(val_pend.x * w0, val_pend.y * w0, val_pend.x * f_pend,
                             val_pend.y * f_pend);
          const int ru = u_pend - tu0, rv = v_pend - tv0;
          reinterpret_cast<int4*>(s)[1] = make_int4(ru, rv, ru % span, rv % span);
        }
      };

      const int gbeg = start + (rank * gm.groups + g) * q;
      const int gend = min(gbeg + q, end);
      // the run's column, corner row, its dy0 and entries so far; the sums
      int curx = -1, currv = 0, dy0 = 0, since = 0;
      float sum[K][NACC];
  #pragma unroll
      for (int j = 0; j < K; ++j)
  #pragma unroll
        for (int w = 0; w < NACC; ++w) sum[j][w] = 0.f;
      // integer adds commute: the tile is the same whatever their order
      auto flush = [&](int j) {
        const int y = currv + wrap(dy0 + j) - yb;  // from the bands' first row
        const int dst = (int)(((float)y + 0.5f) * rinv);  // y / rb
        unsigned long long* p = acc + (y - dst * gm.rb) * gm.ld + curx;
  #pragma unroll
        for (int w = 0; w < NACC; ++w) {
          const long long v = unitf != 0.f ? __float2ll_rn(sum[j][w] * unitf)
                                           : __double2ll_rn((double)sum[j][w] * unit);
          if (v != 0)
            atomicAdd(cluster.map_shared_rank(p + w * nb, dst), (unsigned long long)v);
          sum[j][w] = 0.f;
        }
      };

      int e_next = entry_of(0);
      issue(0, e_next);
      e_next = entry_of(1);
      for (int k = 0; k < nbatch; ++k) {
        publish(k);
        ska_cp_async_wait_all();
        // batch k is visible; every thread is done with batch k - 1's buffer
        __syncthreads();
        if (k + 1 < nbatch) {
          issue(k + 1, e_next);
          e_next = entry_of(k + 2);
        }
        if (!walker) continue;
        const float4* sb = stg + ((size_t)(k & 1) * gm.slots + g * stage) * gm.slot;
        const int nj = min(stage, gend - (gbeg + k * stage));
        for (int jj = 0; jj < nj; ++jj) {
          const float4* rec = sb + jj * gm.slot;
          const float* tp = reinterpret_cast<const float*>(rec);
          const float4 wval = rec[gm.meta];
          const int4 cv = reinterpret_cast<const int4*>(rec)[gm.meta + 1];
          int dx = a - cv.z;
          dx += dx < 0 ? span : 0;
          const int x = cv.x + dx;
          if (x != curx || since == kRunCap) {
            // the column moved (or the runs are kRunCap long): every class's
            // cell changes
            if (curx >= 0) {
  #pragma unroll
              for (int j = 0; j < K; ++j)
                if (j < nvalid) flush(j);
            }
            curx = x;
            if (since == kRunCap) since = 0;  // every thread's runs end together
            const int d = b0 - cv.w;
            dy0 = d < 0 ? d + span : d;
            currv = cv.y;
          } else if (cv.y != currv) {
            // the corner row moved: a class's cell changes where its row does
            int d = b0 - cv.w;
            d += d < 0 ? span : 0;
  #pragma unroll
            for (int j = 0; j < K; ++j)
              if (j < nvalid && currv + wrap(dy0 + j) != cv.y + wrap(d + j)) flush(j);
            dy0 = d;
            currv = cv.y;
          }
          ++since;
          const float kx = tp[dx];
          const float lr = wval.x * kx, li = wval.y * kx;
          const float hr = wval.z * kx, hi = wval.w * kx;
          const float* kvr = tp + 4 * gm.tv + dy0;  // kv twice over: no wrap
  #pragma unroll
          for (int j = 0; j < K; ++j) {
            const float ky = kvr[j];
            sum[j][0] = fmaf(ky, lr, sum[j][0]);
            sum[j][1] = fmaf(ky, li, sum[j][1]);
            if (NACC == 4) {
              sum[j][2] = fmaf(ky, hr, sum[j][2]);
              sum[j][3] = fmaf(ky, hi, sum[j][3]);
            }
          }
        }
      }
      if (curx >= 0) {
  #pragma unroll
        for (int j = 0; j < K; ++j)
          if (j < nvalid) flush(j);
      }
      // every CTA's adds to this band are done
      cluster.sync();

      // overlap-add of the band, as grid_kernel's
      for (int i = threadIdx.x; i < (z1 - z0) * buf; i += threads) {
        const int y = z0 + i / buf;
        const int x = i - (y - z0) * buf;
        const int gy = tv0 + y;
        const int gx = tu0 + x;
        if (gy >= npix || gx >= npix) continue;
        const int cc = (y - yb - rank * gm.rb) * gm.ld + x;
  #pragma unroll
        for (int p = 0; p < NACC / 2; ++p) {
          const unsigned long long re = acc[2 * p * nb + cc];
          const unsigned long long im = acc[(2 * p + 1) * nb + cc];
          if (re != 0 || im != 0) {
            unsigned long long* gp =
                grid64 + 2 * (((size_t)(plane + p) * npix + gy) * npix + gx);
            atomicAdd(gp, re);
            atomicAdd(gp + 1, im);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The device-memory route: windows of any span on tiles of any size.

constexpr int kDevWaves = 16;  // about this many device-route CTAs an SM serves

// Launch geometry of the device-memory route at window span `span` (even)
struct DevGeom {
  int k;        // classes a thread owns: k consecutive rows of one column
  int threads;  // of a CTA
  int nbb;      // row blocks of a column
  int group;    // threads of one walk: span columns times nbb row blocks
  int groups;   // walks of a CTA (1 where a walk takes several CTAs)
  int nsl;      // CTAs of one walk: its classes in slices of `threads`
  int stage;    // entries a walk stages a batch
  int tv;       // float4s of a staged tap row (span taps, zero past)
  int slot;     // float4s of one staged entry: ku, kv, then two of fields
  int slots;    // entries a CTA stages a batch
  size_t smem;  // two batches
};

__host__ __device__ inline DevGeom dev_geom(int span, int k, int threads, int stage) {
  DevGeom g;
  g.k = k;
  g.threads = threads;
  g.nbb = (span + k - 1) / k;
  g.group = span * g.nbb;
  g.groups = g.group <= threads ? threads / g.group : 1;
  g.nsl = (g.group + threads - 1) / threads;
  g.stage = stage;
  g.tv = (span + 3) / 4;
  g.slot = 2 * g.tv + 2;
  g.slots = g.groups * stage;
  g.smem = 2 * (size_t)g.slots * g.slot * sizeof(float4);
  return g;
}

// The wide variant's classes a thread and threads a CTA up to a span of
// 64, 8 rows a thread and 768 threads past it; the largest batch (32
// entries a walk down to 1) with at most one staged entry a thread that
// fits a block's shared memory. threads 0 where no batch fits (spans past
// 14,524 cells).
inline DevGeom dev_plan(int span) {
  int k = 8, threads = wide_threads<8>();
  if (span <= 64) wide_choice(span, k, threads);
  for (int stage = 32; stage >= 1; stage /= 2) {
    const DevGeom g = dev_geom(span, k, threads, stage);
    if (g.slots <= g.threads && g.smem <= kMaxSmem) return g;
  }
  DevGeom g = dev_geom(span, k, threads, 1);
  g.threads = 0;
  return g;
}

// K classes a thread, NACC as grid_kernel's; wv: float4s of a stored tap
// row (tap_vecs). CTA (x, y) serves slice y of the classes of the chunks
// [per x, per (x + 1)), one run of consecutive chunks of one segment at a
// time, and adds each register run to grid64 in device memory.
template <int K, int NACC>
__global__ void __launch_bounds__(wide_threads<K>(), 1)
    grid_dev_kernel(const float2* __restrict__ vals,
                    const int* __restrict__ iu0, const int* __restrict__ iv0,
                    const float* __restrict__ frac,
                    const float4* __restrict__ ku,
                    const float4* __restrict__ kv,
                    const int* __restrict__ order,
                    const int* __restrict__ chunk_seg,
                    const int* __restrict__ chunk_start,
                    const int* __restrict__ chunk_count,
                    const float* __restrict__ tap_bound,
                    const float* __restrict__ vsum,
                    unsigned long long* __restrict__ grid64, int npix, int nta,
                    int span, int wv, int stage, int nchunks, int per) {
  const int threads = blockDim.x;
  const DevGeom gm = dev_geom(span, K, threads, stage);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* stg = reinterpret_cast<float4*>(smem_raw);  // [2][slots][slot]

  const float total = vsum[0] * tap_bound[0];
  if (!isfinite(total)) return;  // the conversion writes NaN
  const int kg = grid_exponent(total);
  const double unit = ldexp(1.0, kg);
  const float unitf = kg <= 127 ? ldexpf(1.f, kg) : 0.f;  // as the wide variant's
  const int ntiles = nta * nta;
  const size_t plane_words = 2 * (size_t)npix * npix;

  // loader role: thread stages piece (threadIdx % kper) of slot
  // (threadIdx / kper), the ku and kv rows by cp.async; piece 0 loads the
  // entry's fields into registers and publishes them before the batch's
  // barrier
  const int kper = threads / gm.slots;
  const int slot = threadIdx.x / kper;
  const int piece = threadIdx.x - slot * kper;
  const bool loader = slot < gm.slots;
  const int lw = slot / stage;
  const int ntask = 2 * gm.tv;
  // walk role: walk g of the CTA, class slot r of the walk; the thread owns
  // the classes (a, b0 + j), j < nvalid, of residue period span. Each class
  // has exactly one cell in every window: (iu0 + ((a - iu0) mod span),
  // iv0 + dy_j), dy_j = (b0 + j - iv0) mod span = wrap(dy0 + j).
  const int g = gm.nsl > 1 ? 0 : threadIdx.x / gm.group;
  const int r = gm.nsl > 1 ? (int)blockIdx.y * threads + threadIdx.x
                           : threadIdx.x - g * gm.group;
  const bool walker = gm.nsl > 1 ? r < gm.group : g < gm.groups;
  const int a = r / gm.nbb;
  const int b0 = (r - a * gm.nbb) * K;
  const int nvalid = walker ? min(K, span - b0) : 0;
  auto wrap = [&](int d) { return d >= span ? d - span : d; };

  const int c1 = min(nchunks, (int)(blockIdx.x + 1) * per);
  for (int c0 = (int)blockIdx.x * per; c0 < c1;) {
    // the run: chunks [c0, ce) of one segment, entries [start, end)
    const int seg = chunk_seg[c0];
    int ce = c0 + 1;
    while (ce < c1 && chunk_seg[ce] == seg) ++ce;
    const int start = chunk_start[c0];
    const int end = chunk_start[ce - 1] + chunk_count[ce - 1];
    c0 = ce;
    unsigned long long* gp0 = grid64 + (size_t)(seg / ntiles) * plane_words;
    __syncthreads();  // every thread is done with the previous run's batches

    // walk w of the CTA's groups takes [start + w q, start + (w + 1) q)
    const int q = (end - start + gm.groups - 1) / gm.groups;
    const int nbatch = (q + stage - 1) / stage;
    const int lbeg = start + lw * q + slot % stage;
    const int lend = min(start + (lw + 1) * q, end);
    auto entry_of = [&](int k) {
      const int p = lbeg + k * stage;
      return loader && p < lend ? order[p] : -1;
    };
    int e_pend = -1, u_pend = 0, v_pend = 0;
    float2 val_pend = make_float2(0.f, 0.f);
    float f_pend = 0.f;
    auto slot_of = [&](int k) {
      return stg + ((size_t)(k & 1) * gm.slots + slot) * gm.slot;
    };
    auto issue = [&](int k, int e) {
      e_pend = e;
      if (e >= 0) {
        float4* s = slot_of(k);
        for (int task = piece; task < ntask; task += kper) {
          if (task < gm.tv)
            ska_cp_async<16>(s + task, ku + (size_t)e * wv + task);
          else
            ska_cp_async<16>(s + task, kv + (size_t)e * wv + (task - gm.tv));
        }
        if (piece == 0) {
          val_pend = vals[e];
          u_pend = iu0[e];
          v_pend = iv0[e];
          if (NACC == 4) f_pend = frac[e];
        }
      }
      ska_cp_async_commit();
    };
    // the values weighted for the lower and upper plane; the corner and its
    // residues mod span
    auto publish = [&](int k) {
      if (e_pend >= 0 && piece == 0) {
        float4* s = slot_of(k) + 2 * gm.tv;
        const float w0 = 1.f - f_pend;
        s[0] = make_float4(val_pend.x * w0, val_pend.y * w0, val_pend.x * f_pend,
                           val_pend.y * f_pend);
        reinterpret_cast<int4*>(s)[1] =
            make_int4(u_pend, v_pend, u_pend % span, v_pend % span);
      }
    };

    const int gbeg = start + g * q;
    const int gend = min(gbeg + q, end);
    // the run's column, corner row, its dy0 and entries so far; the sums
    int curx = -1, currv = 0, dy0 = 0, since = 0;
    float sum[K][NACC];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int w = 0; w < NACC; ++w) sum[j][w] = 0.f;
    // integer adds commute: the grid is the same whatever their order
    auto flush = [&](int j) {
      unsigned long long* p = gp0 + 2 * ((size_t)(currv + wrap(dy0 + j)) * npix + curx);
#pragma unroll
      for (int w = 0; w < NACC; ++w) {
        const long long v = unitf != 0.f ? __float2ll_rn(sum[j][w] * unitf)
                                         : __double2ll_rn((double)sum[j][w] * unit);
        if (v != 0) atomicAdd(p + (w & 1) + (w >> 1) * plane_words, (unsigned long long)v);
        sum[j][w] = 0.f;
      }
    };

    int e_next = entry_of(0);
    issue(0, e_next);
    e_next = entry_of(1);
    for (int k = 0; k < nbatch; ++k) {
      publish(k);
      ska_cp_async_wait_all();
      // batch k is visible; every thread is done with batch k - 1's buffer
      __syncthreads();
      if (k + 1 < nbatch) {
        issue(k + 1, e_next);
        e_next = entry_of(k + 2);
      }
      if (!walker) continue;
      const float4* sb = stg + ((size_t)(k & 1) * gm.slots + g * stage) * gm.slot;
      const int nj = min(stage, gend - (gbeg + k * stage));
      for (int jj = 0; jj < nj; ++jj) {
        const float4* rec = sb + jj * gm.slot;
        const float* tp = reinterpret_cast<const float*>(rec);
        const float4 wval = rec[2 * gm.tv];
        const int4 cv = reinterpret_cast<const int4*>(rec)[2 * gm.tv + 1];
        int dx = a - cv.z;
        dx += dx < 0 ? span : 0;
        const int x = cv.x + dx;
        if (x != curx || since == kRunCap) {
          // the column moved (or the runs are kRunCap long): every class's
          // cell changes
          if (curx >= 0) {
#pragma unroll
            for (int j = 0; j < K; ++j)
              if (j < nvalid) flush(j);
          }
          curx = x;
          if (since == kRunCap) since = 0;  // every thread's runs end together
          const int d = b0 - cv.w;
          dy0 = d < 0 ? d + span : d;
          currv = cv.y;
        } else if (cv.y != currv) {
          // the corner row moved: a class's cell changes where its row does
          int d = b0 - cv.w;
          d += d < 0 ? span : 0;
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (j < nvalid && currv + wrap(dy0 + j) != cv.y + wrap(d + j)) flush(j);
          dy0 = d;
          currv = cv.y;
        }
        ++since;
        const float kx = tp[dx];
        const float lr = wval.x * kx, li = wval.y * kx;
        const float hr = wval.z * kx, hi = wval.w * kx;
        const float* kvr = tp + 4 * gm.tv;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float ky = kvr[wrap(dy0 + j)];
          sum[j][0] = fmaf(ky, lr, sum[j][0]);
          sum[j][1] = fmaf(ky, li, sum[j][1]);
          if (NACC == 4) {
            sum[j][2] = fmaf(ky, hr, sum[j][2]);
            sum[j][3] = fmaf(ky, hi, sum[j][3]);
          }
        }
      }
    }
    if (curx >= 0) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < nvalid) flush(j);
    }
  }
}

// The complex64 grids from the int64 ones: value times 2^-kg, or NaN when
// the bound is not finite.
__global__ void grid_convert(const long long* __restrict__ grid64,
                             float* __restrict__ grid, size_t n,
                             const float* __restrict__ tap_bound,
                             const float* __restrict__ vsum) {
  const float total = vsum[0] * tap_bound[0];
  const bool ok = isfinite(total);
  const double unit = ok ? ldexp(1.0, -grid_exponent(total)) : 0.0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    grid[i] = ok ? (float)((double)grid64[i] * unit) : __int_as_float(0x7fc00000);
}

// The narrow kernel's dynamic shared memory at window span `span` (16 or
// less: residue period 8 up to 8, else 16) on tiles of `tile` cells, the
// tile's rows `ld` words apart
inline size_t narrow_smem(int span, int tile, int nacc, int ld) {
  const size_t stage = span > 8 ? sizeof(Stage<16>) : sizeof(Stage<8>);
  return 2 * stage + (size_t)nacc * (tile + span) * ld * sizeof(long long);
}

template <int P, int NACC, bool kFull>
int launch(const void* vals, const void* iu0, const void* iv0,
           const void* frac, const void* ku, const void* kv, const void* order,
           const void* chunk_seg, const void* chunk_start,
           const void* chunk_count, const void* tap_bound, const void* vsum,
           void* grid64, int nchunks, int npix, int tile, int nta, int support,
           cudaStream_t s) {
  const int buf = tile + support;
  int ld = tile_ld(buf);
  // unpadded rows: bank conflicts only
  if (narrow_smem(support, tile, NACC, ld) > kMaxSmem) ld = buf;
  const size_t smem = narrow_smem(support, tile, NACC, ld);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // tile too large
  cudaFuncSetAttribute(grid_kernel<P, NACC, kFull>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(grid_kernel<P, NACC, kFull>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  grid_kernel<P, NACC, kFull><<<nchunks, kThreads, smem, s>>>(
      (const float2*)vals, (const int*)iu0, (const int*)iv0,
      (const float*)frac, (const float4*)ku, (const float4*)kv,
      (const int*)order, (const int*)chunk_seg, (const int*)chunk_start,
      (const int*)chunk_count, (const float*)tap_bound, (const float*)vsum,
      (unsigned long long*)grid64, npix, tile, nta, support, ld);
  return ska_last_error();
}

template <int K, int NACC>
int launch_wide_k(const WideGeom& gm, const void* vals, const void* iu0,
                  const void* iv0, const void* frac, const void* ku,
                  const void* kv, const void* order, const void* chunk_seg,
                  const void* chunk_start, const void* chunk_count,
                  const void* tap_bound, const void* vsum, void* grid64,
                  int nchunks, int npix, int tile, int nta, int span,
                  cudaStream_t s) {
  auto fn = grid_wide_kernel<K, NACC>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gm.smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = gm.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // chunks a cluster: enough clusters for about kWideWaves of them on
  // every SM, each walking runs of as many entries as that leaves
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int per = max(1, nchunks * gm.cs / (sms * kWideWaves));
  const int nclusters = (nchunks + per - 1) / per;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nclusters * gm.cs));
  cfg.blockDim = dim3(gm.threads);
  cfg.dynamicSmemBytes = gm.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot place fails the launch loudly
  int resident = 0;
  e = cudaOccupancyMaxActiveClusters(&resident, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, fn, (const float2*)vals, (const int*)iu0,
                         (const int*)iv0, (const float*)frac, (const float4*)ku,
                         (const float2*)kv, (const int*)order,
                         (const int*)chunk_seg, (const int*)chunk_start,
                         (const int*)chunk_count, (const float*)tap_bound,
                         (const float*)vsum, (unsigned long long*)grid64, npix,
                         tile, nta, span, tap_vecs(span), gm.stage, nchunks, per);
  if (e != cudaSuccess) return (int)e;
  return ska_last_error();
}

template <int NACC>
int launch_wide(const void* vals, const void* iu0, const void* iv0,
                const void* frac, const void* ku, const void* kv,
                const void* order, const void* chunk_seg,
                const void* chunk_start, const void* chunk_count,
                const void* tap_bound, const void* vsum, void* grid64,
                int nchunks, int npix, int tile, int nta, int span,
                cudaStream_t s) {
  const WideGeom gm = wide_plan(span, tile, NACC);
  if (gm.cs == 0) return (int)cudaErrorInvalidValue;  // no cluster holds the tile
#define SKA_GRID_WIDE_K(K)                                                     \
  launch_wide_k<K, NACC>(gm, vals, iu0, iv0, frac, ku, kv, order, chunk_seg,  \
                         chunk_start, chunk_count, tap_bound, vsum, grid64,   \
                         nchunks, npix, tile, nta, span, s)
  switch (gm.k) {
    case 8: return SKA_GRID_WIDE_K(8);
    case 6: return SKA_GRID_WIDE_K(6);
    case 4: return SKA_GRID_WIDE_K(4);
    default: return SKA_GRID_WIDE_K(2);
  }
#undef SKA_GRID_WIDE_K
}

template <int K, int NACC>
int launch_dev_k(const DevGeom& gm, const void* vals, const void* iu0,
                 const void* iv0, const void* frac, const void* ku,
                 const void* kv, const void* order, const void* chunk_seg,
                 const void* chunk_start, const void* chunk_count,
                 const void* tap_bound, const void* vsum, void* grid64,
                 int nchunks, int npix, int nta, int span, cudaStream_t s) {
  auto fn = grid_dev_kernel<K, NACC>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gm.smem);
  if (e != cudaSuccess) return (int)e;
  // chunks a CTA: about kDevWaves CTAs an SM over the launch, each walking
  // runs of as many entries as that leaves
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int per = max(1, (int)((long long)nchunks * gm.nsl / ((long long)sms * kDevWaves)));
  const int nblocks = (nchunks + per - 1) / per;
  fn<<<dim3((unsigned)nblocks, (unsigned)gm.nsl), gm.threads, gm.smem, s>>>(
      (const float2*)vals, (const int*)iu0, (const int*)iv0, (const float*)frac,
      (const float4*)ku, (const float4*)kv, (const int*)order, (const int*)chunk_seg,
      (const int*)chunk_start, (const int*)chunk_count, (const float*)tap_bound,
      (const float*)vsum, (unsigned long long*)grid64, npix, nta, span, tap_vecs(span),
      gm.stage, nchunks, per);
  return ska_last_error();
}

template <int NACC>
int launch_dev(const void* vals, const void* iu0, const void* iv0,
               const void* frac, const void* ku, const void* kv,
               const void* order, const void* chunk_seg, const void* chunk_start,
               const void* chunk_count, const void* tap_bound, const void* vsum,
               void* grid64, int nchunks, int npix, int nta, int span,
               cudaStream_t s) {
  const DevGeom gm = dev_plan(span);
  if (gm.threads == 0) return (int)cudaErrorInvalidValue;  // no batch fits
#define SKA_GRID_DEV_K(K)                                                     \
  launch_dev_k<K, NACC>(gm, vals, iu0, iv0, frac, ku, kv, order, chunk_seg,  \
                        chunk_start, chunk_count, tap_bound, vsum, grid64,   \
                        nchunks, npix, nta, span, s)
  switch (gm.k) {
    case 8: return SKA_GRID_DEV_K(8);
    case 6: return SKA_GRID_DEV_K(6);
    case 4: return SKA_GRID_DEV_K(4);
    default: return SKA_GRID_DEV_K(2);
  }
#undef SKA_GRID_DEV_K
}

// How ska_grid serves windows of `span` cells on tiles of `tile` cells
// (nacc as ska_grid's): 0 it refuses them; 1 the narrow kernel (16 cells
// or fewer, the whole tile in one block); 2 the wide kernel, the whole
// tile in its cluster's bands; 3 the wide kernel in turns (its bands hold
// fewer rows than the tile's, at least one window's); 4 the device-memory
// route (windows past 64 cells, and tiles no cluster's bands serve).
inline int grid_route(int span, int tile, int nacc) {
  if (span < 1 || tile < 1) return 0;
  if (span <= 16 && narrow_smem(span, tile, nacc, tile + span) <= kMaxSmem) return 1;
  if (span % 2 || span > tile) return 0;
  if (span <= 64) {
    const WideGeom g = wide_plan(span, tile, nacc);
    if (g.cs != 0) return g.cs * g.rb >= tile + span ? 2 : 3;
  }
  return dev_plan(span).threads ? 4 : 0;
}

}  // namespace

// vals [n] complex64; iu0, iv0, order [n] int32; frac [n] f32; ku, kv
// [n, P] f32 (P = 8, 16, 32 or 64, the power of two from 8 up that holds
// the window; past a window of 64 cells the span rounded up to a multiple
// of 8), 16-byte aligned; chunk_*: [nchunks] int32; tap_bound [1] f32, the plan's; vsum
// [1] f32, the sum of |re| + |im| over vals; grid64 [nplanes, npix, npix,
// 2] int64 scratch; grid [nplanes, npix, npix] complex64 out. nacc 4:
// linear w-stacking (plane pairs); 2: one plane a segment (single-plane or
// nearest-plane plans).
//
// The sharded invert passes grid NULL: the int64 planes in grid64 are the
// result, and ska_grid_convert writes the complex64 grids from their sum
// over the shards. Every shard's launch then takes the global bound: vsum
// the sum of the shards' vsums, tap_bound the largest of their plans'.
// The sum cannot overflow: each shard's cells are bounded by its own vsum
// times its plan's tap bound, so their sum is bounded by the global
// vsum times the largest tap bound, the global bound, and 2^(61 - kg)
// exceeds that (with 2 bits to spare below int64's 2^63).
SKA_EXPORT int ska_grid(const void* vals, const void* iu0, const void* iv0,
                        const void* frac, const void* ku, const void* kv,
                        const void* order, const void* chunk_seg,
                        const void* chunk_start, const void* chunk_count,
                        const void* tap_bound, const void* vsum, void* grid64,
                        void* grid, int nchunks, int nplanes, int npix,
                        int tile, int nta, int support, int nacc,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t n = 2 * (size_t)nplanes * npix * npix;
  const int route = grid_route(support, tile, nacc);
  if (route == 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaMemsetAsync(grid64, 0, n * sizeof(long long), s);
  if (nchunks > 0) {
#define SKA_GRID_LAUNCH(P, NACC, FULL)                                        \
  launch<P, NACC, FULL>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,     \
                        chunk_start, chunk_count, tap_bound, vsum, grid64,  \
                        nchunks, npix, tile, nta, support, s)
    const bool four = nacc == 4;
    int rc;
    if (route == 4)
      rc = four ? launch_dev<4>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                                chunk_start, chunk_count, tap_bound, vsum, grid64,
                                nchunks, npix, nta, support, s)
                : launch_dev<2>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                                chunk_start, chunk_count, tap_bound, vsum, grid64,
                                nchunks, npix, nta, support, s);
    else if (route > 1)
      rc = four ? launch_wide<4>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                                 chunk_start, chunk_count, tap_bound, vsum,
                                 grid64, nchunks, npix, tile, nta, support, s)
                : launch_wide<2>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                                 chunk_start, chunk_count, tap_bound, vsum,
                                 grid64, nchunks, npix, tile, nta, support, s);
    else if (support == 8)
      rc = four ? SKA_GRID_LAUNCH(8, 4, true) : SKA_GRID_LAUNCH(8, 2, true);
    else if (support < 8)
      rc = four ? SKA_GRID_LAUNCH(8, 4, false) : SKA_GRID_LAUNCH(8, 2, false);
    else if (support == 16)
      rc = four ? SKA_GRID_LAUNCH(16, 4, true) : SKA_GRID_LAUNCH(16, 2, true);
    else
      rc = four ? SKA_GRID_LAUNCH(16, 4, false) : SKA_GRID_LAUNCH(16, 2, false);
#undef SKA_GRID_LAUNCH
    if (rc != 0) return rc;
  }
  if (grid == nullptr) return ska_last_error();
  const size_t blocks = min((n + 255) / 256, (size_t)65536);
  grid_convert<<<(unsigned)blocks, 256, 0, s>>>(
      (const long long*)grid64, (float*)grid, n, (const float*)tap_bound,
      (const float*)vsum);
  return ska_last_error();
}

// The wide variant's launch geometry at window span `span` (even, 2 to
// 64; at 16 or less it runs where ska_grid_route says 2 or 3) on
// tiles of `tile` cells, nacc as ska_grid's: what 0 the CTAs of a cluster,
// 1 the threads of a CTA, 2 its dynamic shared bytes, 3 its walks, 4 the
// classes a thread owns, 5 the entries a walk stages a batch, 6 the tile
// rows the cluster's bands hold (fewer than tile + span: runs in turns);
// 0 where the bands cannot hold one window (ska_grid refuses the tile).
SKA_EXPORT int ska_grid_wide_geometry(int span, int tile, int nacc, int what) {
  const WideGeom gm = wide_plan(span, tile, nacc);
  if (gm.cs == 0) return 0;
  const int v[] = {gm.cs, gm.threads, (int)gm.smem, gm.groups, gm.k, gm.stage,
                   gm.cs * gm.rb};
  return what >= 0 && what < 7 ? v[what] : 0;
}

// How ska_grid serves windows of `span` cells on tiles of `tile` cells
// (nacc as ska_grid's), decided before any launch: 0 refused (an odd span,
// or one past the tile), 1 the narrow kernel, 2 the wide kernel holding
// the whole tile, 3 the wide kernel in turns, 4 the device-memory route.
SKA_EXPORT int ska_grid_route(int span, int tile, int nacc) {
  return grid_route(span, tile, nacc);
}

// The device-memory route's launch geometry at window span `span` (even;
// it runs where ska_grid_route says 4): what 0 the threads of a CTA, 1 its
// dynamic shared bytes, 2 its walks, 3 the classes a thread owns, 4 the
// entries a walk stages a batch, 5 the CTAs (slices) of one walk; 0 past
// them.
SKA_EXPORT int ska_grid_dev_geometry(int span, int what) {
  if (span < 2 || span % 2) return 0;
  const DevGeom gm = dev_plan(span);
  const int v[] = {gm.threads, (int)gm.smem, gm.groups, gm.k, gm.stage, gm.nsl};
  return gm.threads && what >= 0 && what < 6 ? v[what] : 0;
}

// The complex64 grids from int64 ones (n floats: 2 a cell) summed over
// shards that gridded with the same bound (tap_bound, vsum as ska_grid's).
SKA_EXPORT int ska_grid_convert(const void* grid64, void* grid, long long n,
                                const void* tap_bound, const void* vsum,
                                void* stream) {
  if (n <= 0) return 0;
  const size_t blocks = min(((size_t)n + 255) / 256, (size_t)65536);
  grid_convert<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)grid64, (float*)grid, (size_t)n,
      (const float*)tap_bound, (const float*)vsum);
  return ska_last_error();
}
