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
// a linear plan) takes route 4 below. Every flush is a 64-bit atomic add
// on the cluster address, which the card performs in one instruction, where the same add
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
// at span 64), take route 4, grid_band_kernel. It replaces a walk that
// added every register run straight into grid64 in device memory (one
// 64-bit atomic a value word, four a cell on a linear plan) and, past a
// span of 64, staged a batch's tap rows again on every slice of a walk.
// Here the wide variant's walk and flushes run on sub-tiles of the tile,
// tr rows by tc columns of window corners (64 columns, 128 past a span of
// 64), whose cells and halo a cluster holds in shared int64, NACC words a
// cell, in bands of rows: a segment's walk order follows the window
// corner row by row, so a sub-tile's entries are one stretch of the run
// on each corner row, found by binary search on iv0[order[p]] and
// iu0[order[p]], and every entry is walked once. Each CTA stages its walks'
// batches as the wide variant does (ku, kv twice over, by cp.async, the
// walk order read two batches ahead, so that no copy waits); past a span
// of 64 a walk of span x ceil(span / 8) classes is sliced over 2 to 8 CTAs
// of the cluster, each staging the batch itself from L2 (a first version
// staged it once and wrote it into the walk's CTAs through distributed
// shared memory, a cluster barrier a batch: its copies waited on the
// loads, half its time on the flagship's stream). Past 8 CTAs' threads a
// walk takes its classes in passes. Flushes are adds on the cluster
// address and each sub-tile goes into grid64 once, in one overlap-add, so
// the sums stay order-free and two launches give the same bits.
// Where no cluster holds a sub-tile of 16 corner rows whole (past a span
// of about 240 on a linear plan, 340 on one plane) the held cells go in
// blocks over 8 CTAs (band_clip), each CTA's rows of a block its own and
// each of their cells one thread's: every CTA walks the entries whose
// windows meet the block's rows, their tap rows copied over its rows and
// the block's columns (zero outside the window), so each entry adds only
// the cells of its window inside the block, and a thread adds its cells'
// sums to its own shared words every kRunCap entries; each block goes
// into grid64 in its own overlap-add. ska_grid_band_geometry reports the
// launch geometry.
//
// What bounds route 4 (NVIDIA H100 80GB HBM3, 700 W; wide_designs.py
// --phase18, PERF.md): 6.6-6.9 times its bound on the flagship's whole
// stream on one tile of 1344 at spans 48 and 64, 8.8-15.4 times on its
// first million entries past 64, and 1.00-1.03 and 1.2-1.5 times the time
// of the device-memory walk it replaced there. With the walk compiled out
// a copy keeps 36-37% of the launch on the whole stream and 27-38% on the
// subset: the staging, the sub-tiles' searches, barriers and zeroing, and
// the overlap-add of each sub-tile's halo, span - 1 rows and columns
// around tr x tc corners. A cluster's run is a thin strip of a tile that
// wide (a few corner rows across its width), so its sub-tiles are short
// and their halos overlap the neighbouring runs': most of those cells go
// into grid64 several times, where the device-memory walk added each run
// once. Fewer, longer runs (2 or 4 clusters an SM's worth of chunks in
// place of 16) were slower still, and 32 or 64 no faster.
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
// Route 4: windows past 64 cells, and tiles of which no cluster's bands
// hold one window's rows.

constexpr int kBandWaves = 16;  // about this many route-4 clusters an SM serves

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Launch geometry of route 4 at window span `span` (even) on tiles of
// `tile` cells, `nacc` words a cell. Whole: the walks (Romein's, at residue
// period span; a walk's classes in slices over nsl CTAs where they outgrow
// one) and the int64 cells of a sub-tile of tr x tc window corners and its
// halo, held in bands of rows by the cs CTAs of a cluster. Clipped
// (band_clip): the held cells in blocks of hb rows by wb columns, each CTA
// rb rows of a block, a thread k rows of one of its columns.
struct BandGeom {
  int k;        // rows of one column a thread owns
  int threads;  // of a CTA (0: no geometry fits)
  int nbb;      // row blocks of a column: ceil(span / k)
  int group;    // classes of one walk: span columns times nbb row blocks
  int nsl;      // CTAs of one walk (1, 2, 4 or 8), each a slice of its classes
  int walks;    // walks of a CTA (1 where a walk takes several CTAs)
  int npass;    // passes of a walk's threads over its classes (past 8 CTAs' threads)
  int stage;    // entries a walk takes a batch
  int slots;    // entries a CTA stages a batch: its walks' batches
  int tv;       // float4s of a staged ku row (span taps)
  int slot;     // float4s of one staged entry: ku, kv twice over, two of fields
  int cs;       // CTAs of a cluster: each holds a band of rb rows of the sub-tile
  int tr, tc;   // window corners of a sub-tile: rows and columns
  int rows;     // rows of a sub-tile held: tr + span - 1
  int rb;
  int ld;       // words of a held row of one accumulator, odd
  size_t red, seg, acc, smem;  // byte offsets of the arrays; total
};

// The clipped form (band_clip), where the cluster's bands hold fewer rows
// than a sub-tile's, cs rb < rows: the held cells in blocks of cs rb rows by
// ld - 1 columns, a slot's taps the kv of a CTA's rb rows (a multiple of 8)
// and the ku of the block's columns. (Kept out of BandGeom's fields, which
// are the kernel's parameters: more of them slowed the whole form's
// launches of K9's band kernel by up to 7%.)
__host__ __device__ inline bool band_clipped(const BandGeom& g) { return g.cs * g.rb < g.rows; }

// The whole form: the sub-tile's held cells whole over the cluster
inline BandGeom band_geom(int span, int nacc, int k, int threads, int nsl, int cs, int stage,
                          int tr, int tc) {
  BandGeom g;
  g.k = k;
  g.threads = threads;
  g.nbb = (span + k - 1) / k;
  g.group = span * g.nbb;
  g.nsl = nsl;
  g.walks = nsl > 1 ? 1 : threads / g.group;
  g.npass = nsl > 1 ? (g.group + nsl * threads - 1) / (nsl * threads) : 1;
  g.stage = stage;
  g.slots = g.walks * stage;
  g.tv = (span + 3) / 4;
  g.slot = g.tv + span / 2 + 2;
  g.cs = cs;
  g.tr = tr;
  g.tc = tc;
  g.rows = tr + span - 1;
  g.rb = (g.rows + cs - 1) / cs;
  g.ld = (tc + span - 1) | 1;
  // staged entries [2][slots][slot] float4; red [3] int; seg [5][tr + 1]
  // int (per corner row: its first entry in the sub-tile, the prefix of
  // their counts, its first entry not yet served, its end, the corner
  // column of that entry); acc [nacc][rb][ld] int64
  g.red = 2 * (size_t)g.slots * g.slot * sizeof(float4);
  g.seg = g.red + 16;
  g.acc = align16(g.seg + 5 * (size_t)(tr + 1) * sizeof(int));
  g.smem = g.acc + (size_t)nacc * g.ld * sizeof(long long) * g.rb;
  return g;
}

// The most window corner rows (up to the tile) of a sub-tile of tc columns
// that cs CTAs hold whole beside their staging; threads 0 where not one, or
// where a batch stages more entries than a CTA has threads
inline BandGeom band_rows(int span, int tile, int nacc, int k, int threads, int nsl, int cs,
                          int stage, int tc) {
  int lo = 0, hi = tile;  // the smem grows with tr
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (band_geom(span, nacc, k, threads, nsl, cs, stage, mid, tc).smem <= kMaxSmem)
      lo = mid;
    else
      hi = mid - 1;
  }
  BandGeom g = band_geom(span, nacc, k, threads, nsl, cs, stage, lo > 0 ? lo : 1, tc);
  if (lo == 0 || g.slots > g.threads) g.threads = 0;
  return g;
}

// The clipped form, where no cluster holds a sub-tile of 16 corner rows
// whole (past a span of about 240 on a linear plan, 340 on one plane):
// sub-tiles of min(tile, 2 span, 1024) corners a side whose held cells 8
// CTAs serve in blocks, each CTA rb = 8 nbk rows of a block by wb columns,
// a thread 8 rows of one column (wb nbk threads of 768 at most); nbk the
// row blocks nearest to a square block, then the widest wb (multiples of
// 32) with batches of 16 or 8 entries, then smaller batches. threads 0
// where none fits.
inline BandGeom band_clip(int span, int tile, int nacc) {
  const int most = wide_threads<8>();
  const int t = min(min(tile, 2 * span), 1024);
  int nbk = 1;
  while ((nbk + 1) * (nbk + 1) * 64 <= most) ++nbk;
  BandGeom g = band_geom(span, nacc, 8, most, 1, 8, 1, t, t);
  g.nsl = g.walks = g.npass = 1;
  g.group = most;
  for (; nbk >= 1; --nbk)
    for (const int least : {8, 1})
      for (int wb = most / nbk / 32 * 32; wb >= 32; wb -= 32)
        for (int stage = 16; stage >= least; stage /= 2) {
          g.threads = nbk * wb;
          g.stage = g.slots = stage;
          g.rb = 8 * nbk;
          g.ld = wb | 1;  // wb even
          if (!band_clipped(g)) continue;  // the whole form serves such a sub-tile
          // taps [2][stage][kv rows, ku columns] f32, values [2][stage]
          // float4; red, seg, acc as the whole form's
          g.red = 2 * (size_t)stage * ((g.rb + wb) * sizeof(float) + sizeof(float4));
          g.seg = g.red + 16;
          g.acc = align16(g.seg + 5 * (size_t)(t + 1) * sizeof(int));
          g.smem = g.acc + (size_t)nacc * g.ld * sizeof(long long) * g.rb;
          if (g.smem <= kMaxSmem) return g;
        }
  g.threads = 0;
  return g;
}

// Rows a thread and threads a CTA: the wide variant's choice up to a span
// of 64; past it 8 rows a thread and a walk's classes over the fewest CTAs
// (1, 2, 4 or 8) of at most 768 threads, further passes past 8. Sub-tiles
// of 64 corner columns (128 past a span of 64; the tile where it is
// narrower) and the least cluster whose CTAs hold 32 corner rows (the
// tile's where fewer) whole beside batches of 16, 32 or 8 entries a walk,
// with the most rows it holds; failing that 8 CTAs and the most rows
// beside batches of 8 or 4, on narrower sub-tiles if need be, while they
// hold 16 corner rows (the tile's where fewer); failing that the clipped
// form (band_clip).
inline BandGeom band_plan(int span, int tile, int nacc) {
  int k = 8, threads = wide_threads<8>(), nsl = 1;
  if (span <= 64) {
    wide_choice(span, k, threads);
  } else {
    const int group = span * ((span + 7) / 8);
    while (nsl < 8 && group > nsl * threads) nsl *= 2;
    threads = min(threads, ((group + nsl - 1) / nsl + 31) / 32 * 32);
  }
  const int tc = min(tile, span <= 64 ? 64 : 128);
  const int want = min(tile, 32);
  constexpr int kStages[] = {16, 32, 8};
  for (int cs = nsl; cs <= 8; cs *= 2)
    for (const int stage : kStages) {
      const BandGeom g = band_rows(span, tile, nacc, k, threads, nsl, cs, stage, tc);
      if (g.threads && g.tr >= want) return g;
    }
  for (int c = tc; c >= 1; c /= 2)
    for (int stage = 8; stage >= 4; stage /= 2) {
      const BandGeom g = band_rows(span, tile, nacc, k, threads, nsl, 8, stage, c);
      if (g.threads && g.tr >= min(tile, 16)) return g;
    }
  return band_clip(span, tile, nacc);
}

// K rows of a column a thread, NACC as grid_kernel's, kClip the clipped
// form; wv: float4s of a stored tap row (tap_vecs). A cluster of gm.cs
// CTAs serves the chunks [per c, per (c + 1)), one run of consecutive
// chunks of one segment at a time, a sub-tile after another: gm.tr rows of
// window corners of the run by gm.tc columns, its entries the run's
// stretch of each corner row with its corner in those columns (the walk
// order follows the window corner, row by row), found by binary search on
// iv0[order[p]] and iu0[order[p]].
// Whole: the sub-tile's cells and halo held in bands of rb rows over the
// cluster's CTAs. Each walk (Romein's, at period span; its classes in
// slices over gm.nsl CTAs where they outgrow one, a thread's K rows of a
// column) takes a contiguous share of the sub-tile's entries, each walked
// once; each CTA stages its walks' batches as grid_wide_kernel does (ku,
// kv twice over, by cp.async, the walk order read two batches ahead). A
// register run is flushed as one 64-bit add on the cluster address, and
// each sub-tile goes into grid64 once, in one overlap-add.
// Clipped: the held cells in blocks of hb rows by wb columns, each CTA's
// rb rows of a block its own and each of their cells one thread's: every
// CTA walks the entries whose windows meet the block's rows, with their
// tap rows copied over its rows and the block's columns (zero outside the
// window), and adds each cell's sums to its own shared word every kRunCap
// entries; each block goes into grid64 in its own overlap-add.
template <int K, int NACC, bool kClip>
__global__ void __launch_bounds__(wide_threads<K>(), 1)
    grid_band_kernel(const float2* __restrict__ vals, const int* __restrict__ iu0,
                     const int* __restrict__ iv0, const float* __restrict__ frac,
                     const float4* __restrict__ ku, const float2* __restrict__ kv,
                     const int* __restrict__ order, const int* __restrict__ chunk_seg,
                     const int* __restrict__ chunk_start, const int* __restrict__ chunk_count,
                     const float* __restrict__ tap_bound, const float* __restrict__ vsum,
                     unsigned long long* __restrict__ grid64, int npix, int tile, int nta,
                     int span, int wv, const BandGeom gm, int nchunks, int per) {
  using u64 = unsigned long long;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gm.cs;
  const int rank = (int)cluster.block_rank();
  const int threads = gm.threads;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* stg = reinterpret_cast<float4*>(smem_raw);  // whole: [2][slots][slot]
  int* red = reinterpret_cast<int*>(smem_raw + gm.red);
  // [tr + 1] each: a corner row's first entry in the sub-tile, the prefix
  // of their counts, its first entry not yet served, its end, that entry's
  // corner column
  int* first = reinterpret_cast<int*>(smem_raw + gm.seg);
  int* pre = first + gm.tr + 1;
  int* cur = pre + gm.tr + 1;
  int* rowend = cur + gm.tr + 1;
  int* nextc = rowend + gm.tr + 1;
  u64* acc = reinterpret_cast<u64*>(smem_raw + gm.acc);
  const int nb = gm.rb * gm.ld;  // words of one accumulator's band
  const int stage = gm.stage;
  const int tr = gm.tr, tc = gm.tc;
  const float* kuf = reinterpret_cast<const float*>(ku);
  const float* kvf = reinterpret_cast<const float*>(kv);

  const float total = vsum[0] * tap_bound[0];
  if (!isfinite(total)) return;  // the whole cluster leaves; the conversion writes NaN
  const int kg = grid_exponent(total);
  const double unit = ldexp(1.0, kg);
  // a sum times 2^kg is below 2^61, so it is exact in f32 as in f64 and
  // rounds to the same integer, where 2^kg is a float
  const float unitf = kg <= 127 ? ldexpf(1.f, kg) : 0.f;
  auto to_units = [&](float r) {
    return unitf != 0.f ? __float2ll_rn(r * unitf) : __double2ll_rn((double)r * unit);
  };
  const int ntiles = nta * nta;
  const int half = span / 2;
  auto wrap = [&](int d) { return d >= span ? d - span : d; };

  // whole: the walk. CTAs [wbase, wbase + nsl) of the cluster each hold a
  // slice of walk wid's classes; a CTA of one-CTA walks runs gm.walks of them
  const int nsl = gm.nsl;
  const int slice = rank % nsl;
  const int g = nsl > 1 ? 0 : tid / gm.group;
  const int wid = nsl > 1 ? rank / nsl : rank * gm.walks + g;
  const int nwalks = nsl > 1 ? cs / nsl : cs * gm.walks;
  // loader role: thread stages piece (tid % kper) of slot (tid / kper),
  // entry lslot % stage of walk lw's batch
  const int kper = kClip ? 1 : threads / gm.slots;
  const int lslot = tid / kper;
  const int piece = tid - lslot * kper;
  const bool loader = lslot < gm.slots;
  const int lw = nsl > 1 ? wid : rank * gm.walks + lslot / stage;
  const int ntask = gm.tv + span;
  const float rinv = 1.f / gm.rb;
  // walk role in pass ps: the classes (a, b0 + j), j < nvalid (0: none);
  // each has exactly one cell in every window: (x, rv + dy_j), x the column
  // of class a in [ru, ru + span), dy_j = (b0 + j - rv) mod span
  int a = 0, b0 = 0, nvalid = 0;
  auto role = [&](int ps) {
    const int rr = nsl > 1 ? (ps * nsl + slice) * threads + tid : tid - g * gm.group;
    const bool walker = nsl > 1 ? rr < gm.group : g < gm.walks;
    a = walker ? rr / gm.nbb : 0;
    b0 = walker ? (rr - a * gm.nbb) * K : 0;
    nvalid = walker ? min(K, span - b0) : 0;
  };
  if (!kClip) role(0);

  const int c1 = min(nchunks, (int)(blockIdx.x / cs + 1) * per);
  for (int c0 = (blockIdx.x / cs) * per; c0 < c1;) {
    // the run: chunks [c0, ce) of one segment, walk positions [rstart, rend)
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
    // the run follows its window corners' rows, then their columns
    const int rfirst = iv0[order[rstart]] - tv0;
    const int rlast = iv0[order[rend - 1]] - tv0;
    for (int R0 = rfirst; R0 <= rlast; R0 += tr) {
      // each corner row's stretch of the run, [cur, rowend): its entries
      // not yet served
      __syncthreads();  // the previous sub-tile is done with cur and rowend
      for (int i = tid; i < tr; i += threads) {
        const int fv = tv0 + R0 + i;  // the corner row
        int b[2];
        for (int e = 0; e < 2; ++e) {
          int l = e ? b[0] : rstart, h = rend;
          while (l < h) {
            const int mid = (l + h) >> 1;
            if (iv0[order[mid]] < fv + e) l = mid + 1;
            else h = mid;
          }
          b[e] = l;
        }
        cur[i] = b[0];
        rowend[i] = b[1];
      }
      // sub-tiles from the strip's first corner column with entries left, each
      // tc columns (empty stretches of columns are skipped)
      int cnext = 0;
      for (int C0 = 0; C0 < tile; C0 = cnext) {
        // the sub-tile's entries: on corner row R0 + i, those left of column
        // C0 + tc (the row's entries follow their corner's column)
        __syncthreads();  // the previous sub-tile is done with first, pre, red and the band
        for (int i = tid; i < tr; i += threads) {
          const int fu = tu0 + C0 + tc;  // the first corner column past the sub-tile
          const int lo = cur[i];
          int l = lo, h = rowend[i];
          while (l < h) {
            const int mid = (l + h) >> 1;
            if (iu0[order[mid]] < fu) l = mid + 1;
            else h = mid;
          }
          first[i] = lo;
          pre[i + 1] = l - lo;
          cur[i] = l;
          nextc[i] = l < rowend[i] ? iu0[order[l]] - tu0 : INT_MAX;
        }
        __syncthreads();
        if (tid == 0) {
          // and the first and last corner rows with entries, and the first
          // corner column of the entries left
          red[0] = INT_MAX;
          red[1] = -1;
          red[2] = INT_MAX;
          pre[0] = 0;
          for (int i = 0; i < tr; ++i) {
            if (pre[i + 1] > 0) {
              red[0] = min(red[0], i);
              red[1] = i;
            }
            pre[i + 1] += pre[i];
            red[2] = min(red[2], nextc[i]);
          }
        }
        __syncthreads();
        cnext = red[2] == INT_MAX ? tile : max(C0 + tc, red[2]);
        const int count = pre[tr];
        if (count == 0) continue;  // uniform: every CTA of the cluster skips it
        // the walk position of the sub-tile's i-th entry
        auto entry = [&](int i) {
          int l = 0, h = tr - 1;  // the corner row: pre[l] <= i < pre[l + 1]
          while (l < h) {
            const int mid = (l + h + 1) >> 1;
            if (pre[mid] <= i) l = mid;
            else h = mid - 1;
          }
          return first[l] + i - pre[l];
        };
        // the held rows the windows reach, [y0, y1) (a window of corner row i
        // lies in held rows [i, i + span))
        const int y0 = red[0], y1 = min(gm.rows, red[1] + span);
        if constexpr (kClip) {
          float* tapf = reinterpret_cast<float*>(smem_raw);  // [2][stage][kvw + wb]
          float4* mval = reinterpret_cast<float4*>(
              smem_raw + 2 * (size_t)stage * (gm.rb + gm.ld - 1) * sizeof(float));
          const int hb = cs * gm.rb, wb = gm.ld - 1;  // a block's rows and columns
          const int cols = tc + span - 1;             // the sub-tile's held columns
          const int kvw = gm.rb;                      // a slot's kv taps, then its ku
          const int sp = kvw + wb;
          const int cc = tid % wb, blk = tid / wb;    // the thread's column and row block
          for (int Y0 = y0; Y0 < y1; Y0 += hb)
            for (int X0 = 0; X0 < cols; X0 += wb) {
              const int wbw = min(wb, cols - X0);  // the block's columns
              // the block's entries [ebeg, ebeg + ecount): corner rows i
              // whose windows meet its rows, Y0 - span < i < Y0 + hb
              const int ilo = max(0, Y0 - span + 1), ihi = min(tr, Y0 + hb);
              const int ebeg = pre[ilo];
              const int ecount = ilo < ihi ? pre[ihi] - ebeg : 0;
              if (ecount == 0) continue;  // uniform over the CTA
              __syncthreads();  // the previous block's overlap-add is done with the band
              for (int c = 0; c < NACC; ++c)
                for (int i = tid; i < nb; i += threads) acc[(size_t)c * nb + i] = 0ull;
              const int items = gm.rb + wbw;
              const int hy = Y0 + rank * gm.rb;  // the CTA's first held row
              // stage 1: batch k's tap rows over the CTA's rows and the
              // block's columns into buffer b (zero outside the window), and
              // the values weighted for the lower and upper plane
              auto stage1c = [&](int k, int b) {
                float* tb = tapf + (size_t)b * stage * sp;
                float4* vb = mval + (size_t)b * stage;
                for (int it = tid; it < stage * items; it += threads) {
                  const int sl = it / items, r = it - sl * items;
                  const int i = k * stage + sl;
                  if (i >= ecount) break;
                  const int e = order[entry(ebeg + i)];
                  const int axis = r < gm.rb ? 0 : 1;  // 0: kv (rows), 1: ku (columns)
                  const int d = axis == 0 ? hy + r - (iv0[e] - tv0 - R0)
                                          : X0 + (r - gm.rb) - (iu0[e] - tu0 - C0);
                  const float tap = d >= 0 && d < span
                                        ? (axis == 0 ? kvf : kuf)[(size_t)e * 4 * wv + d]
                                        : 0.f;
                  tb[(size_t)sl * sp + (axis == 0 ? r : kvw + r - gm.rb)] = tap;
                  if (r == 0) {
                    const float2 val = vals[e];
                    float4 w = make_float4(val.x, val.y, 0.f, 0.f);
                    if (NACC == 4) {
                      const float f = frac[e], w0 = 1.f - f;
                      w = make_float4(val.x * w0, val.y * w0, val.x * f, val.y * f);
                    }
                    vb[sl] = w;
                  }
                }
              };
              const bool walker = cc < wbw;
              int since = 0;
              float sum[K][NACC];
#pragma unroll
              for (int j = 0; j < K; ++j)
#pragma unroll
                for (int w = 0; w < NACC; ++w) sum[j][w] = 0.f;
              // the sums into the thread's own cells (no other thread adds to them)
              auto flushc = [&]() {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                  const int yy = blk * K + j;
#pragma unroll
                  for (int w = 0; w < NACC; ++w) {
                    if (yy < gm.rb) acc[(size_t)w * nb + (size_t)yy * gm.ld + cc] += (u64)to_units(sum[j][w]);
                    sum[j][w] = 0.f;
                  }
                }
              };
              const int nbatch = (ecount + stage - 1) / stage;
              stage1c(0, 0);
              for (int k = 0; k < nbatch; ++k) {
                const int b = k & 1;
                // batch k's taps are staged, and every thread is done with
                // batch k - 1's
                __syncthreads();
                // batch k + 1's into the other buffer while batch k is walked
                // (the warps' loads overlap the others' walk)
                if (k + 1 < nbatch) stage1c(k + 1, b ^ 1);
                if (!walker) continue;
                const int nj = min(stage, ecount - k * stage);
                const float* tb = tapf + (size_t)b * stage * sp;
                const float4* vb = mval + (size_t)b * stage;
                for (int jj = 0; jj < nj; ++jj) {
                  const float* tp = tb + (size_t)jj * sp;
                  const float kx = tp[kvw + cc];
                  if (kx == 0.f) continue;  // the column lies outside the window
                  const float4 wvl = vb[jj];
                  const float lr = wvl.x * kx, li = wvl.y * kx;
                  const float hr = wvl.z * kx, hi = wvl.w * kx;
                  float ky[K];
#pragma unroll
                  for (int j = 0; j < K; j += 4) {
                    const float4 q4 = *reinterpret_cast<const float4*>(tp + blk * K + j);
                    ky[j] = q4.x;
                    ky[j + 1] = q4.y;
                    ky[j + 2] = q4.z;
                    ky[j + 3] = q4.w;
                  }
#pragma unroll
                  for (int j = 0; j < K; ++j) {
                    sum[j][0] = fmaf(ky[j], lr, sum[j][0]);
                    sum[j][1] = fmaf(ky[j], li, sum[j][1]);
                    if (NACC == 4) {
                      sum[j][2] = fmaf(ky[j], hr, sum[j][2]);
                      sum[j][3] = fmaf(ky[j], hi, sum[j][3]);
                    }
                  }
                  if (++since == kRunCap) {  // bounds a sequential f32 sum
                    flushc();
                    since = 0;
                  }
                }
              }
              if (walker) flushc();
              __syncthreads();
              // overlap-add of the CTA's rows of the block: held cell (y, x)
              // is the tile's (R0 + y, C0 + x); untouched cells are zero and
              // skipped, halo cells past the grid edge are zero and skipped
              for (int i = tid; i < nb; i += threads) {
                const int yy = i / gm.ld;
                const int x = i - yy * gm.ld;
                if (x >= wbw) continue;
                const int gy = tv0 + R0 + hy + yy;
                const int gx = tu0 + C0 + X0 + x;
                if (gy >= npix || gx >= npix) continue;
#pragma unroll
                for (int p = 0; p < NACC / 2; ++p) {
                  const u64 re = acc[2 * p * (size_t)nb + i];
                  const u64 im = acc[(2 * p + 1) * (size_t)nb + i];
                  if (re != 0 || im != 0) {
                    u64* gp = grid64 + 2 * (((size_t)(plane + p) * npix + gy) * npix + gx);
                    atomicAdd(gp, re);
                    atomicAdd(gp + 1, im);
                  }
                }
              }
            }
        } else {
          // this CTA's band of the rows the windows reach
          const int ys = rank * gm.rb;
          const int z0 = max(y0, ys), z1 = min(y1, ys + gm.rb);
          const int zn = max(0, z1 - z0) * gm.ld;
          u64* zb = acc + (size_t)(z0 - ys) * gm.ld;
          for (int c = 0; c < NACC; ++c)
            for (int i = tid; i < zn; i += threads) zb[(size_t)c * nb + i] = 0ull;
          // every band is zero before any CTA of the cluster adds to it
          cluster.sync();

          // walk w of the cluster's nwalks takes the sub-tile's entries [w q,
          // (w + 1) q)
          const int q = (count + nwalks - 1) / nwalks;
          const int nbatch = (q + stage - 1) / stage;
          const int lbeg = lw * q + lslot % stage;
          const int lend = min((lw + 1) * q, count);
          auto entry_of = [&](int k) {
            const int i = lbeg + k * stage;
            return loader && i < lend ? order[entry(i)] : -1;
          };
          int e_pend = -1, u_pend = 0, v_pend = 0;
          float2 val_pend = make_float2(0.f, 0.f);
          float f_pend = 0.f;
          auto slot_of = [&](int k) {
            return stg + ((size_t)(k & 1) * gm.slots + lslot) * gm.slot;
          };
          // the entry's ku row and its kv row twice over (taps kv[d mod
          // span] at d < 2 span) by cp.async; piece 0 loads its fields
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
          // the values weighted for the lower and upper plane; the corner in
          // the sub-tile's held cells and its residues mod span
          auto publish = [&](int k) {
            if (e_pend >= 0 && piece == 0) {
              float4* s = slot_of(k) + gm.tv + span / 2;
              const float w0 = 1.f - f_pend;
              s[0] = make_float4(val_pend.x * w0, val_pend.y * w0, val_pend.x * f_pend,
                                 val_pend.y * f_pend);
              const int ru = u_pend - tu0, rv = v_pend - tv0;
              reinterpret_cast<int4*>(s)[1] = make_int4(ru - C0, rv - R0, ru % span, rv % span);
            }
          };

          const int gbeg = wid * q;
          const int gend = min(gbeg + q, count);
          // the run's column, corner row, its dy0 and entries so far; the sums
          int curx = -1, currv = 0, dy0 = 0, since = 0;
          float sum[K][NACC];
#pragma unroll
          for (int j = 0; j < K; ++j)
#pragma unroll
            for (int w = 0; w < NACC; ++w) sum[j][w] = 0.f;
          // integer adds commute: the cells are the same whatever their order
          auto flush = [&](int j) {
            const int y = currv + wrap(dy0 + j);  // the held row
            const int dst = (int)(((float)y + 0.5f) * rinv);  // y / rb
            u64* pc = acc + (size_t)(y - dst * gm.rb) * gm.ld + curx;
#pragma unroll
            for (int w = 0; w < NACC; ++w) {
              const long long q64 = to_units(sum[j][w]);
              if (q64 != 0) atomicAdd(cluster.map_shared_rank(pc + w * nb, dst), (u64)q64);
              sum[j][w] = 0.f;
            }
          };
          auto flush_all = [&]() {
            if (curx >= 0) {
#pragma unroll
              for (int j = 0; j < K; ++j)
                if (j < nvalid) flush(j);
            }
            curx = -1;
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
            const int nj = min(stage, gend - (gbeg + k * stage));
            const float4* sb =
                stg + ((size_t)(k & 1) * gm.slots + (nsl > 1 ? 0 : g * stage)) * gm.slot;
            for (int ps = 0; ps < gm.npass; ++ps) {
              if (gm.npass > 1) {
                role(ps);
                since = 0;
              }
              if (nvalid > 0) {
                for (int jj = 0; jj < nj; ++jj) {
                  const float4* rec = sb + (size_t)jj * gm.slot;
                  const float* tp = reinterpret_cast<const float*>(rec);
                  const float4 wval = rec[gm.tv + span / 2];
                  const int4 cv = reinterpret_cast<const int4*>(rec)[gm.tv + span / 2 + 1];
                  int dx = a - cv.z;
                  dx += dx < 0 ? span : 0;
                  const int x = cv.x + dx;
                  if (x != curx || since == kRunCap) {
                    // the column moved (or the runs are kRunCap long): every
                    // class's cell changes
                    flush_all();
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
              // a pass's runs end with its batch where the walk takes several
              if (gm.npass > 1) flush_all();
            }
          }
          flush_all();
          // every CTA's adds to this band are done
          cluster.sync();

          // overlap-add of the band, as grid_kernel's: held cell (y, x) is
          // the tile's (R0 + y, C0 + x); untouched cells are zero and
          // skipped, halo cells past the grid edge are zero and skipped
          for (int i = tid; i < zn; i += threads) {
            const int yy = i / gm.ld;
            const int x = i - yy * gm.ld;
            if (x >= tc + span - 1) continue;
            const int gy = tv0 + R0 + z0 + yy;
            const int gx = tu0 + C0 + x;
            if (gy >= npix || gx >= npix) continue;
            const size_t cc = (size_t)(z0 - ys + yy) * gm.ld + x;
#pragma unroll
            for (int p = 0; p < NACC / 2; ++p) {
              const u64 re = acc[2 * p * (size_t)nb + cc];
              const u64 im = acc[(2 * p + 1) * (size_t)nb + cc];
              if (re != 0 || im != 0) {
                u64* gp = grid64 + 2 * (((size_t)(plane + p) * npix + gy) * npix + gx);
                atomicAdd(gp, re);
                atomicAdd(gp + 1, im);
              }
            }
          }
        }
      }
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

template <int K, int NACC, bool kClip>
int launch_band_k(const BandGeom& gm, const void* vals, const void* iu0,
                  const void* iv0, const void* frac, const void* ku,
                  const void* kv, const void* order, const void* chunk_seg,
                  const void* chunk_start, const void* chunk_count,
                  const void* tap_bound, const void* vsum, void* grid64,
                  int nchunks, int npix, int tile, int nta, int span, cudaStream_t s) {
  auto fn = grid_band_kernel<K, NACC, kClip>;
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
  // chunks a cluster: enough clusters for about kBandWaves of them on every
  // SM, each serving the runs that leaves
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int per = max(1, (int)((long long)nchunks * gm.cs / ((long long)sms * kBandWaves)));
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
  e = cudaLaunchKernelEx(&cfg, fn, (const float2*)vals, (const int*)iu0, (const int*)iv0,
                         (const float*)frac, (const float4*)ku, (const float2*)kv,
                         (const int*)order, (const int*)chunk_seg, (const int*)chunk_start,
                         (const int*)chunk_count, (const float*)tap_bound, (const float*)vsum,
                         (unsigned long long*)grid64, npix, tile, nta, span, tap_vecs(span), gm,
                         nchunks, per);
  if (e != cudaSuccess) return (int)e;
  return ska_last_error();
}

template <int NACC>
int launch_band(const void* vals, const void* iu0, const void* iv0,
                const void* frac, const void* ku, const void* kv,
                const void* order, const void* chunk_seg, const void* chunk_start,
                const void* chunk_count, const void* tap_bound, const void* vsum,
                void* grid64, int nchunks, int npix, int tile, int nta, int span,
                cudaStream_t s) {
  const BandGeom gm = band_plan(span, tile, NACC);
  if (gm.threads == 0) return (int)cudaErrorInvalidValue;  // not one row of a block fits
#define SKA_GRID_BAND_K(K)                                                            \
  band_clipped(gm) ? launch_band_k<K, NACC, true>(gm, vals, iu0, iv0, frac, ku, kv, order,     \
                                         chunk_seg, chunk_start, chunk_count,         \
                                         tap_bound, vsum, grid64, nchunks, npix,      \
                                         tile, nta, span, s)                          \
          : launch_band_k<K, NACC, false>(gm, vals, iu0, iv0, frac, ku, kv, order,    \
                                          chunk_seg, chunk_start, chunk_count,        \
                                          tap_bound, vsum, grid64, nchunks, npix,     \
                                          tile, nta, span, s)
  switch (gm.k) {
    case 8: return SKA_GRID_BAND_K(8);
    case 6: return SKA_GRID_BAND_K(6);
    case 4: return SKA_GRID_BAND_K(4);
    default: return SKA_GRID_BAND_K(2);
  }
#undef SKA_GRID_BAND_K
}

// How ska_grid serves windows of `span` cells on tiles of `tile` cells
// (nacc as ska_grid's): 0 it refuses them; 1 the narrow kernel (16 cells
// or fewer, the whole tile in one block); 2 the wide kernel, the whole
// tile in its cluster's bands; 3 the wide kernel in turns (its bands hold
// fewer rows than the tile's, at least one window's); 4 route 4, sub-tiles
// of window corners over a cluster (windows past 64 cells, and tiles no
// cluster's bands serve).
inline int grid_route(int span, int tile, int nacc) {
  if (span < 1 || tile < 1) return 0;
  if (span <= 16 && narrow_smem(span, tile, nacc, tile + span) <= kMaxSmem) return 1;
  if (span % 2 || span > tile) return 0;
  if (span <= 64) {
    const WideGeom g = wide_plan(span, tile, nacc);
    if (g.cs != 0) return g.cs * g.rb >= tile + span ? 2 : 3;
  }
  return band_plan(span, tile, nacc).threads ? 4 : 0;
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
      rc = four ? launch_band<4>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                                 chunk_start, chunk_count, tap_bound, vsum, grid64,
                                 nchunks, npix, tile, nta, support, s)
                : launch_band<2>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                                 chunk_start, chunk_count, tap_bound, vsum, grid64,
                                 nchunks, npix, tile, nta, support, s);
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
// the whole tile, 3 the wide kernel in turns, 4 route 4 (sub-tiles over a
// cluster, windows clipped to blocks past the largest window it holds).
SKA_EXPORT int ska_grid_route(int span, int tile, int nacc) {
  return grid_route(span, tile, nacc);
}

// Route 4's launch geometry at window span `span` (even; it runs where
// ska_grid_route says 4) on tiles of `tile` cells, nacc as ska_grid's: what
// 0 the CTAs of a cluster, 1 the threads of a CTA, 2 its dynamic shared
// bytes, 3 its walks (1 where a walk spans CTAs), 4 the rows of a column a
// thread owns, 5 the entries a walk takes a batch, 6 and 7 the rows and
// columns of window corners of a sub-tile, 8 the CTAs of one walk, 9 the
// passes of a walk's threads over its classes, 10 the tap buffers, 11 and
// 12 the held rows and columns of a block where the cluster serves a
// sub-tile's held cells in blocks, windows clipped to each (0 where it
// holds them whole); 0 past them and where not one row of a block fits.
SKA_EXPORT int ska_grid_band_geometry(int span, int tile, int nacc, int what) {
  if (span < 2 || span % 2 || span > tile) return 0;
  const BandGeom gm = band_plan(span, tile, nacc);
  if (gm.threads == 0) return 0;
  const bool clip = band_clipped(gm);
  const int v[] = {gm.cs,  gm.threads, (int)gm.smem, gm.walks, gm.k,
                   gm.stage, gm.tr,    gm.tc,        gm.nsl,   gm.npass,
                   2,        clip ? gm.cs * gm.rb : 0, clip ? gm.ld - 1 : 0};
  return what >= 0 && what < 13 ? v[what] : 0;
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
