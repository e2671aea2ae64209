// K9: the unit compute of the tiled gridder, with the reduction of units
// onto tiles and the overlap-add into the plane grids folded in.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_pallas.py:_unit_kernel
// (reached by unit_tiles_pallas) and computes what it generalises, the unit
// compute of ops/gridding_tiled.py:tiled_grid: per unit of entries that
// share one (plane, tile) segment, the separable ES kernel of each entry's
// u and v offsets from the tile origin, ((t0 - pix) + r) - lo, and the
// tile sum_c (kv[r, c] * val[c]) * ku[x, c] over the tile's buf = tile +
// support rows and columns. The JAX package then reduces the units of one
// tile by a cumsum and a difference and overlap-adds the tiles into the
// grids; here each CTA adds its tile, halo included, straight into the
// plane grids, so no [units, buf, buf] array exists in device memory.
//
// Layout: one CTA per unit of the segment-sorted entry stream, read in place
// through the (start, count, segment) unit table. Within a segment the
// stream is sorted by window corner (gridding_tiled.entry_stream), so
// consecutive entries share most cells. Work form: the window form. The ES
// kernel is zero outside its support, so stage 1 evaluates only the
// `support` non-zero taps per axis of each entry of a batch, once, into
// shared memory, from coordinates that cp.async staged there while the
// previous batch was summed (double-buffered).
//
// Stage 2 is the work-distribution gridder of Romein (2012): an S x S
// window (S = support) touches exactly one cell of each residue class (x
// mod S, y mod S). A group of S^2 threads owns the classes, one each; each
// thread finds the one cell of each entry's window in its class and sums
// tap products in registers while consecutive entries hit that cell,
// adding them to the shared tile only when the cell changes, after
// kRunCap entries (which bounds the length of a sequential sum: f32 error
// grows with it) and at the end. The CTA runs the whole groups nearest to
// 256 threads, each over a contiguous part of the unit. The flush adds the
// touched cells of the tile into the integer grids with global atomics, as
// K1 folds K2.
//
// Numerics: templated on the real type (f32 for the fast-f32 and 2-d
// rows, f64 for the deep-f64 rows). The offset is formed as
// ((t0 - pix) + r) - lo with round-to-nearest intrinsics that the compiler
// may not contract into an FMA: the small hi difference is exact, and the
// lo residual of a split (hi, lo) coordinate then carries the f64
// position.
//
// Order-free sums: the shared tile and the plane grids accumulate
// integers, whose sums do not depend on the order of the atomics, so a
// launch gives the same bits on every run of the same input (as K1 does;
// self-cal has near-ties that a changed rounding flips). A thread's
// register sums are in T, in a fixed order; each flush adds them in fixed
// point, in units of 2^-kg where 2^(kTop - kg) bounds every cell of the
// launch: the wrapper's sum of |re| + |im| over vals (each tap product is
// at most 1, the ES kernel's peak). The tiles go into integer plane grids
// in the same units, and a second kernel writes the complex grids.
//   f32: one int64 word a value (kTop 61, K1's design): a unit is 2^-60
//   of the bound, so a cell is as exact as its f32 register sums unless it
//   is below ~1e-11 of the bound.
//   f64: int64 cannot hold f64's 53 bits beside the dynamic range of a
//   grid, so a value is a 128-bit integer in two words (kTop 125, units
//   2^-124 of the bound): the low word's atomicAdd returns the old word,
//   whose unsigned overflow gives the carry that goes into the high word
//   with a second atomicAdd. Integer adds modulo 2^128 commute, and the
//   high word is never read before the launch ends, so the pair is exact
//   whatever the order. The alternative, each unit's tile and halo written
//   to scratch and a second pass summing each cell's units in unit order,
//   needs units x buf^2 of scratch (1.6 GB for the 19,615 units of buf 72
//   of chip_smoke.py's f64 epsilon stream) and a second pass over it; the pair keeps the one-pass design and costs
//   twice the integer words.
// A non-finite value in vals (a non-finite bound) makes every cell NaN.
//
// What bounds it on the card: stage 1's 2 S ES taps an entry (an exp, a
// sqrt and a division each; slow in f64) and stage 2's issue rate (shared
// loads and a complex multiply-add per entry and thread); then the flushes
// (one or two integer atomics a word) and the integer tile's shared memory
// (8 or 16 bytes a value: one CTA an SM at the larger tiles). The bytes it
// must move are the sorted stream once and the grids once.
//
// Odd supports and supports past 16 (up to the tile and 64) take
// unit_tiles_wide_kernel, Romein's walk at the residue period of the
// window itself, S (the tiled path's ES kernel has half width S // 2, so
// an odd S's non-zero taps, at most S - 1 of them, lie in the S cells from
// floor(pix) - (S // 2 - 1)): every class has exactly one cell in every
// window, so no thread walks an entry for nothing. A thread owns K
// consecutive rows of one column (K 4 to 8 and the threads a CTA by
// support, wide_choice, so that at most an eighth of the classes a CTA
// could own idle from S 7 up): per entry it reads the corner's residues,
// its column's u tap and the value once for K cells, and K v taps in
// vector loads; stage 1 stores the taps by residue class, so these loads
// sit at fixed offsets whatever the corner. A walk of S x ceil(S / K)
// threads takes a contiguous share of its cluster's run. Stage 1 spreads
// a batch's taps over every thread, a block of consecutive taps of one
// axis a thread (es_tap in the narrow kernel's operation order, so the
// taps keep their bits), from coordinates that cp.async staged two
// batches ahead; the taps of a batch are double-buffered, so a batch
// costs one barrier. The register runs (at most kRunCap entries, every
// thread's cut on the same entry) are flushed into an integer tile in
// shared memory, one int64 word a value (16 bytes a cell), with a margin
// row and column for the window's cell left of the tile (the dense form
// drops it), held in bands of rows by a thread block cluster (the least
// of 1, 2, 4 or 8 CTAs whose bands fit beside the staging: one CTA at tile
// 64 to S 48, two at 64); a flush into another CTA's band goes through
// distributed shared memory. Every flush is an add on the cluster address
// (one 64-bit atomic instruction, where the add on the CTA's own shared
// address is a compare-and-swap loop). f32 flushes in the launch's units
// 2^-kg. f64 flushes in units of the run's own, 2^-kr with 2^(61 - kr)
// above the run's entries times its largest |re| + |im| (a maximum, so
// the same whatever the order), and the overlap-add puts each word into
// the launch's 128-bit units exactly (2^(kg - kr) times it; rounded to
// nearest, deterministically, on a run below 2^-64 of the launch's
// bound): the carry of the pair is formed in the overlap-add, as
// add_int128 forms it, not in every flush. A cluster serves consecutive
// units, each run of them on one segment as one stream, and overlap-adds
// the run's rows of the tile into grid64 once, skipping untouched cells.
// Where no cluster of 8 holds the whole tile (512 at S 17), 8 CTAs hold as
// many rows as fit and serve each run in turns, as K1's wide variant
// does: the run's entries follow their window's corner row, so a turn is
// the longest stretch of them whose windows (S + 1 rows, one early where
// a corner is an integer with a negative residual) the bands hold, with
// its own units in f64; a tile whose bands cannot hold one window takes
// route 4 below. Even supports to 16
// take this variant too on tiles the narrow kernel cannot hold (past
// 97-115 cells in f32, 64-81 in f64), chosen by geometry before the launch
// (unit_tiles_route). The conversion is the narrow kernel's, and a launch
// gives the same bits on every run.
//
// What bounds the wide variant on the card (NVIDIA H100 80GB HBM3; copies
// of this source with one passage changed, timed by unit_designs.py;
// PERF.md): 7-13 times its bound from S 17 up in f32, 8-10 in f64; on
// the epsilon observation's whole stream (19,884,032 entries, 77 a window
// corner) the walk takes 38-56% of a launch at supports 17-32 and more
// past them, its four FMAs a class and entry and the per-entry checks
// around them; stage 1 30-48% (about 58 instructions a tap: the
// correctly rounded division, square root and exp that keep the taps'
// bits); the flushes 2-11%; the wrapper's bound sum, the scratch grids'
// memset and the conversion 5-16%. The design it replaced, one class a
// thread and every flush into device memory, kept 81-97% of its time
// with its flushes compiled out: its walk bound it (f64: also its
// serial taps).
//
// Supports past 64 (up to the tile) and tiles of which a cluster's bands
// cannot hold one window's rows (3494 cells at support 24 in f32 down to
// 1530 at 64 in f64) take route 4, unit_tiles_band_kernel: the wide
// variant's walks, integer cells and flushes on sub-tiles of the tile that
// the kernel picks, tr rows by tc columns of window corners (64 columns,
// 128 past a support of 64), whose cells and halo, every window of their
// entries whole, a cluster holds in bands of rows: one CTA at supports to
// 64 (all flushes into the CTA's own shared memory), 4 or 8 past 64. A run
// of units is served a sub-tile after another: a segment's entries follow
// their window corner row by row, so a sub-tile's entries are one stretch
// of the run on each corner row, found by binary search, and every entry
// is walked once. Past 64 a walk of S x ceil(S / 8) classes (2048 at S
// 128) is sliced over 2 to 8 CTAs of the cluster: stage 1 computes a
// batch's taps once for the walk, spread over its CTAs, and writes them
// into each of their shared memories through distributed shared memory
// (one cluster barrier a batch); past 8 CTAs' threads a walk's threads
// take its classes in passes. Flushes are adds on the cluster address,
// each sub-tile goes into grid64 once, in one overlap-add, and f64 flushes
// in the sub-tile's own units: a launch gives the same bits on every run.
// Two designs were measured and dropped (PERF.md): bands of the
// whole tile's width in turns, whose windows the bands clip (at tile 2048
// a cluster holds 48 rows; 7 of 8 flushes went into another CTA's shared
// memory and each entry was walked in 2 to 3 turns), and each CTA walking
// every entry for its own rows (a cluster barrier and the shared taps'
// stores every few entries). At support 1 the ES kernel of half width 0
// is zero, and so are the grids: nothing is launched but the conversion.
//
// Past the largest window a cluster holds with its halo (a support past
// about 330: at 384 a window's 386 x 386 int64 pairs are 2.4 MB, a cluster
// of 8 CTAs has 1.86 MB) the same kernel takes its clipped form
// (band_clip): sub-tiles of min(tile, 2 S, 1024) corners a side whose held
// cells 8 CTAs serve in blocks, each CTA rb rows of a block by wb columns
// (about square: 256 by 256 in f32, 192 by 256 in f64), each CTA's rows
// its own and each of their cells one thread's (8 rows of a column). A
// block is walked by the entries whose windows meet its rows, in every
// CTA: stage 1 computes an entry's taps over the block's rows and columns
// (zero outside its window; each CTA its own rows' kv taps and a share of
// the ku taps, written into every CTA's shared memory), in es_tap's
// operation order, so the taps keep the whole form's bits; a thread skips
// an entry whose ku tap of its column is zero and adds its cells' sums to
// its own shared words every kRunCap entries, and each block goes into
// grid64 in its own overlap-add, f64 in the sub-tile's units. A block's
// entries are found per corner row by binary search on the columns their
// windows can reach, and a batch's corners and offsets are formed once an
// entry before its taps. The taps of an entry are computed again in every
// block it meets: at 384 on tile 512 (18d) a copy whose ku taps cost
// nothing ran at most 2% faster, so they are not kept across blocks.
// It replaces a walk that added every register run straight into the
// fixed-point grids in device memory (in f64 two words a value with the
// carry). A first version of the blocks kept the whole form's walk,
// every class of the window a thread and the rows outside the block
// masked, and took six times the replaced walk's time: every thread
// walked every entry in every block it met.
//
// What holds route 4 on the card (NVIDIA H100 80GB HBM3, 700 W;
// unit_designs.py --phase18, PERF.md): on phase 18's streams 7.9-15.3 times
// its bound where a cluster holds a sub-tile whole, 1.1-2.0 times faster
// than the device-memory design it replaced but for sparse f32 streams
// past 64 (0.89-1.01 times). About half its time is outside the walk:
// each sub-tile's binary searches, barriers, zeroing and overlap-add,
// which thin runs (a few corner rows a cluster) pay for few entries; then
// stage 1 (the f64 taps a fifth) and the walk. In blocks, at 384 on tile
// 512 (18d): 17.1 (f32) and 16.1 (f64) times its bound, level with the
// device-memory walk it replaced in f32 (2% slower) and 1.44 times faster
// in f64; a copy with the walk compiled out keeps 52-56% of the launch
// (stage 1, each block's searches, barriers and overlap-add).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRunCap = 64;  // the most entries one register sum takes
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block

using u64 = unsigned long long;

// the fixed point of T's sums: kWords 64-bit words a value (low word
// first), 2^(kTop - kg) > bound
template <typename T>
struct Fixed;
template <>
struct Fixed<float> {
  static constexpr int kWords = 1;
  static constexpr int kTop = 61;
};
template <>
struct Fixed<double> {
  static constexpr int kWords = 2;
  static constexpr int kTop = 125;
};

// kg of the units 2^-kg for a launch whose cells are bounded by `bound`;
// every CTA and the conversion compute it alike
template <typename T>
__host__ __device__ inline int fixed_exponent(double bound) {
  int e = 0;
  frexp(bound, &e);  // bound < 2^e
  return Fixed<T>::kTop - e;
}

// x (already in units) rounded to the 128-bit integer (lo, hi): the
// magnitude split at 2^64 is exact (the scaling and floor are exact, and
// the low part is x's own bits below 2^64), then negated in two's
// complement
__device__ __forceinline__ void to_int128(double x, u64& lo, u64& hi) {
  const double a = rint(fabs(x));
  const double h = floor(ldexp(a, -64));
  lo = __double2ull_rn(a - ldexp(h, 64));
  hi = __double2ull_rn(h);
  if (x < 0.0) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
}

// w[0:2] += (lo, hi) modulo 2^128: the low word's old value gives the
// carry into the high word
__device__ __forceinline__ void add_int128(u64* w, u64 lo, u64 hi) {
  const u64 old = atomicAdd(w, lo);
  hi += old + lo < old ? 1ull : 0ull;
  if (hi != 0ull) atomicAdd(w + 1, hi);
}

// w += r in units of 1/scale (r a register sum; scale = 2^kg)
__device__ __forceinline__ void fixed_add(u64* w, float r, double scale) {
  atomicAdd(w, (u64)__double2ll_rn((double)r * scale));
}
__device__ __forceinline__ void fixed_add(u64* w, double r, double scale) {
  u64 lo, hi;
  to_int128(r * scale, lo, hi);
  if (lo != 0ull || hi != 0ull) add_int128(w, lo, hi);
}

// one value's words in a shared tile added into a global grid
__device__ __forceinline__ bool words_add(u64* g, const u64* t, int words) {
  if (words == 1) {
    if (t[0] == 0ull) return false;
    atomicAdd(g, t[0]);
    return true;
  }
  if (t[0] == 0ull && t[1] == 0ull) return false;
  add_int128(g, t[0], t[1]);
  return true;
}

// a CTA: the whole groups of S^2 threads nearest to 256 threads, at least
// one (S = 12: 2 groups, 288 threads; S = 14 and 16: 1)
template <int S>
struct Groups {
  static constexpr int kGroup = S * S;
  static constexpr int kCount = (256 + kGroup / 2) / kGroup;
  static constexpr int kThreads = kCount * kGroup;
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// exp(beta (sqrt(1 - nu^2) - 1)) at nu = offs / half, zero for |nu| >= 1
// (gridding.es_kernel, in the same operation order)
template <typename T>
__device__ __forceinline__ T es_tap(T offs, T half, T beta) {
  const T nu = div_rn(offs, half);
  T nu2 = mul_rn(nu, nu);
  nu2 = nu2 < T(0) ? T(0) : (nu2 > T(1) ? T(1) : nu2);
  const T k = exp_(mul_rn(beta, sub_rn(sqrt_rn(sub_rn(T(1), nu2)), T(1))));
  return abs_(nu) < T(1) ? k : T(0);
}

// entries staged per batch: f64 halves it (its integer tile is twice as
// large)
template <typename T>
struct Batch {
  static constexpr int kSize = sizeof(T) == 8 ? 64 : 128;
};

// a batch's coordinates and values, as cp.async stages them
template <typename T>
struct Coords {
  T u[Batch<T>::kSize], v[Batch<T>::kSize];
  T ulo[Batch<T>::kSize], vlo[Batch<T>::kSize];
  T val[Batch<T>::kSize][2];
};

template <typename T, int S>
__global__ void __launch_bounds__(Groups<S>::kThreads)
    unit_tiles_kernel(const T* __restrict__ u, const T* __restrict__ v,
                      const T* __restrict__ vals, const T* __restrict__ ulo,
                      const T* __restrict__ vlo,
                      const int* __restrict__ unit_seg,
                      const int* __restrict__ unit_start,
                      const int* __restrict__ unit_count,
                      const double* __restrict__ vsum,
                      u64* __restrict__ grid64, int npix, int tile, int nta,
                      int ld, T beta) {
  // groups of S^2 threads, each over [start + g q, start + (g + 1) q) of
  // the unit; a batch holds kPs entries of each group, in slots g kPs + j
  constexpr int kGroup = Groups<S>::kGroup;
  constexpr int kNgroups = Groups<S>::kCount;
  constexpr int kThreads = Groups<S>::kThreads;
  constexpr int kPs = Batch<T>::kSize / kNgroups;
  constexpr int kSlots = kNgroups * kPs;
  constexpr int kHalf = S / 2;
  constexpr int kW = Fixed<T>::kWords;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf = tile + S;
  const int nb = buf * ld;
  Coords<T>* coords = reinterpret_cast<Coords<T>*>(smem_raw);  // [2]
  T* taps = reinterpret_cast<T*>(coords + 2);  // [kSlots][2][S]: v, u
  // [2][buf][ld][kW]: re, im in units of 2^-kg
  u64* acc = reinterpret_cast<u64*>(taps + Batch<T>::kSize * 2 * S);
  // [kSlots][4]: v corner, its residue mod S, u corner, its residue (the
  // corners tile-relative)
  int* rel = reinterpret_cast<int*>(acc + 2 * nb * kW);

  const double total = vsum[0];
  if (!isfinite(total)) return;  // the conversion writes NaN
  const double scale = ldexp(1.0, fixed_exponent<T>(total));

  for (int i = threadIdx.x; i < 2 * nb * kW; i += kThreads) acc[i] = 0ull;

  const int seg = unit_seg[blockIdx.x];
  const int start = unit_start[blockIdx.x];
  const int end = start + unit_count[blockIdx.x];
  const int ntiles = nta * nta;
  const int plane = seg / ntiles;
  const int t = seg - plane * ntiles;
  const int tv0 = (t / nta) * tile;
  const int tu0 = (t % nta) * tile;
  const int q = (unit_count[blockIdx.x] + kNgroups - 1) / kNgroups;
  const int nbatch = (q + kPs - 1) / kPs;
  // position of slot sl in batch k, or -1 past its group's end
  auto pos_of = [&](int k, int sl) {
    const int g = sl / kPs;
    const int p = start + g * q + k * kPs + (sl - g * kPs);
    return p < min(start + (g + 1) * q, end) ? p : -1;
  };
  const int nitems = (ulo != nullptr ? 5 : 3) * kSlots;
  auto issue = [&](int k) {
    Coords<T>& c = coords[k & 1];
    for (int i = threadIdx.x; i < nitems; i += kThreads) {
      const int item = i / kSlots;
      const int sl = i - item * kSlots;
      const int p = pos_of(k, sl);
      if (p < 0) continue;
      if (item == 0)
        ska_cp_async<2 * sizeof(T)>(c.val[sl], vals + 2 * (size_t)p);
      else if (item == 1)
        ska_cp_async<sizeof(T)>(&c.u[sl], u + p);
      else if (item == 2)
        ska_cp_async<sizeof(T)>(&c.v[sl], v + p);
      else if (item == 3)
        ska_cp_async<sizeof(T)>(&c.ulo[sl], ulo + p);
      else
        ska_cp_async<sizeof(T)>(&c.vlo[sl], vlo + p);
    }
    ska_cp_async_commit();
  };

  // stage 2 role: residue class (a, b) of group g
  const int g = threadIdx.x / kGroup;
  const int a = threadIdx.x % S;
  const int b = (threadIdx.x % kGroup) / S;
  const int gbeg = start + g * q;
  const int gend = min(gbeg + q, end);
  int cur = -1, run = 0;
  T re = T(0), im = T(0);
  // integer adds commute: the tile is the same whatever their order
  auto flush = [&]() {
    if (cur >= 0) {
      fixed_add(&acc[cur * kW], re, scale);
      fixed_add(&acc[(nb + cur) * kW], im, scale);
    }
  };

  issue(0);
  for (int k = 0; k < nbatch; ++k) {
    ska_cp_async_wait_all();
    // batch k's coordinates are visible; stage 2 of batch k - 1 is done
    // with the taps (and, at k = 0, the tile is zeroed)
    __syncthreads();
    const Coords<T>& c = coords[k & 1];
    // stage 1: the S taps of one axis of one entry per thread
    for (int i = threadIdx.x; i < 2 * kSlots; i += kThreads) {
      const int sl = i >> 1;
      const int axis = i & 1;  // 0: v (rows), 1: u (columns)
      if (pos_of(k, sl) < 0) continue;
      const T pix = axis == 0 ? c.v[sl] : c.u[sl];
      const T lo = ulo == nullptr ? T(0) : (axis == 0 ? c.vlo[sl] : c.ulo[sl]);
      const int t0 = axis == 0 ? tv0 : tu0;
      // the window of the S non-zero taps starts at floor(pix + lo) -
      // (half - 1): one cell lower than the hi coordinate's window when hi
      // is an integer and lo < 0 (|lo| < 1). Unit entries lie in the grid,
      // so only a tap left of cell 0 of the tile (r < 0, which the dense
      // form does not have either) falls outside; stage 2 skips it
      const int shift = (pix == floor_(pix) && lo < T(0)) ? 1 : 0;
      const int r0 = (int)floor_(pix) - (kHalf - 1) - shift - t0;
      const T d0 = sub_rn(T(t0), pix);
#pragma unroll
      for (int r = 0; r < S; ++r)  // tap r at cell r0 + r of the tile
        taps[(2 * sl + axis) * S + r] =
            es_tap(sub_rn(add_rn(d0, T(r0 + r)), lo), T(kHalf), beta);
      rel[4 * sl + 2 * axis] = r0;
      rel[4 * sl + 2 * axis + 1] = (r0 % S + S) % S;
    }
    if (k + 1 < nbatch) issue(k + 1);
    __syncthreads();
    // stage 2: each thread's cell of each entry's window, summed in
    // registers while it stays the same
    const int nj = min(kPs, gend - (gbeg + k * kPs));
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const int sl = g * kPs + j;
      const int4 rr = reinterpret_cast<const int4*>(rel)[sl];
      int dy = b - rr.y;
      dy += dy < 0 ? S : 0;
      int dx = a - rr.w;
      dx += dx < 0 ? S : 0;
      const int y = rr.x + dy;
      const int x = rr.z + dx;
      if (y < 0 || x < 0) continue;
      const T kv = taps[(2 * sl) * S + dy];
      const T ku = taps[(2 * sl + 1) * S + dx];
      if (kv == T(0) || ku == T(0)) continue;
      const int cell = y * ld + x;
      if (cell != cur || run == kRunCap) {
        flush();
        cur = cell;
        run = 0;
        re = im = T(0);
      }
      ++run;
      re += mul_rn(mul_rn(kv, c.val[sl][0]), ku);
      im += mul_rn(mul_rn(kv, c.val[sl][1]), ku);
    }
  }
  flush();
  __syncthreads();

  // overlap-add: the tile and its halo into the integer plane grids;
  // untouched cells are zero and skipped, halo cells past the grid edge
  // are zero (unit entries lie in the grid) and skipped
  for (int i = threadIdx.x; i < buf * buf; i += kThreads) {
    const int y = i / buf;
    const int x = i - y * buf;
    const int gy = tv0 + y;
    const int gx = tu0 + x;
    if (gy >= npix || gx >= npix) continue;
    u64* gp = grid64 + 2 * kW * (((size_t)plane * npix + gy) * npix + gx);
    words_add(gp, &acc[(y * ld + x) * kW], kW);
    words_add(gp + kW, &acc[(nb + y * ld + x) * kW], kW);
  }
}

constexpr int kWideWaves = 16;  // about this many wide-variant clusters an SM serves

// The launch geometry of the wide variant at support S on tiles of `tile`
// cells: the walks (Romein's, at residue period S) and their staging, and
// the integer tile held in bands of rows over a thread block cluster.
struct WideGeom {
  int k;        // rows of one column a thread owns
  int threads;  // of a CTA
  int nbb;      // row blocks of a column: ceil(S / k)
  int group;    // threads of one walk: S columns times nbb row blocks
  int walks;    // walks of a CTA
  int lstage;   // a walk stages 2^lstage entries a batch
  int slots;    // entries a CTA stages a batch
  int cst;      // stride of a staged coordinate field (slots, rounded up to 4)
  int sp;       // taps of a staged axis row (by residue class; 16-byte rows)
  int rt, nr;   // stage 1: rt consecutive taps of an axis row a thread, nr such blocks a row
  int cs;       // CTAs of a cluster: each holds a band of rb rows of the tile
  int rows;     // rows of the tile held: buf + 1 (row 0 the margin, tile row -1)
  int rb;
  int ld;       // values a tile row (column 0 the margin), odd
  size_t taps, meta, mval, red, acc, smem;  // byte offsets of the arrays; total
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
__host__ __device__ inline WideGeom wide_geom(int S, int tile, int k, int threads,
                                              int cs, int lstage) {
  WideGeom g;
  g.k = k;
  g.threads = threads;
  g.nbb = (S + k - 1) / k;
  g.group = S * g.nbb;
  g.walks = threads / g.group;
  g.lstage = lstage;
  g.slots = g.walks << lstage;
  g.cst = (g.slots + 3) & ~3;
  const int vec = 16 / (int)sizeof(T);
  const int taps = S > g.nbb * k ? S : g.nbb * k;
  g.sp = (taps + vec - 1) / vec * vec;
  // the block of taps a stage-1 thread computes: the least work a thread a
  // batch, counting a row's corner and offset as one tap more, then the
  // largest block
  int best = 1 << 30;
  for (int r = 1; r <= S; ++r) {
    const int nr = (S + r - 1) / r;
    const int rows = threads / nr;  // axis rows a pass
    const int w = (2 * g.slots + rows - 1) / rows * (r + 1);
    if (rows >= 1 && w <= best) {
      best = w;
      g.rt = r;
    }
  }
  g.nr = (S + g.rt - 1) / g.rt;
  g.cs = cs;
  const int buf = tile + S;
  g.rows = buf + 1;
  g.ld = (buf + 1) | 1;
  // coords [3 batches][u, v, ulo, vlo, val re/im][cst]; taps [2][slots][kv,
  // ku][sp]; meta [2][slots] int4; mval [2][slots][2]; red [2] int and one
  // u64; acc [re, im][rb][ld] int64 words
  g.taps = align16(3 * (size_t)6 * g.cst * sizeof(T));
  g.meta = align16(g.taps + 2 * (size_t)g.slots * 2 * g.sp * sizeof(T));
  g.mval = align16(g.meta + 2 * (size_t)g.slots * 16);
  g.red = align16(g.mval + 2 * (size_t)g.slots * 2 * sizeof(T));
  g.acc = g.red + 16;
  // a CTA's band: its share of the tile's rows, or as many as fit
  const size_t row = 2 * (size_t)g.ld * sizeof(u64);
  const int fit = g.acc < kMaxSmem ? (int)((kMaxSmem - g.acc) / row) : 0;
  g.rb = min((g.rows + cs - 1) / cs, fit);
  g.smem = g.acc + row * g.rb;
  return g;
}

// The most threads a CTA runs (f64 sums and taps spill at 64 registers a
// thread)
__host__ __device__ constexpr int wide_most(bool f64) { return f64 ? 768 : 1024; }

// Rows a thread (K, 4 to 8) and threads a CTA: the most walks of the
// largest K whose rows and threads leave at most an eighth of the classes
// a CTA could own idle, with at least 512 threads; a CTA runs as many
// walks as its register budget allows, in whole warps.
inline void wide_choice(int S, bool f64, int& k, int& threads) {
  int best = -1;
  for (int kk = 8; kk >= 4; --kk) {
    const int group = S * ((S + kk - 1) / kk);
    const int walks = wide_most(f64) / group;
    if (walks < 1) continue;
    const int thr = (walks * group + 31) / 32 * 32;
    // the classes owned over those a CTA's threads could own
    const long long used = (long long)walks * S * S, room = (long long)thr * kk;
    const int idle_ok = 8 * used >= 7 * room;
    // fewer idle classes first, then 512 threads or more, then larger K
    const int score = idle_ok * 4000 + (thr >= 512) * 2000 +
                      (idle_ok ? kk : (int)(1000 * used / room));
    if (score > best) {
      best = score;
      k = kk;
      threads = thr;
    }
  }
}

// The least cluster (1, 2, 4 or 8 CTAs) whose bands of the tile fit a
// block's shared memory beside batches of 8 entries a walk or more (or,
// at the small supports of 16 walks a CTA or more, of a tap a thread), the
// largest batch (up to 32) that fits; failing that, the most entries a
// batch that any cluster fits. Where no cluster holds the whole tile, 8
// CTAs with batches of 8 entries a walk (fewer where the bands need it)
// hold as many rows as fit, and the kernel serves each run in turns; cs 0
// where those rows cannot hold one window's S + 1.
template <typename T>
inline WideGeom wide_plan(int S, int tile) {
  int k = 4, threads = 1024;
  wide_choice(S, sizeof(T) == 8, k, threads);
  WideGeom best = wide_geom<T>(S, tile, k, threads, 8, 0);
  best.cs = 0;
  for (int cs = 1; cs <= 8; cs *= 2)
    for (int ls = 5; ls >= 0; --ls) {
      const WideGeom g = wide_geom<T>(S, tile, k, threads, cs, ls);
      if (g.cs * g.rb < g.rows) continue;
      if (ls >= 3 || (g.walks >= 16 && 2 * g.slots * S >= threads)) return g;
      if (best.cs == 0 || g.slots > best.slots) best = g;
      break;
    }
  if (best.cs != 0) return best;
  for (int ls = 3; ls >= 0; --ls) {
    const WideGeom g = wide_geom<T>(S, tile, k, threads, 8, ls);
    if (g.cs * g.rb >= S + 1) return g;
  }
  return best;
}

// r (a register sum) added in units of 1/scale (scale = 2^kg, or the run's
// 2^kr in f64; unitf the same scale as a float, or 0) to the int64 word at
// `w` in the shared memory of CTA `dst` of the cluster: one 64-bit add on
// the cluster address
template <typename T>
__device__ __forceinline__ void cluster_add(cg::cluster_group& cl, u64* w, int dst, T r,
                                            double scale, float unitf) {
  long long q;
  if constexpr (sizeof(T) == 4)
    q = unitf != 0.f ? __float2ll_rn(r * unitf) : __double2ll_rn((double)r * scale);
  else
    q = __double2ll_rn(r * scale);
  if (q != 0) atomicAdd(cl.map_shared_rank(w, dst), (u64)q);
}

// an int64 tile word t in units of 2^-kr as the 128-bit pair (lo, hi) in the
// global units 2^-(kr + shift): exact where shift >= 0, else rounded to
// nearest (ties to even)
__device__ __forceinline__ void tile_to_int128(long long t, int shift, u64& lo, u64& hi) {
  const bool neg = t < 0;
  const u64 m = neg ? 0ull - (u64)t : (u64)t;
  if (shift >= 64) {
    lo = 0ull;
    hi = m << (shift - 64);
  } else if (shift > 0) {
    lo = m << shift;
    hi = m >> (64 - shift);
  } else if (shift == 0) {
    lo = m;
    hi = 0ull;
  } else {
    const int r = -shift;
    u64 q = r >= 64 ? 0ull : m >> r;
    const u64 rem = r >= 64 ? m : m & ((1ull << r) - 1ull);
    const u64 half = r > 64 ? ~0ull : 1ull << (r - 1);
    if (r <= 64 && (rem > half || (rem == half && (q & 1ull)))) ++q;
    lo = q;
    hi = 0ull;
  }
  if (neg) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
}

// K row taps from a staged kv row (by residue class), 16 bytes a load
// where the rows allow it, into registers (no address of ky is taken: an
// addressed array goes to the stack)
template <int K>
__device__ __forceinline__ void load_rows(const float* p, float (&ky)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      ky[j] = t.x;
      ky[j + 1] = t.y;
      ky[j + 2] = t.z;
      ky[j + 3] = t.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + j);
      ky[j] = t.x;
      ky[j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) ky[j] = p[j];
  }
}
template <int K>
__device__ __forceinline__ void load_rows(const double* p, double (&ky)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const double2 t = *reinterpret_cast<const double2*>(p + j);
      ky[j] = t.x;
      ky[j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) ky[j] = p[j];
  }
}

// K rows of a column a thread (wide_choice). A cluster of CTAs serves the
// units [per c, per (c + 1)), one run of consecutive units of one segment
// at a time: a run's entries are one stream shared by the cluster's walks,
// and its tile is overlap-added once.
template <typename T, int K>
__global__ void __launch_bounds__(wide_most(sizeof(T) == 8), 1)
    unit_tiles_wide_kernel(const T* __restrict__ u, const T* __restrict__ v,
                           const T* __restrict__ vals,
                           const T* __restrict__ ulo,
                           const T* __restrict__ vlo,
                           const int* __restrict__ unit_seg,
                           const int* __restrict__ unit_start,
                           const int* __restrict__ unit_count,
                           const double* __restrict__ vsum,
                           u64* __restrict__ grid64, int npix, int tile,
                           int nta, int S, int lstage, int nunits, int per,
                           T beta) {
  constexpr int kW = Fixed<T>::kWords;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int threads = blockDim.x;
  const WideGeom gm = wide_geom<T>(S, tile, K, threads, cs, lstage);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* coords = reinterpret_cast<T*>(smem_raw);
  T* taps = reinterpret_cast<T*>(smem_raw + gm.taps);
  int4* meta = reinterpret_cast<int4*>(smem_raw + gm.meta);
  T* mval = reinterpret_cast<T*>(smem_raw + gm.mval);
  int* red = reinterpret_cast<int*>(smem_raw + gm.red);
  u64* acc = reinterpret_cast<u64*>(smem_raw + gm.acc);
  const int nb = gm.rb * gm.ld;  // values of one component's band
  const int buf = tile + S;
  const int half = S / 2;
  const int stage = 1 << lstage;
  const int cst = gm.cst;

  const double total = vsum[0];
  if (!isfinite(total)) return;  // the whole cluster leaves; the conversion writes NaN
  const int kg = fixed_exponent<T>(total);
  const double scale = ldexp(1.0, kg);
  // an f32 sum times 2^kg is exact in f32 as in f64 and rounds to the same
  // integer, where 2^kg is a float
  const float unitf = kg <= 127 ? ldexpf(1.f, kg) : 0.f;
  const int ntiles = nta * nta;

  // stage-1 role: taps [r1, r2) of the staged axis rows p1, p1 + pstep, ...
  // (row 2 sl + axis: axis 0 the entry's v taps, 1 its u taps)
  const int pstep = threads / gm.nr;
  const int p1 = threadIdx.x / gm.nr;
  const int r1 = (threadIdx.x - p1 * gm.nr) * gm.rt;
  const int r2 = min(S, r1 + gm.rt);
  const float invs = 1.f / S;
  // walk role: walk g of the CTA; the thread owns the classes (a, b0 + j),
  // j < nvalid, of residue period S. Each class has exactly one cell in
  // every window: column ru + ((a - ru) mod S) and row rv + ((b0 + j - rv)
  // mod S) of a window of corner (ru, rv)
  const int g = threadIdx.x / gm.group;
  const bool walker = g < gm.walks;
  const int rr = threadIdx.x - g * gm.group;
  const int a = rr / gm.nbb;
  const int b0 = (rr - a * gm.nbb) * K;
  const int nvalid = walker ? min(K, S - b0) : 0;
  const float rinv = 1.f / gm.rb;
  const int held = cs * gm.rb;  // the bands' rows: the tile's, or fewer

  const int c1 = min(nunits, (int)(blockIdx.x / cs + 1) * per);
  for (int c0 = (blockIdx.x / cs) * per; c0 < c1;) {
    // the run: units [c0, ce) of one segment, entries [start, end)
    const int seg = unit_seg[c0];
    int ce = c0 + 1;
    while (ce < c1 && unit_seg[ce] == seg &&
           unit_start[ce] == unit_start[ce - 1] + unit_count[ce - 1])
      ++ce;
    const int rstart = unit_start[c0];
    const int rend = unit_start[ce - 1] + unit_count[ce - 1];
    c0 = ce;
    const int plane = seg / ntiles;
    const int t = seg - plane * ntiles;
    const int tv0 = (t / nta) * tile;
    const int tu0 = (t % nta) * tile;
    // Where the bands hold fewer rows than the tile (large tiles), the run
    // is served in turns: the longest stretch of its entries whose windows
    // the bands hold (a segment's entries follow their window's corner
    // row, floor(v) - (half - 1)), the bands starting at the stretch's
    // first window row. Each turn is a run of its own: its units (f64),
    // its walks' flushes and its overlap-add. yb: the bands' first row,
    // from the margin row 0.
    for (int start = rstart, end; start < rend; start = end) {
      end = rend;
      int yb = 0;
      if (held < gm.rows) {
        yb = max(0, (int)floor_(v[start]) - (half - 1) - tv0);
        // the last corner row whose window (rows r - (half - 1) - tv0 up to S
        // + 1 of them, from the margin) ends in the bands
        const int last = yb + held - S - 1 + (half - 1) + tv0;
        int lo = start + 1, hi = rend;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((int)floor_(v[mid]) > last) hi = mid;
          else lo = mid + 1;
        }
        end = lo;
      }
      // the turn's rows of the tile, from the margin row 0: a window starts
      // at most one row before its hi coordinate's corner row
      __syncthreads();  // the previous turn's overlap-add has read the band and its rows
      u64* rmax = reinterpret_cast<u64*>(red + 2);
      if (threadIdx.x == 0) {
        red[0] = INT_MAX;
        red[1] = INT_MIN;
        *rmax = 0ull;
      }
      __syncthreads();
      int rlo = INT_MAX, rhi = INT_MIN;
      double vmax = 0.0;  // the run's largest |re| + |im| (f64)
      for (int p = start + threadIdx.x; p < end; p += threads) {
        const int r = (int)floor_(v[p]);
        rlo = min(rlo, r);
        rhi = max(rhi, r);
        if constexpr (kW == 2) vmax = fmax(vmax, fabs((double)vals[2 * (size_t)p]) +
                                                       fabs((double)vals[2 * (size_t)p + 1]));
      }
      rlo = __reduce_min_sync(0xffffffffu, rlo);
      rhi = __reduce_max_sync(0xffffffffu, rhi);
      if constexpr (kW == 2) {
        // non-negative doubles order as their bits
        u64 b = (u64)__double_as_longlong(vmax);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const u64 ob = __shfl_xor_sync(0xffffffffu, b, o);
          b = ob > b ? ob : b;
        }
        if ((threadIdx.x & 31) == 0) atomicMax(rmax, b);
      }
      if ((threadIdx.x & 31) == 0) {
        atomicMin(red, rlo);
        atomicMax(red + 1, rhi);
      }
      __syncthreads();
      // f64: the run's own units 2^-kr, 2^(61 - kr) above count x its largest
      // value (every cell of the run), one int64 word a value in the tile;
      // the overlap-add puts them into the launch units, 2^wshift finer
      double rscale = scale;
      int wshift = 0;
      if constexpr (kW == 2) {
        int er = 0;
        frexp((double)(end - start) * __longlong_as_double((long long)*rmax), &er);
        const int kr = 61 - er;
        rscale = ldexp(1.0, kr);
        wshift = kg - kr;
      }
      const int y0 = max(0, red[0] - (half - 1) - tv0);
      const int y1 = min(gm.rows, red[1] - (half - 1) - tv0 + S + 1);
      // this CTA's band of the turn's rows; ys its first row
      const int ys = yb + rank * gm.rb;
      const int z0 = max(y0, ys);
      const int z1 = min(y1, ys + gm.rb);
      const int zn = max(0, z1 - z0) * gm.ld;
      for (int c = 0; c < 2; ++c) {
        u64* zp = acc + ((size_t)c * nb + (size_t)(z0 - ys) * gm.ld);
        for (int i = threadIdx.x; i < zn; i += threads) zp[i] = 0ull;
      }
      // every band is zero before any CTA of the cluster adds to it
      cluster.sync();

      // walk w of the cluster's cs * walks takes [start + w q, start + (w + 1) q)
      const int count = end - start;
      const int nwalks = cs * gm.walks;
      const int q = (count + nwalks - 1) / nwalks;
      const int nbatch = (q + stage - 1) >> lstage;
      auto pos_of = [&](int k, int sl) {
        const int w = rank * gm.walks + (sl >> lstage);
        const int p = start + w * q + (k << lstage) + (sl & (stage - 1));
        return p < min(start + (w + 1) * q, end) ? p : -1;
      };
      // batch k's coordinates and values into coordinate buffer b by cp.async
      auto issue = [&](int k, int b) {
        T* cb = coords + (size_t)b * 6 * cst;
        for (int sl = threadIdx.x; sl < gm.slots; sl += threads) {
          const int p = pos_of(k, sl);
          if (p < 0) continue;
          ska_cp_async<sizeof(T)>(cb + sl, u + p);
          ska_cp_async<sizeof(T)>(cb + cst + sl, v + p);
          if (ulo != nullptr) {
            ska_cp_async<sizeof(T)>(cb + 2 * cst + sl, ulo + p);
            ska_cp_async<sizeof(T)>(cb + 3 * cst + sl, vlo + p);
          }
          ska_cp_async<2 * sizeof(T)>(cb + 4 * cst + 2 * sl, vals + 2 * (size_t)p);
        }
        ska_cp_async_commit();
      };
      // stage 1: batch k's taps from coordinate buffer b, one tap an item,
      // stored by residue class (tap r of a window starting at cell r0 is
      // class (r0 + r) mod S), and each entry's corner, residues and value
      auto stage1 = [&](int k, int b) {
        const T* cb = coords + (size_t)b * 6 * cst;
        T* tb = taps + (size_t)(k & 1) * gm.slots * 2 * gm.sp;
        int* mb = reinterpret_cast<int*>(meta + (k & 1) * gm.slots);
        T* vb = mval + (size_t)(k & 1) * gm.slots * 2;
        if (p1 >= pstep) return;
        for (int pr = p1; pr < 2 * gm.slots; pr += pstep) {
          const int sl = pr >> 1;
          const int axis = pr & 1;  // 0: v (rows), 1: u (columns)
          if (pos_of(k, sl) < 0) continue;
          const T pix = cb[(1 - axis) * cst + sl];
          const T lo = ulo == nullptr ? T(0) : cb[(3 - axis) * cst + sl];
          const int t0 = axis == 0 ? tv0 : tu0;
          // the window of the S taps starts at floor(pix + lo) - (half - 1):
          // one cell lower than the hi coordinate's window when hi is an
          // integer and lo < 0 (|lo| < 1). Unit entries lie in the grid, so
          // only a tap left of cell 0 of the tile (r0 = -1, which the dense
          // form does not have either) falls outside; it lands in the margin
          const int shift = (pix == floor_(pix) && lo < T(0)) ? 1 : 0;
          const int r0 = (int)floor_(pix) - (half - 1) - shift - t0;
          const int res = r0 + S - (int)(((float)(r0 + S) + 0.5f) * invs) * S;
          const T d0 = sub_rn(T(t0), pix);
          T* row = tb + (size_t)pr * gm.sp;
          int c = res + r1;
          c -= c >= S ? S : 0;
#pragma unroll 4
          for (int r = r1; r < r2; ++r) {
            row[c] = es_tap(sub_rn(add_rn(d0, T(r0 + r)), lo), T(half), beta);
            c = c == S - 1 ? 0 : c + 1;
          }
          if (r1 == 0) {
            // int4 (ru, rv, u residue, v residue), the corners from the margin
            mb[4 * sl + 1 - axis] = r0 + 1;
            mb[4 * sl + 3 - axis] = res;
            if (axis == 0) {
              vb[2 * sl] = cb[4 * cst + 2 * sl];
              vb[2 * sl + 1] = cb[4 * cst + 2 * sl + 1];
            }
          }
        }
      };

      const int gbeg = start + (rank * gm.walks + g) * q;
      const int gend = min(gbeg + q, end);
      // the run's column, corner row and its residue, entries since the last
      // cut; the sums (re, im) of the K rows
      int curx = -1, currv = 0, curres = 0, since = 0;
      T sum[K][2];
#pragma unroll
      for (int j = 0; j < K; ++j) sum[j][0] = sum[j][1] = T(0);
      auto row_of = [&](int rv, int res, int j) {
        const int d = b0 + j - res;
        return rv + (d < 0 ? d + S : d);
      };
      // integer adds commute: the tile is the same whatever their order
      auto flush = [&](int j) {
        const int y = row_of(currv, curres, j) - yb;  // from the bands' first row
        const int dst = (int)(((float)y + 0.5f) * rinv);  // y / rb
        const size_t vi = (size_t)(y - dst * gm.rb) * gm.ld + curx;
        cluster_add(cluster, acc + vi, dst, sum[j][0], rscale, unitf);
        cluster_add(cluster, acc + nb + vi, dst, sum[j][1], rscale, unitf);
        sum[j][0] = sum[j][1] = T(0);
      };

      // coordinates two batches ahead (three buffers), taps one batch ahead
      // of the walk (two buffers): one barrier a batch
      int b = 0;
      issue(0, 0);
      ska_cp_async_wait_all();
      if (nbatch > 1) issue(1, 1);
      __syncthreads();
      for (int k = 0; k < nbatch; ++k) {
        stage1(k, b);
        ska_cp_async_wait_all();  // batch k + 1's copies
        if (k + 2 < nbatch) issue(k + 2, b == 0 ? 2 : b - 1);
        // batch k's taps and batch k + 1's coordinates are visible; every
        // thread is done with batch k - 1's taps and with the buffer of
        // batch k + 2's coordinates
        __syncthreads();
        b = b == 2 ? 0 : b + 1;
        if (!walker) continue;
        const int nj = min(stage, gend - (gbeg + (k << lstage)));
        const size_t s0 = (size_t)(k & 1) * gm.slots + ((size_t)g << lstage);
        const T* tb = taps + s0 * 2 * gm.sp;
        const int4* mb = meta + s0;
        const T* vb = mval + s0 * 2;
        for (int jj = 0; jj < nj; ++jj) {
          const int4 m = mb[jj];
          int dx = a - m.z;
          dx += dx < 0 ? S : 0;
          const int x = m.x + dx;
          if (x != curx || since == kRunCap) {
            // the column moved (or the runs are kRunCap long): every row's
            // cell changes
            if (curx >= 0) {
#pragma unroll
              for (int j = 0; j < K; ++j)
                if (j < nvalid) flush(j);
            }
            curx = x;
            if (since == kRunCap) since = 0;  // every thread's runs end together
            currv = m.y;
            curres = m.w;
          } else if (m.y != currv) {
            // the corner row moved: a row's cell changes where its row does
#pragma unroll
            for (int j = 0; j < K; ++j)
              if (j < nvalid && row_of(currv, curres, j) != row_of(m.y, m.w, j)) flush(j);
            currv = m.y;
            curres = m.w;
          }
          ++since;
          const T* tp = tb + (size_t)jj * 2 * gm.sp;
          const T kx = tp[gm.sp + a];
          const T lr = vb[2 * jj] * kx, li = vb[2 * jj + 1] * kx;
          T ky[K];
          load_rows<K>(tp + b0, ky);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            sum[j][0] = fma_(ky[j], lr, sum[j][0]);
            sum[j][1] = fma_(ky[j], li, sum[j][1]);
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

      // overlap-add of the band: the tile and its halo into the integer plane
      // grids; the margin row and column are not the tile's, untouched cells
      // are zero and skipped, halo cells past the grid edge are zero (unit
      // entries lie in the grid) and skipped
      for (int i = threadIdx.x; i < (z1 - z0) * buf; i += threads) {
        const int yy = i / buf;
        const int y = z0 + yy;
        const int x = i - yy * buf;  // the tile's column: value column x + 1
        if (y == 0) continue;
        const int gy = tv0 + y - 1;
        const int gx = tu0 + x;
        if (gy >= npix || gx >= npix) continue;
        const size_t vi = (size_t)(y - ys) * gm.ld + x + 1;
        u64* gp = grid64 + 2 * kW * (((size_t)plane * npix + gy) * npix + gx);
        if constexpr (kW == 1) {
          words_add(gp, &acc[vi], 1);
          words_add(gp + 1, &acc[nb + vi], 1);
        } else {
          u64 w[2];
          tile_to_int128((long long)acc[vi], wshift, w[0], w[1]);
          words_add(gp, w, 2);
          tile_to_int128((long long)acc[nb + vi], wshift, w[0], w[1]);
          words_add(gp + 2, w, 2);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Route 4: supports past 64 and tiles of which no cluster's bands hold one
// window's rows (support 1 launches nothing: its taps are zero).

constexpr int kBandWaves = 16;  // about this many route-4 clusters an SM serves

// Launch geometry of route 4's sub-tile kernel at support S on tiles of
// `tile` cells: the walks (Romein's, at residue period S; a walk's classes
// in slices over nsl CTAs where they outgrow one) and the integer cells of
// a sub-tile of tr x tc window corners and its halo, held in bands of rows
// by the cs CTAs of a cluster
struct BandGeom {
  int k;        // rows of one column a thread owns
  int threads;  // of a CTA (0: no geometry fits)
  int nbb;      // row blocks of a column: ceil(S / k)
  int group;    // classes of one walk: S columns times nbb row blocks
  int nsl;      // CTAs of one walk (1, 2, 4 or 8), each a slice of its classes
  int walks;    // walks of a CTA (1 where a walk takes several CTAs)
  int npass;    // passes of a walk's threads over its classes (past 8 CTAs' threads)
  int stage;    // entries a walk takes a batch
  int slots;    // entries whose taps a CTA holds a batch: its walks' batches
  int nbuf;     // tap buffers: 2, one barrier a batch; 1, two
  int sp;       // taps of a staged axis row (by residue class; 16-byte rows)
  int rt, nr;   // stage 1: rt consecutive taps of an axis row a thread, nr such blocks a row
  int cs;       // CTAs of a cluster: each holds a band of rb rows of the sub-tile
  int tr, tc;   // window corners of a sub-tile: rows and columns
  int rows;     // rows of a sub-tile held: tr + S + 1 (row 0 the margin)
  int rb;
  int ld;       // values a held row: tc + S + 1 (column 0 the margin), odd
  size_t meta, mval, red, seg, acc, smem;  // byte offsets of the arrays; total
};

// The clipped form (band_clip), where the cluster's bands hold fewer rows
// than a sub-tile's, cs rb < rows: the held cells in blocks of cs rb rows by
// ld - 1 columns, a slot's sp taps the kv of a CTA's rb rows and the ku of
// the block's columns. (Kept out of BandGeom's fields: the kernel's
// parameters grew past what the whole form's launches run fastest with.)
__host__ __device__ inline bool band_clipped(const BandGeom& g) { return g.cs * g.rb < g.rows; }

template <typename T>
inline BandGeom band_geom(int S, int k, int threads, int nsl, int cs, int stage, int nbuf,
                          int tr, int tc) {
  BandGeom g;
  g.k = k;
  g.threads = threads;
  g.nbb = (S + k - 1) / k;
  g.group = S * g.nbb;
  g.nsl = nsl;
  g.walks = nsl > 1 ? 1 : threads / g.group;
  g.npass = nsl > 1 ? (g.group + nsl * threads - 1) / (nsl * threads) : 1;
  g.stage = stage;
  g.slots = g.walks * stage;
  g.nbuf = nbuf;
  const int vec = 16 / (int)sizeof(T);
  const int taps = S > g.nbb * k ? S : g.nbb * k;
  g.sp = (taps + vec - 1) / vec * vec;
  // the block of taps a stage-1 thread computes (the walk's nsl CTAs share
  // a batch's taps), as the wide variant picks it
  const int all = nsl * threads;
  int best = 1 << 30;
  for (int r = 1; r <= S; ++r) {
    const int nr = (S + r - 1) / r;
    const int rows = all / nr;
    if (rows < 1) continue;
    const int w = (2 * g.slots + rows - 1) / rows * (r + 1);
    if (w <= best) {
      best = w;
      g.rt = r;
    }
  }
  g.nr = (S + g.rt - 1) / g.rt;
  g.cs = cs;
  g.tr = tr;
  g.tc = tc;
  g.rows = tr + S + 1;
  g.ld = (tc + S + 1) | 1;
  g.rb = (g.rows + cs - 1) / cs;
  // taps [nbuf][slots][kv, ku][sp]; meta [nbuf][slots] int4; mval
  // [nbuf][slots][2]; red [2] int and one u64; seg [4][tr + 1] int (per
  // corner row: its first entry in the sub-tile, the prefix of their
  // counts, its first entry not yet served, its end); acc [re, im][rb][ld]
  // int64
  g.meta = align16((size_t)nbuf * g.slots * 2 * g.sp * sizeof(T));
  g.mval = align16(g.meta + (size_t)nbuf * g.slots * 16);
  g.red = align16(g.mval + (size_t)nbuf * g.slots * 2 * sizeof(T));
  g.seg = g.red + 16;
  g.acc = align16(g.seg + 4 * (size_t)(tr + 1) * sizeof(int));
  g.smem = g.acc + 2 * (size_t)g.ld * sizeof(u64) * g.rb;
  return g;
}

// The most window corner rows (up to the tile) of a sub-tile of tc columns
// that cs CTAs hold beside their staging; 0 where not one
template <typename T>
inline BandGeom band_rows(int S, int tile, int k, int threads, int nsl, int cs, int stage,
                          int nbuf, int tc) {
  int lo = 0, hi = tile;  // the smem grows with tr
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (band_geom<T>(S, k, threads, nsl, cs, stage, nbuf, mid, tc).smem <= kMaxSmem) lo = mid;
    else hi = mid - 1;
  }
  BandGeom g = band_geom<T>(S, k, threads, nsl, cs, stage, nbuf, lo > 0 ? lo : 1, tc);
  if (lo == 0) g.threads = 0;
  return g;
}

// The clipped form, where no cluster holds one sub-tile's held rows whole
// (a window past about 330 cells): sub-tiles of min(tile, 2 S, 1024)
// corners a side whose held cells 8 CTAs serve in blocks, each CTA rb = 8
// nbk rows of a block by wb columns, a thread 8 rows of one column (wb nbk
// threads); nbk the row blocks nearest to a square block (8 rb about wb),
// then the widest wb (multiples of 32) and the largest batch (64 entries
// down to 1, two tap buffers before one) that fit. threads 0 where none
// fits.
template <typename T>
inline BandGeom band_clip(int S, int tile) {
  const int most = wide_most(sizeof(T) == 8);
  const int t = min(min(tile, 2 * S), 1024);
  int nbk = 1;
  while ((nbk + 1) * (nbk + 1) * 64 <= most) ++nbk;
  BandGeom g = band_geom<T>(S, 8, most, 1, 8, 1, 1, t, t);
  g.nsl = g.walks = g.npass = 1;
  g.rt = g.nr = 1;
  g.group = most;
  for (; nbk >= 1; --nbk)
    for (int wb = most / nbk / 32 * 32; wb >= 32; wb -= 32)
      for (int stage = 64; stage >= 1; stage /= 2)
        for (int nbuf = 2; nbuf >= 1; --nbuf) {
          g.threads = nbk * wb;
          g.stage = g.slots = stage;
          g.nbuf = nbuf;
          g.rb = 8 * nbk;  // a multiple of the taps a 16-byte load holds
          g.ld = wb | 1;   // wb even
          g.sp = g.rb + wb;
          if (!band_clipped(g)) continue;  // the whole form serves such a sub-tile
          // taps [nbuf][stage][kv rows, ku columns]; meta: a batch's
          // entries [stage] int4 and [stage][4] T; mval [nbuf][stage][2];
          // red; seg [6][t + 1] (the whole form's and, per corner row, its
          // first entry in the block and the prefix of their counts); acc
          g.meta = align16((size_t)nbuf * stage * g.sp * sizeof(T));
          g.mval = align16(g.meta + (size_t)stage * (16 + 4 * sizeof(T)));
          g.red = align16(g.mval + (size_t)nbuf * stage * 2 * sizeof(T));
          g.seg = g.red + 16;
          g.acc = align16(g.seg + 6 * (size_t)(t + 1) * sizeof(int));
          g.smem = g.acc + 2 * (size_t)g.ld * sizeof(u64) * g.rb;
          if (g.smem <= kMaxSmem) return g;
        }
  g.threads = 0;
  return g;
}

// Rows a thread and threads a CTA: the wide variant's choice up to a
// support of 64; past it 8 rows a thread and a walk's classes over the
// fewest CTAs (1, 2, 4 or 8) of at most the most threads, further passes
// past 8. Sub-tiles of 64 corner columns (128 past a support of 64; the
// tile where it is narrower) and the least cluster whose CTAs hold 32
// corner rows (the tile's where fewer) beside batches of 16, 32 or 8
// entries a walk, with the most rows it holds; failing that 8 CTAs and
// the most rows beside smaller batches, on narrower sub-tiles if need be.
// threads 0 where no cluster holds one window.
template <typename T>
inline BandGeom band_plan(int S, int tile) {
  const bool f64 = sizeof(T) == 8;
  const int most = wide_most(f64);
  int k = 8, threads = most, nsl = 1;
  if (S <= 64) {
    wide_choice(S, f64, k, threads);
  } else {
    const int group = S * ((S + 7) / 8);
    while (nsl < 8 && group > nsl * most) nsl *= 2;
    const int per = (group + nsl - 1) / nsl;
    threads = min(most, (per + 31) / 32 * 32);
  }
  const int tc = min(tile, S <= 64 ? 64 : 128);
  const int want = min(tile, 32);
  constexpr int kStages[] = {16, 32, 8};
  for (int cs = nsl; cs <= 8; cs *= 2)
    for (const int stage : kStages) {
      const BandGeom g = band_rows<T>(S, tile, k, threads, nsl, cs, stage, 2, tc);
      if (g.threads && g.tr >= want) return g;
    }
  for (int c = tc; c >= 1; c /= 2)
    for (int stage = 8; stage >= 1; stage /= 2)
      for (int nbuf = 2; nbuf >= 1; --nbuf) {
        const BandGeom g = band_rows<T>(S, tile, k, threads, nsl, 8, stage, nbuf, c);
        if (g.threads) return g;
      }
  return band_clip<T>(S, tile);
}

// K rows of a column a thread. A cluster of gm.cs CTAs serves the units
// [per c, per (c + 1)), one run of consecutive units of one segment at a
// time, a sub-tile after another: gm.tr rows of window corners of the run
// by gm.tc columns, its entries the run's stretch of each corner row with
// its corner in those columns (a segment's entries follow their window
// corner, row by row), found by binary search; its cells and halo, every
// window of its entries whole, held in bands of rb rows over the
// cluster's CTAs, with a margin row and column for the window's cell left
// of the sub-tile. Each walk (Romein's, at period S; its classes in slices
// over gm.nsl CTAs where they outgrow one, a thread's K rows of a column,
// blk-major) takes a contiguous share of the sub-tile's entries; stage 1
// computes each batch's taps once for the walk, spread over its CTAs, and
// writes them into each of their shared memories (distributed shared
// memory where the walk spans CTAs). A register run is flushed as one
// 64-bit add on the cluster address (into the CTA's own shared memory
// where one CTA holds the sub-tile), each sub-tile goes into grid64 once,
// in one overlap-add, and f64 flushes in the sub-tile's own units, as the
// wide variant's runs do.
template <typename T, int K, bool kClip>
__global__ void __launch_bounds__(wide_most(sizeof(T) == 8), 1)
    unit_tiles_band_kernel(const T* __restrict__ u, const T* __restrict__ v,
                           const T* __restrict__ vals, const T* __restrict__ ulo,
                           const T* __restrict__ vlo, const int* __restrict__ unit_seg,
                           const int* __restrict__ unit_start,
                           const int* __restrict__ unit_count,
                           const double* __restrict__ vsum, u64* __restrict__ grid64,
                           int npix, int tile, int nta, int S, const BandGeom gm, int nunits,
                           int per, T beta) {
  constexpr int kW = Fixed<T>::kWords;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gm.cs;
  const int rank = (int)cluster.block_rank();
  const int threads = gm.threads;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* taps = reinterpret_cast<T*>(smem_raw);
  int4* meta = reinterpret_cast<int4*>(smem_raw + gm.meta);
  T* mval = reinterpret_cast<T*>(smem_raw + gm.mval);
  int* red = reinterpret_cast<int*>(smem_raw + gm.red);
  // [tr + 1] each: a corner row's first entry in the sub-tile, the prefix
  // of their counts, its first entry not yet served, its end
  int* first = reinterpret_cast<int*>(smem_raw + gm.seg);
  int* pre = first + gm.tr + 1;
  int* cur = pre + gm.tr + 1;
  int* rowend = cur + gm.tr + 1;
  u64* acc = reinterpret_cast<u64*>(smem_raw + gm.acc);
  const int nb = gm.rb * gm.ld;  // values of one component's band
  const int half = S / 2;
  const int stage = gm.stage;
  const int tr = gm.tr, tc = gm.tc;

  const double total = vsum[0];
  if (!isfinite(total)) return;  // the whole cluster leaves; the conversion writes NaN
  const int kg = fixed_exponent<T>(total);
  const double scale = ldexp(1.0, kg);
  // an f32 sum times 2^kg is exact in f32 as in f64 and rounds to the same
  // integer, where 2^kg is a float
  const float unitf = kg <= 127 ? ldexpf(1.f, kg) : 0.f;
  const int ntiles = nta * nta;

  // the walk: CTAs [wbase, wbase + nsl) of the cluster each hold a slice of
  // walk wid's classes; a CTA of one-CTA walks runs gm.walks of them
  const int nsl = gm.nsl;
  const int slice = rank % nsl;
  const int wbase = rank - slice;
  const int g = nsl > 1 ? 0 : tid / gm.group;
  const int wid = nsl > 1 ? rank / nsl : rank * gm.walks + g;
  const int nwalks = nsl > 1 ? cs / nsl : cs * gm.walks;
  // stage-1 role: taps [r1, r2) of the batch's axis rows p1, p1 + pstep,
  // ... (row 2 sl + axis: axis 0 the entry's v taps, 1 its u taps)
  const int gtid = slice * threads + tid;
  const int pstep = nsl * threads / gm.nr;
  const int p1 = gtid / gm.nr;
  const int r1 = (gtid - p1 * gm.nr) * gm.rt;
  const int r2 = min(S, r1 + gm.rt);
  const float rinv = 1.f / gm.rb;
  // walk role in pass ps: the classes (a, b0 + j), j < nvalid (0: none)
  int a = 0, b0 = 0, nvalid = 0;
  auto role = [&](int ps) {
    const int rr = nsl > 1 ? (ps * nsl + slice) * threads + tid : tid - g * gm.group;
    const bool walker = nsl > 1 ? rr < gm.group : g < gm.walks;
    const int blk = walker ? rr / S : 0;
    a = walker ? rr - blk * S : 0;
    b0 = blk * K;
    nvalid = walker ? min(K, S - b0) : 0;
  };
  role(0);
  // a barrier over the CTAs that share a batch's taps
  auto batch_sync = [&]() {
    if (nsl > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  const int c1 = min(nunits, (int)(blockIdx.x / cs + 1) * per);
  for (int c0 = (blockIdx.x / cs) * per; c0 < c1;) {
    // the run: units [c0, ce) of one segment, entries [rstart, rend)
    const int seg = unit_seg[c0];
    int ce = c0 + 1;
    while (ce < c1 && unit_seg[ce] == seg &&
           unit_start[ce] == unit_start[ce - 1] + unit_count[ce - 1])
      ++ce;
    const int rstart = unit_start[c0];
    const int rend = unit_start[ce - 1] + unit_count[ce - 1];
    c0 = ce;
    const int plane = seg / ntiles;
    const int t = seg - plane * ntiles;
    const int tv0 = (t / nta) * tile;
    const int tu0 = (t % nta) * tile;
    // an entry's window corner, tile-relative: floor(pix) - (half - 1) - t0
    // (one cell lower where the coordinate is an integer with a negative
    // residual); the run follows the corners' rows, then their columns
    const int rfirst = (int)floor_(v[rstart]) - (half - 1) - tv0;
    const int rlast = (int)floor_(v[rend - 1]) - (half - 1) - tv0;
    for (int R0 = rfirst; R0 <= rlast; R0 += tr) {
      // each corner row's stretch of the run, [cur, rowend): its entries
      // not yet served
      __syncthreads();  // the previous sub-tile is done with cur and rowend
      for (int i = tid; i < tr; i += threads) {
        const int fv = R0 + i + (half - 1) + tv0;  // floor(v) of the corner row
        int b[2];
        for (int e = 0; e < 2; ++e) {
          int l = e ? b[0] : rstart, h = rend;
          while (l < h) {
            const int mid = (l + h) >> 1;
            if ((int)floor_(v[mid]) < fv + e) l = mid + 1;
            else h = mid;
          }
          b[e] = l;
        }
        cur[i] = b[0];
        rowend[i] = b[1];
      }
      for (int C0 = 0; C0 < tile; C0 += tc) {
        // the sub-tile's entries: on corner row R0 + i, those left of column
        // C0 + tc (the row's entries follow their corner's column)
        __syncthreads();  // the previous sub-tile is done with first, pre, red and the band
        for (int i = tid; i < tr; i += threads) {
          const int fu = C0 + tc + (half - 1) + tu0;  // floor(u) past the sub-tile
          const int lo = cur[i];
          int l = lo, h = rowend[i];
          while (l < h) {
            const int mid = (l + h) >> 1;
            if ((int)floor_(u[mid]) < fu) l = mid + 1;
            else h = mid;
          }
          first[i] = lo;
          pre[i + 1] = l - lo;
          cur[i] = l;
        }
        __syncthreads();
        if (tid == 0) {
          // and the first and last corner rows with entries
          red[0] = INT_MAX;
          red[1] = -1;
          pre[0] = 0;
          for (int i = 0; i < tr; ++i) {
            if (pre[i + 1] > 0) {
              red[0] = min(red[0], i);
              red[1] = i;
            }
            pre[i + 1] += pre[i];
          }
        }
        __syncthreads();
        const int count = pre[tr];
        if (count == 0) continue;  // uniform: every CTA of the cluster skips it
        // the sub-tile's i-th entry
        auto entry = [&](int i) {
          int l = 0, h = tr - 1;  // the corner row: pre[l] <= i < pre[l + 1]
          while (l < h) {
            const int mid = (l + h + 1) >> 1;
            if (pre[mid] <= i) l = mid;
            else h = mid - 1;
          }
          return first[l] + i - pre[l];
        };
        u64* rmax = reinterpret_cast<u64*>(red + 2);
        __syncthreads();  // every thread has read pre[tr]
        if (tid == 0) *rmax = 0ull;
        __syncthreads();
        double scl = scale;
        int wshift = 0;
        if constexpr (kW == 2) {
          double vmax = 0.0;  // the sub-tile's largest |re| + |im|
          for (int i = tid; i < count; i += threads) {
            const int p = entry(i);
            vmax = fmax(vmax, fabs((double)vals[2 * (size_t)p]) +
                                  fabs((double)vals[2 * (size_t)p + 1]));
          }
          // non-negative doubles order as their bits
          u64 bb = (u64)__double_as_longlong(vmax);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const u64 ob = __shfl_xor_sync(0xffffffffu, bb, o);
            bb = ob > bb ? ob : bb;
          }
          if ((tid & 31) == 0) atomicMax(rmax, bb);
          __syncthreads();
          // the sub-tile's own units 2^-kr, 2^(61 - kr) above count x its
          // largest value (every cell of the sub-tile), one int64 word a value
          // in the band; the overlap-add puts them into the launch units,
          // 2^wshift finer
          int er = 0;
          frexp((double)count * __longlong_as_double((long long)*rmax), &er);
          const int kr = 61 - er;
          scl = ldexp(1.0, kr);
          wshift = kg - kr;
        }
        if constexpr (kClip) {
          // no cluster holds a window whole: the held cells in blocks of hb
          // rows by wb columns (band_clip), every CTA's rb rows of a block
          // its own and every cell of them one thread's; a block is walked
          // by the entries whose windows meet its rows, in every CTA, with
          // each entry's taps over the block's rows and columns (zero
          // outside its window)
          const int y0 = red[0], y1 = min(gm.rows, red[1] + S + 1);
          const int hb = cs * gm.rb, wb = gm.ld - 1;  // a block's rows and columns
          const int cols = tc + S + 1;                // the sub-tile's held columns
          const int kvw = gm.rb;                      // a slot's kv taps, then its ku
          const int cc = tid % wb, blk = tid / wb;    // the thread's column and row block
          // [tr + 1] each: a corner row's first entry in the block, the prefix
          // of their counts
          int* bfirst = rowend + gm.tr + 1;
          int* bpre = bfirst + gm.tr + 1;
          // a batch's entries: int4 (entry, v corner, u corner, -) and
          // T (t0 - v, t0 - u, v residual, u residual), as stage 1 forms them
          int4* prep = reinterpret_cast<int4*>(smem_raw + gm.meta);
          T* prept = reinterpret_cast<T*>(prep + stage);
          for (int Y0 = y0; Y0 < y1; Y0 += hb)
            for (int X0 = 0; X0 < cols; X0 += wb) {
              const int wbw = min(wb, cols - X0);  // the block's columns
              // the block's entries: on corner rows i whose windows meet its
              // rows (Y0 - S <= i < Y0 + hb), those whose windows meet its
              // columns (a window starts at held column floor(u) - (half - 1)
              // - shift - tu0 + 1 - C0, shift 0 or 1, and spans S columns)
              const int ilo = max(0, Y0 - S), ihi = min(tr, Y0 + hb);
              if (ilo >= ihi || pre[ihi] == pre[ilo]) continue;  // uniform over the cluster
              __syncthreads();  // every thread is done with the previous block's entries
              const int fa = (half - 1) + tu0 + C0 - 1;
              for (int i = tid; i < tr; i += threads) {
                int b[2] = {first[i], first[i]};
                if (i >= ilo && i < ihi) {
                  const int h0 = first[i] + pre[i + 1] - pre[i];
                  for (int e = 0; e < 2; ++e) {
                    const int fu = e ? X0 + wbw + fa + 1 : X0 - S + 1 + fa;
                    int l = e ? b[0] : first[i], h = h0;
                    while (l < h) {
                      const int mid = (l + h) >> 1;
                      if ((int)floor_(u[mid]) < fu) l = mid + 1;
                      else h = mid;
                    }
                    b[e] = l;
                  }
                }
                bfirst[i] = b[0];
                bpre[i + 1] = b[1] - b[0];
              }
              __syncthreads();
              if (tid == 0) {
                bpre[0] = 0;
                for (int i = 0; i < tr; ++i) bpre[i + 1] += bpre[i];
              }
              __syncthreads();
              const int ecount = bpre[tr];
              if (ecount == 0) continue;  // uniform over the cluster
              // the block's i-th entry
              auto bentry = [&](int i) {
                int l = ilo, h = ihi - 1;  // the corner row: bpre[l] <= i < bpre[l + 1]
                while (l < h) {
                  const int mid = (l + h + 1) >> 1;
                  if (bpre[mid] <= i) l = mid;
                  else h = mid - 1;
                }
                return bfirst[l] + i - bpre[l];
              };
              // every CTA is done with the previous block's taps and band
              cluster.sync();
              for (int c = 0; c < 2; ++c)
                for (int i = tid; i < nb; i += threads) acc[(size_t)c * nb + i] = 0ull;
              const int nku = (wbw + cs - 1) / cs;  // the block's ku taps a CTA computes
              const int items = gm.rb + nku;
              // stage 1: batch k's taps into buffer b: each entry's corners,
              // offsets and value once, then each CTA its own rows' kv taps
              // and every cs-th column's ku taps, those into every CTA's
              // shared memory, in es_tap's operation order (the whole form's
              // bits)
              auto stage1c = [&](int k, int b) {
                T* tb = taps + (size_t)b * stage * gm.sp;
                T* vb = mval + (size_t)b * stage * 2;
                for (int sl = tid; sl < stage; sl += threads) {
                  const int i = k * stage + sl;
                  if (i >= ecount) break;
                  const int p = bentry(i);
                  int r0[2];
                  T d0[2], lo[2];
                  for (int axis = 0; axis < 2; ++axis) {
                    const T pix = axis == 0 ? v[p] : u[p];
                    lo[axis] = ulo == nullptr ? T(0) : (axis == 0 ? vlo[p] : ulo[p]);
                    const int t0 = axis == 0 ? tv0 : tu0;
                    const int shift = (pix == floor_(pix) && lo[axis] < T(0)) ? 1 : 0;
                    r0[axis] = (int)floor_(pix) - (half - 1) - shift - t0;
                    d0[axis] = sub_rn(T(t0), pix);
                  }
                  prep[sl] = make_int4(p, r0[0], r0[1], 0);
                  prept[4 * sl] = d0[0];
                  prept[4 * sl + 1] = d0[1];
                  prept[4 * sl + 2] = lo[0];
                  prept[4 * sl + 3] = lo[1];
                  vb[2 * sl] = vals[2 * (size_t)p];
                  vb[2 * sl + 1] = vals[2 * (size_t)p + 1];
                }
                __syncthreads();
                for (int it = tid; it < stage * items; it += threads) {
                  const int sl = it / items, t = it - sl * items;
                  if (k * stage + sl >= ecount) break;
                  const int axis = t < gm.rb ? 0 : 1;  // 0: v (rows), 1: u (columns)
                  const int x = axis == 0 ? t : rank + cs * (t - gm.rb);
                  if (axis == 1 && x >= wbw) continue;
                  const int4 m = prep[sl];
                  const int r0 = axis == 0 ? m.y : m.z;
                  // the tap's held row (column) and its place in the window
                  const int d = (axis == 0 ? Y0 + rank * gm.rb + t : X0 + x) -
                                (r0 + 1 - (axis == 0 ? R0 : C0));
                  T tap = T(0);
                  if (d >= 0 && d < S)
                    tap = es_tap(sub_rn(add_rn(prept[4 * sl + axis], T(r0 + d)),
                                        prept[4 * sl + 2 + axis]),
                                 T(half), beta);
                  T* row = tb + (size_t)sl * gm.sp;
                  if (axis == 0) {
                    row[t] = tap;
                  } else {
                    for (int q = 0; q < cs; ++q) *cluster.map_shared_rank(row + kvw + x, q) = tap;
                  }
                }
              };
              const bool walker = cc < wbw;
              int since = 0;
              T sum[K][2];
#pragma unroll
              for (int j = 0; j < K; ++j) sum[j][0] = sum[j][1] = T(0);
              // the sums into the thread's own cells (no other thread adds to them)
              auto flushc = [&]() {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                  const int yy = blk * K + j;
                  if (yy < gm.rb) {
                    const size_t vi = (size_t)yy * gm.ld + cc;
                    long long q0, q1;
                    if constexpr (sizeof(T) == 4) {
                      q0 = unitf != 0.f ? __float2ll_rn(sum[j][0] * unitf)
                                        : __double2ll_rn((double)sum[j][0] * scl);
                      q1 = unitf != 0.f ? __float2ll_rn(sum[j][1] * unitf)
                                        : __double2ll_rn((double)sum[j][1] * scl);
                    } else {
                      q0 = __double2ll_rn(sum[j][0] * scl);
                      q1 = __double2ll_rn(sum[j][1] * scl);
                    }
                    acc[vi] += (u64)q0;
                    acc[nb + vi] += (u64)q1;
                  }
                  sum[j][0] = sum[j][1] = T(0);
                }
              };
              // batch k from buffer b: a thread skips an entry whose ku tap of
              // its column is zero (the column lies outside the window)
              auto walk = [&](int k, int b) {
                const int nj = min(stage, ecount - k * stage);
                const T* tb = taps + (size_t)b * stage * gm.sp;
                const T* vb = mval + (size_t)b * stage * 2;
                for (int jj = 0; jj < nj; ++jj) {
                  const T* tp = tb + (size_t)jj * gm.sp;
                  const T kx = tp[kvw + cc];
                  if (kx == T(0)) continue;
                  const T lr = vb[2 * jj] * kx, li = vb[2 * jj + 1] * kx;
                  T ky[K];
                  load_rows<K>(tp + blk * K, ky);
#pragma unroll
                  for (int j = 0; j < K; ++j) {
                    sum[j][0] = fma_(ky[j], lr, sum[j][0]);
                    sum[j][1] = fma_(ky[j], li, sum[j][1]);
                  }
                  if (++since == kRunCap) {  // bounds a sequential sum
                    flushc();
                    since = 0;
                  }
                }
              };
              const int nbatch = (ecount + stage - 1) / stage;
              for (int k = 0; k < nbatch; ++k) {
                const int b = k % gm.nbuf;
                if (gm.nbuf == 1 && k > 0) cluster.sync();  // every CTA is done with batch k - 1
                stage1c(k, b);
                // batch k's taps are in every CTA; with two buffers, every
                // thread is done with batch k - 1's
                cluster.sync();
                if (walker) walk(k, b);
              }
              if (walker) flushc();
              __syncthreads();
              // overlap-add of the CTA's rows of the block, as below
              for (int i = tid; i < nb; i += threads) {
                const int yy = i / gm.ld;
                const int x = i - yy * gm.ld;
                const int ty = R0 - 1 + Y0 + rank * gm.rb + yy, tx = C0 - 1 + X0 + x;
                if (ty < 0 || tx < 0 || x >= wbw) continue;
                const int gy = tv0 + ty;
                const int gx = tu0 + tx;
                if (gy >= npix || gx >= npix) continue;
                u64* gp = grid64 + 2 * kW * (((size_t)plane * npix + gy) * npix + gx);
                if constexpr (kW == 1) {
                  words_add(gp, &acc[i], 1);
                  words_add(gp + 1, &acc[nb + i], 1);
                } else {
                  u64 w[2];
                  tile_to_int128((long long)acc[i], wshift, w[0], w[1]);
                  words_add(gp, w, 2);
                  tile_to_int128((long long)acc[nb + i], wshift, w[0], w[1]);
                  words_add(gp + 2, w, 2);
                }
              }
            }
        } else {
        // the held rows the windows reach, [y0, y1) (a window of corner row i
        // lies in held rows [i, i + S + 1), a row early where its corner is an
        // integer with a negative residual); this CTA's band of them, from its
        // first held row ys
        const int y0 = red[0], y1 = min(gm.rows, red[1] + S + 1);
        const int ys = rank * gm.rb;
        const int z0 = max(y0, ys), z1 = min(y1, ys + gm.rb);
        const int zn = max(0, z1 - z0) * gm.ld;
        u64* zb = acc + (size_t)(z0 - ys) * gm.ld;
        for (int c = 0; c < 2; ++c)
          for (int i = tid; i < zn; i += threads) zb[(size_t)c * nb + i] = 0ull;
        // every band is zero before any CTA of the cluster adds to it
        cluster.sync();

        // walk w of the cluster's nwalks takes the sub-tile's entries [w q,
        // (w + 1) q)
        const int q = (count + nwalks - 1) / nwalks;
        const int nbatch = (q + stage - 1) / stage;
        auto pos_of = [&](int k, int sl) {
          const int w = nsl > 1 ? wid : rank * gm.walks + sl / stage;
          const int i = w * q + k * stage + sl % stage;
          return i < min((w + 1) * q, count) ? entry(i) : -1;
        };
        // a value stage 1 computed, into the walk's CTAs' shared memories
        auto put = [&](auto* s, auto val) {
          if (nsl == 1) {
            *s = val;
          } else {
            for (int d = 0; d < nsl; ++d) *cluster.map_shared_rank(s, wbase + d) = val;
          }
        };
        // stage 1: batch k's taps into buffer b, one tap an item, stored by
        // residue class (tap r of a window starting at tile cell r0 is class
        // (r0 + r) mod S), and each entry's corner in the sub-tile's held
        // cells (from its margin row and column), residues and value. Only
        // a tap left of cell 0 of the tile (r0 = -1, which the dense form
        // does not have either) falls outside the tile; it lands in the
        // margin and is dropped
        auto stage1 = [&](int k, int b) {
          T* tb = taps + (size_t)b * gm.slots * 2 * gm.sp;
          int* mb = reinterpret_cast<int*>(meta + (size_t)b * gm.slots);
          T* vb = mval + (size_t)b * gm.slots * 2;
          if (p1 >= pstep) return;
          for (int pr = p1; pr < 2 * gm.slots; pr += pstep) {
            const int sl = pr >> 1;
            const int axis = pr & 1;  // 0: v (rows), 1: u (columns)
            const int p = pos_of(k, sl);
            if (p < 0) continue;
            const T pix = axis == 0 ? v[p] : u[p];
            const T lo = ulo == nullptr ? T(0) : (axis == 0 ? vlo[p] : ulo[p]);
            const int t0 = axis == 0 ? tv0 : tu0;
            const int shift = (pix == floor_(pix) && lo < T(0)) ? 1 : 0;
            const int r0 = (int)floor_(pix) - (half - 1) - shift - t0;
            const int res = (r0 + S) % S;
            const T d0 = sub_rn(T(t0), pix);
            T* row = tb + (size_t)pr * gm.sp;
            int c = res + r1;
            c -= c >= S ? S : 0;
            for (int r = r1; r < r2; ++r) {
              put(row + c, es_tap(sub_rn(add_rn(d0, T(r0 + r)), lo), T(half), beta));
              c = c == S - 1 ? 0 : c + 1;
            }
            if (r1 == 0) {
              // int4 (ru, rv, u residue, v residue), the corners in held cells
              put(mb + 4 * sl + 1 - axis, r0 + 1 - (axis == 0 ? R0 : C0));
              put(mb + 4 * sl + 3 - axis, res);
              if (axis == 0) {
                put(vb + 2 * sl, vals[2 * (size_t)p]);
                put(vb + 2 * sl + 1, vals[2 * (size_t)p + 1]);
              }
            }
          }
        };

        const int gbeg = wid * q;
        const int gend = min(gbeg + q, count);
        // the run's column, corner row and its residue, entries since the last
        // cut; the sums (re, im) of the K rows
        int curx = -1, currv = 0, curres = 0, since = 0;
        T sum[K][2];
#pragma unroll
        for (int j = 0; j < K; ++j) sum[j][0] = sum[j][1] = T(0);
        auto row_of = [&](int rv, int res, int j) {
          const int d = b0 + j - res;
          return rv + (d < 0 ? d + S : d);
        };
        // integer adds commute: the tile is the same whatever their order
        auto flush = [&](int j) {
          const int y = row_of(currv, curres, j);  // the held row
          const int dst = (int)(((float)y + 0.5f) * rinv);  // y / rb
          const size_t vi = (size_t)(y - dst * gm.rb) * gm.ld + curx;
          cluster_add(cluster, acc + vi, dst, sum[j][0], scl, unitf);
          cluster_add(cluster, acc + nb + vi, dst, sum[j][1], scl, unitf);
          sum[j][0] = sum[j][1] = T(0);
        };
        auto flush_all = [&]() {
          if (curx >= 0) {
#pragma unroll
            for (int j = 0; j < K; ++j)
              if (j < nvalid) flush(j);
          }
          curx = -1;
        };

        for (int k = 0; k < nbatch; ++k) {
          const int b = k % gm.nbuf;
          if (gm.nbuf == 1 && k > 0) batch_sync();  // the walks are done with batch k - 1
          stage1(k, b);
          // batch k's taps are visible; with two buffers, every thread is
          // done with batch k - 1's
          batch_sync();
          const int nj = min(stage, gend - (gbeg + k * stage));
          const size_t s0 = (size_t)b * gm.slots + (nsl > 1 ? 0 : (size_t)g * stage);
          const T* tb = taps + s0 * 2 * gm.sp;
          const int4* mb = meta + s0;
          const T* vb = mval + s0 * 2;
          for (int ps = 0; ps < gm.npass; ++ps) {
            if (gm.npass > 1) {
              role(ps);
              since = 0;
            }
            if (nvalid > 0) {
              for (int jj = 0; jj < nj; ++jj) {
                const int4 m = mb[jj];
                int dx = a - m.z;
                dx += dx < 0 ? S : 0;
                const int x = m.x + dx;
                if (x != curx || since == kRunCap) {
                  // the column moved (or the runs are kRunCap long): every
                  // row's cell changes
                  flush_all();
                  curx = x;
                  if (since == kRunCap) since = 0;  // every thread's runs end together
                  currv = m.y;
                  curres = m.w;
                } else if (m.y != currv) {
                  // the corner row moved: a row's cell changes where its row does
#pragma unroll
                  for (int j = 0; j < K; ++j)
                    if (j < nvalid && row_of(currv, curres, j) != row_of(m.y, m.w, j)) flush(j);
                  currv = m.y;
                  curres = m.w;
                }
                ++since;
                const T* tp = tb + (size_t)jj * 2 * gm.sp;
                const T kx = tp[gm.sp + a];
                const T lr = vb[2 * jj] * kx, li = vb[2 * jj + 1] * kx;
                T ky[K];
                load_rows<K>(tp + b0, ky);
#pragma unroll
                for (int j = 0; j < K; ++j) {
                  sum[j][0] = fma_(ky[j], lr, sum[j][0]);
                  sum[j][1] = fma_(ky[j], li, sum[j][1]);
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

        // overlap-add of the band: held cell (y, x) is the tile's (R0 - 1 + y,
        // C0 - 1 + x); tile row or column -1 (a window a cell early at the
        // tile's first row or column) is not the dense form's, untouched cells
        // are zero and skipped, halo cells past the grid edge are zero (unit
        // entries lie in the grid) and skipped
        for (int i = tid; i < zn; i += threads) {
          const int yy = i / gm.ld;
          const int x = i - yy * gm.ld;
          const int ty = R0 - 1 + z0 + yy, tx = C0 - 1 + x;
          if (ty < 0 || tx < 0 || x >= tc + S + 1) continue;
          const int gy = tv0 + ty;
          const int gx = tu0 + tx;
          if (gy >= npix || gx >= npix) continue;
          const size_t vi = (size_t)(z0 - ys + yy) * gm.ld + x;
          u64* gp = grid64 + 2 * kW * (((size_t)plane * npix + gy) * npix + gx);
          if constexpr (kW == 1) {
            words_add(gp, &acc[vi], 1);
            words_add(gp + 1, &acc[nb + vi], 1);
          } else {
            u64 w[2];
            tile_to_int128((long long)acc[vi], wshift, w[0], w[1]);
            words_add(gp, w, 2);
            tile_to_int128((long long)acc[nb + vi], wshift, w[0], w[1]);
            words_add(gp + 2, w, 2);
          }
        }
        }
      }
    }
  }
}

template <typename T, int K, bool kClip>
int launch_band_k(const BandGeom& gm, const void* u, const void* v, const void* vals,
                  const void* ulo, const void* vlo, const void* unit_seg,
                  const void* unit_start, const void* unit_count, const void* vsum,
                  void* grid64, int nunits, int npix, int tile, int nta, int support,
                  double beta, cudaStream_t s) {
  auto fn = unit_tiles_band_kernel<T, K, kClip>;
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
  // units a cluster: enough clusters for about kBandWaves of them on every
  // SM, each serving the runs that leaves (2 waves in place of 16, for
  // longer runs, took 1.2-1.6 times as long on phase 18's streams: the
  // densest runs then hold the launch)
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int per = max(1, (int)((long long)nunits * gm.cs / ((long long)sms * kBandWaves)));
  const int nclusters = (nunits + per - 1) / per;
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
  e = cudaLaunchKernelEx(&cfg, fn, (const T*)u, (const T*)v, (const T*)vals, (const T*)ulo,
                         (const T*)vlo, (const int*)unit_seg, (const int*)unit_start,
                         (const int*)unit_count, (const double*)vsum, (u64*)grid64, npix,
                         tile, nta, support, gm, nunits, per, (T)beta);
  if (e != cudaSuccess) return (int)e;
  return ska_last_error();
}

template <typename T>
int launch_band(const void* u, const void* v, const void* vals, const void* ulo,
                const void* vlo, const void* unit_seg, const void* unit_start,
                const void* unit_count, const void* vsum, void* grid64, int nunits, int npix,
                int tile, int nta, int support, double beta, cudaStream_t s) {
  const BandGeom gm = band_plan<T>(support, tile);
  if (gm.threads == 0) return (int)cudaErrorInvalidValue;  // not one row of a block fits
#define SKA_UNIT_TILES_BAND(K)                                                    \
  band_clipped(gm) ? launch_band_k<T, K, true>(gm, u, v, vals, ulo, vlo, unit_seg, unit_start, \
                                      unit_count, vsum, grid64, nunits, npix, tile,  \
                                      nta, support, beta, s)                         \
          : launch_band_k<T, K, false>(gm, u, v, vals, ulo, vlo, unit_seg, unit_start, \
                                       unit_count, vsum, grid64, nunits, npix, tile,  \
                                       nta, support, beta, s)
  switch (gm.k) {
    case 8: return SKA_UNIT_TILES_BAND(8);
    case 7: return SKA_UNIT_TILES_BAND(7);
    case 6: return SKA_UNIT_TILES_BAND(6);
    case 5: return SKA_UNIT_TILES_BAND(5);
    default: return SKA_UNIT_TILES_BAND(4);
  }
#undef SKA_UNIT_TILES_BAND
}

// The complex grids from the integer ones: value times 2^-kg, or NaN when
// the bound is not finite. n values (2 a cell).
template <typename T>
__global__ void unit_tiles_convert(const u64* __restrict__ grid64,
                                   T* __restrict__ grid, size_t n,
                                   const double* __restrict__ vsum) {
  const double total = vsum[0];
  const bool ok = isfinite(total);
  const int kg = ok ? fixed_exponent<T>(total) : 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    double val;
    if (Fixed<T>::kWords == 1) {
      val = ldexp((double)(long long)grid64[i], -kg);
    } else {
      u64 lo = grid64[2 * i], hi = grid64[2 * i + 1];
      const bool neg = (long long)hi < 0;
      if (neg) {
        lo = ~lo + 1ull;
        hi = ~hi + (lo == 0ull ? 1ull : 0ull);
      }
      val = ldexp((double)hi, 64 - kg) + ldexp((double)lo, -kg);
      val = neg ? -val : val;
    }
    grid[i] = ok ? (T)val : (T)__longlong_as_double(0x7ff8000000000000ll);
  }
}

// The narrow kernel's dynamic shared memory at an even support S (16 or
// less) on tiles of `tile` cells, the tile's rows `ld` values apart
template <typename T>
inline size_t narrow_smem(int S, int tile, int ld) {
  constexpr int kBatch = Batch<T>::kSize;
  return 2 * sizeof(Coords<T>) + kBatch * 2 * (size_t)S * sizeof(T) +
         2 * (size_t)(tile + S) * ld * Fixed<T>::kWords * sizeof(u64) +
         4 * kBatch * sizeof(int);
}

template <typename T, int S>
int launch(const void* u, const void* v, const void* vals, const void* ulo,
           const void* vlo, const void* unit_seg, const void* unit_start,
           const void* unit_count, const void* vsum, void* grid64,
           int nunits, int npix, int tile, int nta, double beta,
           cudaStream_t s) {
  const int buf = tile + S;
  int ld = buf + 1;  // padded rows against bank conflicts
  if (narrow_smem<T>(S, tile, ld) > kMaxSmem) ld = buf;  // unpadded: bank conflicts only
  const size_t smem = narrow_smem<T>(S, tile, ld);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // tile too large
  cudaFuncSetAttribute(unit_tiles_kernel<T, S>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaFuncSetAttribute(unit_tiles_kernel<T, S>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  unit_tiles_kernel<T, S><<<nunits, Groups<S>::kThreads, smem, s>>>(
      (const T*)u, (const T*)v, (const T*)vals, (const T*)ulo,
      (const T*)vlo, (const int*)unit_seg, (const int*)unit_start,
      (const int*)unit_count, (const double*)vsum, (u64*)grid64, npix, tile,
      nta, ld, (T)beta);
  return ska_last_error();
}

template <typename T, int K>
int launch_wide_k(const WideGeom& gm, const void* u, const void* v,
                  const void* vals, const void* ulo, const void* vlo,
                  const void* unit_seg, const void* unit_start,
                  const void* unit_count, const void* vsum, void* grid64,
                  int nunits, int npix, int tile, int nta, int support,
                  double beta, cudaStream_t s) {
  auto fn = unit_tiles_wide_kernel<T, K>;
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
  // units a cluster: enough clusters for about kWideWaves of them on every
  // SM, each serving the runs that leaves
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int per = max(1, (int)((long long)nunits * gm.cs / ((long long)sms * kWideWaves)));
  const int nclusters = (nunits + per - 1) / per;
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
  e = cudaLaunchKernelEx(&cfg, fn, (const T*)u, (const T*)v, (const T*)vals,
                         (const T*)ulo, (const T*)vlo, (const int*)unit_seg,
                         (const int*)unit_start, (const int*)unit_count,
                         (const double*)vsum, (u64*)grid64, npix, tile, nta,
                         support, gm.lstage, nunits, per, (T)beta);
  if (e != cudaSuccess) return (int)e;
  return ska_last_error();
}

template <typename T>
int launch_wide(const void* u, const void* v, const void* vals,
                const void* ulo, const void* vlo, const void* unit_seg,
                const void* unit_start, const void* unit_count,
                const void* vsum, void* grid64, int nunits, int npix,
                int tile, int nta, int support, double beta, cudaStream_t s) {
  const WideGeom gm = wide_plan<T>(support, tile);
  if (gm.cs == 0) return (int)cudaErrorInvalidValue;  // no cluster holds the tile
#define SKA_UNIT_TILES_WIDE(K)                                                 \
  launch_wide_k<T, K>(gm, u, v, vals, ulo, vlo, unit_seg, unit_start,         \
                      unit_count, vsum, grid64, nunits, npix, tile, nta,      \
                      support, beta, s)
  switch (gm.k) {
    case 8: return SKA_UNIT_TILES_WIDE(8);
    case 7: return SKA_UNIT_TILES_WIDE(7);
    case 6: return SKA_UNIT_TILES_WIDE(6);
    case 5: return SKA_UNIT_TILES_WIDE(5);
    default: return SKA_UNIT_TILES_WIDE(4);
  }
#undef SKA_UNIT_TILES_WIDE
}

// How ska_unit_tiles serves support S on tiles of `tile` cells: 0 it
// refuses it (S past the tile, or below 1); 1 the narrow kernel (even S to
// 16, the whole tile in one block); 2 the wide variant, the whole tile in
// its cluster's bands; 3 the wide variant in turns (its bands hold fewer
// rows than the tile's, at least one window's); 4 route 4 (support 1,
// supports past 64, and tiles no cluster's bands serve a window of).
template <typename T>
inline int unit_tiles_route(int S, int tile) {
  if (S < 1 || S > tile) return 0;
  if (S % 2 == 0 && S <= 16 && narrow_smem<T>(S, tile, tile + S) <= kMaxSmem) return 1;
  if (S >= 2 && S <= 64) {
    const WideGeom g = wide_plan<T>(S, tile);
    if (g.cs != 0) return g.cs * g.rb >= g.rows ? 2 : 3;
  }
  return S == 1 || band_plan<T>(S, tile).threads ? 4 : 0;
}

template <typename T>
int launch_support(const void* u, const void* v, const void* vals,
                   const void* ulo, const void* vlo, const void* unit_seg,
                   const void* unit_start, const void* unit_count,
                   const void* vsum, void* grid64, void* grid, int nunits,
                   int nplanes, int npix, int tile, int nta, int support,
                   double beta, cudaStream_t s) {
  const int route = unit_tiles_route<T>(support, tile);
  if (route == 0) return (int)cudaErrorInvalidValue;
  const size_t n = 2 * (size_t)nplanes * npix * npix;
  cudaMemsetAsync(grid64, 0, n * Fixed<T>::kWords * sizeof(u64), s);
  int rc = 0;
#define SKA_UNIT_TILES_CASE(S)                                               \
  case S:                                                                    \
    rc = launch<T, S>(u, v, vals, ulo, vlo, unit_seg, unit_start,            \
                      unit_count, vsum, grid64, nunits, npix, tile, nta,     \
                      beta, s);                                              \
    break;
  if (route == 4) {
    // support 1: the ES kernel of half width 0 is zero, so every tap is and
    // the grids are (the conversion writes NaN where the bound is not finite)
    if (support > 1)
      rc = launch_band<T>(u, v, vals, ulo, vlo, unit_seg, unit_start, unit_count,
                          vsum, grid64, nunits, npix, tile, nta, support, beta, s);
  } else if (route == 1) {
    switch (support) {
      SKA_UNIT_TILES_CASE(2)
      SKA_UNIT_TILES_CASE(4)
      SKA_UNIT_TILES_CASE(6)
      SKA_UNIT_TILES_CASE(8)
      SKA_UNIT_TILES_CASE(10)
      SKA_UNIT_TILES_CASE(12)
      SKA_UNIT_TILES_CASE(14)
      SKA_UNIT_TILES_CASE(16)
    }
  } else {
    // odd supports, supports past 16, and tiles the narrow kernel cannot
    // hold: the wide variant, where its cluster's bands serve the tile
    rc = launch_wide<T>(u, v, vals, ulo, vlo, unit_seg, unit_start,
                        unit_count, vsum, grid64, nunits, npix, tile, nta,
                        support, beta, s);
  }
#undef SKA_UNIT_TILES_CASE
  if (rc != 0) return rc;
  const size_t blocks = min((n + 255) / 256, (size_t)65536);
  unit_tiles_convert<T><<<(unsigned)blocks, 256, 0, s>>>(
      (const u64*)grid64, (T*)grid, n, (const double*)vsum);
  return ska_last_error();
}

}  // namespace

// u, v, ulo, vlo: [n] real (ulo and vlo both given or both null); vals: [n]
// complex (interleaved re, im); unit_*: [nunits] int32; vsum: [1] f64, the
// sum of |re| + |im| over vals (the bound of every cell); grid64: [nplanes,
// npix, npix, 2, words] int64 scratch (words 1 for f32, 2 for f64); grid:
// [nplanes, npix, npix] complex out. f64 selects double precision.
SKA_EXPORT int ska_unit_tiles(const void* u, const void* v, const void* vals,
                              const void* ulo, const void* vlo,
                              const void* unit_seg, const void* unit_start,
                              const void* unit_count, const void* vsum,
                              void* grid64, void* grid, int nunits,
                              int nplanes, int npix, int tile, int nta,
                              int support, double beta, int f64,
                              void* stream) {
  if (nunits <= 0 || nplanes <= 0 || npix <= 0) return (int)cudaErrorInvalidValue;
  if ((ulo == nullptr) != (vlo == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch_support<double>(u, v, vals, ulo, vlo, unit_seg,
                                  unit_start, unit_count, vsum, grid64, grid,
                                  nunits, nplanes, npix, tile, nta, support,
                                  beta, s);
  return launch_support<float>(u, v, vals, ulo, vlo, unit_seg, unit_start,
                               unit_count, vsum, grid64, grid, nunits,
                               nplanes, npix, tile, nta, support, beta, s);
}

// How ska_unit_tiles serves `support` on tiles of `tile` cells (f64 as its
// own), decided before any launch: 0 refused (a support past the tile, as
// the JAX package's tiled gridder refuses it), 1 the narrow kernel, 2 the
// wide variant holding the whole tile, 3 the wide variant in turns, 4
// route 4 (sub-tiles; no launch at support 1; windows clipped to blocks of
// the held cells past the largest window a cluster holds).
SKA_EXPORT int ska_unit_tiles_route(int support, int tile, int f64) {
  return f64 ? unit_tiles_route<double>(support, tile) : unit_tiles_route<float>(support, tile);
}

// Route 4's launch geometry at `support` (2 to the tile; it runs where
// ska_unit_tiles_route says 4) on tiles of `tile` cells, f64 as
// ska_unit_tiles's: what 0 the CTAs of a cluster, 1 the threads of a CTA,
// 2 its dynamic shared bytes, 3 its walks (1 where a walk spans CTAs), 4
// the rows of a column a thread owns, 5 the entries a walk takes a batch,
// 6 and 7 the rows and columns of window corners of a sub-tile, 8 the CTAs
// of one walk, 9 the passes of a walk's threads over its classes, 10 the
// tap buffers, 11 and 12 the held rows and columns of a block where the
// cluster serves a sub-tile's held cells in blocks, windows clipped to
// each (0 where it holds them whole); 0 past them, at support 1 (no
// launch) and where not one row of a block fits.
SKA_EXPORT int ska_unit_tiles_band_geometry(int support, int tile, int f64, int what) {
  if (support < 2 || support > tile) return 0;
  const BandGeom gm =
      f64 ? band_plan<double>(support, tile) : band_plan<float>(support, tile);
  if (gm.threads == 0) return 0;
  const bool clip = band_clipped(gm);
  const int v[] = {gm.cs,  gm.threads, (int)gm.smem, gm.walks, gm.k,
                   gm.stage, gm.tr,    gm.tc,        gm.nsl,   gm.npass,
                   gm.nbuf, clip ? gm.cs * gm.rb : 0, clip ? gm.ld - 1 : 0};
  return what >= 0 && what < 13 ? v[what] : 0;
}

// The wide variant's launch geometry at `support` (2 to 64 and the tile;
// it runs where ska_unit_tiles_route says 2 or 3) on tiles of `tile`
// cells, f64 as ska_unit_tiles's: what 0 the CTAs of a cluster, 1 the
// threads of a CTA, 2 its dynamic shared bytes, 3 its walks, 4 the rows of
// a column a thread owns, 5 the entries a walk stages a batch, 6 the rows
// of the tile (with its margin row) the cluster's bands hold (fewer than
// tile + support + 1: runs in turns); 0 where the bands over a cluster of
// 8 CTAs cannot hold one window's rows.
SKA_EXPORT int ska_unit_tiles_wide_geometry(int support, int tile, int f64, int what) {
  if (support < 2 || support > 64 || support > tile) return 0;
  const WideGeom gm = f64 ? wide_plan<double>(support, tile) : wide_plan<float>(support, tile);
  if (gm.cs == 0) return 0;
  const int v[] = {gm.cs, gm.threads, (int)gm.smem, gm.walks, gm.k, 1 << gm.lstage,
                   gm.cs * gm.rb};
  return what >= 0 && what < 7 ? v[what] : 0;
}
