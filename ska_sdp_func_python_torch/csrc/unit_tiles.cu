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
// unit_tiles_wide_kernel. A group of S^2 threads stops fitting a CTA past
// S 32, and the f64 pair tile (2 x 2 x buf^2 x 8 B: 248 KB at buf 88, tile
// 56 + S 32) stops fitting a block's shared memory, so the wide variant
// keeps no tile: its register sums go straight into the global
// fixed-point words (f32: one int64 word; f64: the 128-bit pair), as K1's
// wide variant does, with the same units, conversion and bits on every
// launch. The residue period is S (the tiled path's ES kernel has half
// width S // 2, so an odd S's non-zero taps, at most S - 1 of them, lie in
// the S cells from floor(pix) - (S // 2 - 1)). A CTA of 1024 threads runs
// 1024 / S^2 groups of S^2 threads where they fit, one class a thread, and
// past S 32 one group whose threads own ceil(S^2 / 1024) classes each (C,
// the template parameter). Stage 1 is the narrow kernel's, at S taps per
// axis; its sizes are the launch's, so its shared memory is sized at
// launch. What bounds it: stage 1's taps and the global atomics of the
// flushes.
#include "common.cuh"

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

constexpr int kWideThreads = 1024;

// the launch's sizes of the wide variant: groups of S^2 threads, entries
// of a group in a batch, and the shared-memory offsets of each array
struct WideLayout {
  int groups, ps, slots;
  size_t taps, rel, total;
};

template <typename T>
__host__ __device__ inline WideLayout wide_layout(int S) {
  WideLayout l;
  l.groups = S * S <= kWideThreads ? kWideThreads / (S * S) : 1;
  l.ps = Batch<T>::kSize / l.groups > 0 ? Batch<T>::kSize / l.groups : 1;
  l.slots = l.groups * l.ps;
  const size_t coords = 2 * (size_t)l.slots * 6 * sizeof(T);  // [2] batches
  l.taps = coords;
  // rel is read as int4: 16-byte aligned
  l.rel = (l.taps + (size_t)l.slots * 2 * S * sizeof(T) + 15) / 16 * 16;
  l.total = l.rel + (size_t)l.slots * 4 * sizeof(int);
  return l;
}

// C: classes a thread owns (the group's S^2 classes over its threads)
template <typename T, int C>
__global__ void __launch_bounds__(kWideThreads)
    unit_tiles_wide_kernel(const T* __restrict__ u, const T* __restrict__ v,
                           const T* __restrict__ vals,
                           const T* __restrict__ ulo,
                           const T* __restrict__ vlo,
                           const int* __restrict__ unit_seg,
                           const int* __restrict__ unit_start,
                           const int* __restrict__ unit_count,
                           const double* __restrict__ vsum,
                           u64* __restrict__ grid64, int npix, int tile,
                           int nta, int S, T beta) {
  constexpr int kW = Fixed<T>::kWords;
  const WideLayout lay = wide_layout<T>(S);
  const int slots = lay.slots, ps = lay.ps, ngroups = lay.groups;
  const int kHalf = S / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // coords[b]: u, v, ulo, vlo [slots] each, then val [slots][2]
  T* coords = reinterpret_cast<T*>(smem_raw);
  T* taps = reinterpret_cast<T*>(smem_raw + lay.taps);  // [slots][2][S]
  int* rel = reinterpret_cast<int*>(smem_raw + lay.rel);  // [slots][4]

  const double total = vsum[0];
  if (!isfinite(total)) return;  // the conversion writes NaN
  const double scale = ldexp(1.0, fixed_exponent<T>(total));

  const int seg = unit_seg[blockIdx.x];
  const int start = unit_start[blockIdx.x];
  const int end = start + unit_count[blockIdx.x];
  const int ntiles = nta * nta;
  const int plane = seg / ntiles;
  const int t = seg - plane * ntiles;
  const int tv0 = (t / nta) * tile;
  const int tu0 = (t % nta) * tile;
  const int q = (unit_count[blockIdx.x] + ngroups - 1) / ngroups;
  const int nbatch = (q + ps - 1) / ps;
  auto pos_of = [&](int k, int sl) {
    const int g = sl / ps;
    const int p = start + g * q + k * ps + (sl - g * ps);
    return p < min(start + (g + 1) * q, end) ? p : -1;
  };
  auto field = [&](int b, int f) { return coords + (size_t)(6 * b + f) * slots; };
  const int nitems = (ulo != nullptr ? 5 : 3) * slots;
  auto issue = [&](int k) {
    const int b = k & 1;
    for (int i = threadIdx.x; i < nitems; i += kWideThreads) {
      const int item = i / slots;
      const int sl = i - item * slots;
      const int p = pos_of(k, sl);
      if (p < 0) continue;
      if (item == 0)
        ska_cp_async<2 * sizeof(T)>(field(b, 4) + 2 * sl, vals + 2 * (size_t)p);
      else if (item == 1)
        ska_cp_async<sizeof(T)>(field(b, 0) + sl, u + p);
      else if (item == 2)
        ska_cp_async<sizeof(T)>(field(b, 1) + sl, v + p);
      else if (item == 3)
        ska_cp_async<sizeof(T)>(field(b, 2) + sl, ulo + p);
      else
        ska_cp_async<sizeof(T)>(field(b, 3) + sl, vlo + p);
    }
    ska_cp_async_commit();
  };

  // stage 2 role: the classes (a, b) = (cls % S, cls / S) of group g
  const int kk = S * S;
  const int g = kk <= kWideThreads ? threadIdx.x / kk : 0;
  const bool active = g < ngroups;
  int ca[C], cb[C], cur[C], run[C];
  T re[C], im[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int cls = kk <= kWideThreads ? threadIdx.x % kk : threadIdx.x + kWideThreads * c;
    ca[c] = cls < kk ? cls % S : -1;  // -1: no class
    cb[c] = cls / S;
    cur[c] = -1;
    run[c] = 0;
    re[c] = im[c] = T(0);
  }
  const size_t npp = (size_t)npix * npix;
  u64* g0 = grid64 + 2 * kW * (size_t)plane * npp;
  // integer adds commute: the grids are the same whatever their order
  auto flush = [&](int c) {
    if (cur[c] >= 0) {
      u64* w = g0 + 2 * kW * (size_t)cur[c];
      fixed_add(w, re[c], scale);
      fixed_add(w + kW, im[c], scale);
    }
  };
  const int gbeg = start + g * q;
  const int gend = min(gbeg + q, end);

  issue(0);
  for (int k = 0; k < nbatch; ++k) {
    ska_cp_async_wait_all();
    __syncthreads();
    const int b = k & 1;
    const T* cu = field(b, 0);
    const T* cv = field(b, 1);
    const T* cul = field(b, 2);
    const T* cvl = field(b, 3);
    const T* cval = field(b, 4);
    // stage 1: the S taps of one axis of one entry per thread
    for (int i = threadIdx.x; i < 2 * slots; i += kWideThreads) {
      const int sl = i >> 1;
      const int axis = i & 1;  // 0: v (rows), 1: u (columns)
      if (pos_of(k, sl) < 0) continue;
      const T pix = axis == 0 ? cv[sl] : cu[sl];
      const T lo = ulo == nullptr ? T(0) : (axis == 0 ? cvl[sl] : cul[sl]);
      const int t0 = axis == 0 ? tv0 : tu0;
      const int shift = (pix == floor_(pix) && lo < T(0)) ? 1 : 0;
      const int r0 = (int)floor_(pix) - (kHalf - 1) - shift - t0;
      const T d0 = sub_rn(T(t0), pix);
      for (int r = 0; r < S; ++r)
        taps[(2 * sl + axis) * S + r] =
            es_tap(sub_rn(add_rn(d0, T(r0 + r)), lo), T(kHalf), beta);
      rel[4 * sl + 2 * axis] = r0;
      rel[4 * sl + 2 * axis + 1] = (r0 % S + S) % S;
    }
    if (k + 1 < nbatch) issue(k + 1);
    __syncthreads();
    if (!active) continue;
    const int nj = min(ps, gend - (gbeg + k * ps));
    for (int j = 0; j < nj; ++j) {
      const int sl = g * ps + j;
      const int4 rr = reinterpret_cast<const int4*>(rel)[sl];
      const T vr = cval[2 * sl], vi = cval[2 * sl + 1];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (ca[c] < 0) continue;
        int dy = cb[c] - rr.y;
        dy += dy < 0 ? S : 0;
        int dx = ca[c] - rr.w;
        dx += dx < 0 ? S : 0;
        const int y = rr.x + dy;
        const int x = rr.z + dx;
        if (y < 0 || x < 0) continue;  // before the tile: not in the dense form
        const T kv = taps[(2 * sl) * S + dy];
        const T ku = taps[(2 * sl + 1) * S + dx];
        if (kv == T(0) || ku == T(0)) continue;
        const int cell = (tv0 + y) * npix + tu0 + x;
        if (cell != cur[c] || run[c] == kRunCap) {
          flush(c);
          cur[c] = cell;
          run[c] = 0;
          re[c] = im[c] = T(0);
        }
        ++run[c];
        re[c] += mul_rn(mul_rn(kv, vr), ku);
        im[c] += mul_rn(mul_rn(kv, vi), ku);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) flush(c);
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

template <typename T, int S>
int launch(const void* u, const void* v, const void* vals, const void* ulo,
           const void* vlo, const void* unit_seg, const void* unit_start,
           const void* unit_count, const void* vsum, void* grid64,
           int nunits, int npix, int tile, int nta, double beta,
           cudaStream_t s) {
  constexpr int kBatch = Batch<T>::kSize;
  const int buf = tile + S;
  auto smem_of = [&](int ld) {
    return 2 * sizeof(Coords<T>) + kBatch * 2 * (size_t)S * sizeof(T) +
           2 * (size_t)buf * ld * Fixed<T>::kWords * sizeof(u64) +
           4 * kBatch * sizeof(int);
  };
  int ld = buf + 1;  // padded rows against bank conflicts
  if (smem_of(ld) > kMaxSmem) ld = buf;  // unpadded: bank conflicts only
  const size_t smem = smem_of(ld);
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

template <typename T, int C>
int launch_wide(const void* u, const void* v, const void* vals,
                const void* ulo, const void* vlo, const void* unit_seg,
                const void* unit_start, const void* unit_count,
                const void* vsum, void* grid64, int nunits, int npix,
                int tile, int nta, int support, double beta, cudaStream_t s) {
  const size_t smem = wide_layout<T>(support).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(unit_tiles_wide_kernel<T, C>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  unit_tiles_wide_kernel<T, C><<<nunits, kWideThreads, smem, s>>>(
      (const T*)u, (const T*)v, (const T*)vals, (const T*)ulo,
      (const T*)vlo, (const int*)unit_seg, (const int*)unit_start,
      (const int*)unit_count, (const double*)vsum, (u64*)grid64, npix, tile,
      nta, support, (T)beta);
  return ska_last_error();
}

template <typename T>
int launch_support(const void* u, const void* v, const void* vals,
                   const void* ulo, const void* vlo, const void* unit_seg,
                   const void* unit_start, const void* unit_count,
                   const void* vsum, void* grid64, void* grid, int nunits,
                   int nplanes, int npix, int tile, int nta, int support,
                   double beta, cudaStream_t s) {
  const size_t n = 2 * (size_t)nplanes * npix * npix;
  cudaMemsetAsync(grid64, 0, n * Fixed<T>::kWords * sizeof(u64), s);
  int rc = 0;
#define SKA_UNIT_TILES_CASE(S)                                               \
  case S:                                                                    \
    rc = launch<T, S>(u, v, vals, ulo, vlo, unit_seg, unit_start,            \
                      unit_count, vsum, grid64, nunits, npix, tile, nta,     \
                      beta, s);                                              \
    break;
  switch (support) {
    SKA_UNIT_TILES_CASE(2)
    SKA_UNIT_TILES_CASE(4)
    SKA_UNIT_TILES_CASE(6)
    SKA_UNIT_TILES_CASE(8)
    SKA_UNIT_TILES_CASE(10)
    SKA_UNIT_TILES_CASE(12)
    SKA_UNIT_TILES_CASE(14)
    SKA_UNIT_TILES_CASE(16)
    default: {
      // odd supports and supports past 16: the wide variant
      if (support < 2 || support > 64 || support > tile)
        return (int)cudaErrorInvalidValue;
      const int classes = (support * support + kWideThreads - 1) / kWideThreads;
#define SKA_UNIT_TILES_WIDE(C)                                               \
  launch_wide<T, C>(u, v, vals, ulo, vlo, unit_seg, unit_start, unit_count, \
                    vsum, grid64, nunits, npix, tile, nta, support, beta, s)
      rc = classes == 1   ? SKA_UNIT_TILES_WIDE(1)
           : classes == 2 ? SKA_UNIT_TILES_WIDE(2)
           : classes == 3 ? SKA_UNIT_TILES_WIDE(3)
                          : SKA_UNIT_TILES_WIDE(4);
#undef SKA_UNIT_TILES_WIDE
    }
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
