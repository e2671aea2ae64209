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
// touched cells of the tile into the complex grids with global atomics, as
// K1 folds K2.
//
// Numerics: templated on the real type (f32 for the fast-f32 and 2-d
// rows, f64 for the deep-f64 rows). The offset is formed as
// ((t0 - pix) + r) - lo with round-to-nearest intrinsics that the compiler
// may not contract into an FMA: the small hi difference is exact, and the
// lo residual of a split (hi, lo) coordinate then carries the f64
// position. Atomics make the summation order vary from run to run; results
// agree with the plain version to rounding (tolerances in
// tests/test_torch_cuda.py and chip_smoke.py).
//
// What bounds it on the card: stage 1's 2 S ES taps an entry (an exp, a
// sqrt and a division each; slow in f64) and stage 2's issue rate (shared
// loads and a complex multiply-add per entry and thread); then the flushes.
// The bytes it must move are the sorted stream once and the grids once.
#include "common.cuh"

namespace {

constexpr int kRunCap = 64;  // the most entries one register sum takes

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

// entries staged per batch: f64 halves it to keep 2 CTAs on an SM
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
                      T* __restrict__ grid, int npix, int tile, int nta,
                      T beta) {
  // groups of S^2 threads, each over [start + g q, start + (g + 1) q) of
  // the unit; a batch holds kPs entries of each group, in slots g kPs + j
  constexpr int kGroup = Groups<S>::kGroup;
  constexpr int kNgroups = Groups<S>::kCount;
  constexpr int kThreads = Groups<S>::kThreads;
  constexpr int kPs = Batch<T>::kSize / kNgroups;
  constexpr int kSlots = kNgroups * kPs;
  constexpr int kHalf = S / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf = tile + S;
  const int ld = buf + 1;  // padded rows against bank conflicts
  const int nb = buf * ld;
  Coords<T>* coords = reinterpret_cast<Coords<T>*>(smem_raw);  // [2]
  T* taps = reinterpret_cast<T*>(coords + 2);  // [kSlots][2][S]: v, u
  T* acc = taps + Batch<T>::kSize * 2 * S;     // [2][buf][ld]: re, im
  // [kSlots][4]: v corner, its residue mod S, u corner, its residue (the
  // corners tile-relative)
  int* rel = reinterpret_cast<int*>(acc + 2 * nb);

  for (int i = threadIdx.x; i < 2 * nb; i += kThreads) acc[i] = T(0);

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
  auto flush = [&]() {
    if (cur >= 0) {
      atomicAdd(&acc[cur], re);
      atomicAdd(&acc[nb + cur], im);
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

  // overlap-add: the tile and its halo into the plane grid; untouched
  // cells are zero and skipped, halo cells past the grid edge are zero
  // (unit entries lie in the grid) and skipped
  for (int i = threadIdx.x; i < buf * buf; i += kThreads) {
    const int y = i / buf;
    const int x = i - y * buf;
    const int gy = tv0 + y;
    const int gx = tu0 + x;
    if (gy >= npix || gx >= npix) continue;
    const T cre = acc[y * ld + x];
    const T cim = acc[nb + y * ld + x];
    if (cre != T(0) || cim != T(0)) {
      T* gp = grid + 2 * (((size_t)plane * npix + gy) * npix + gx);
      atomicAdd(gp, cre);
      atomicAdd(gp + 1, cim);
    }
  }
}

template <typename T, int S>
int launch(const void* u, const void* v, const void* vals, const void* ulo,
           const void* vlo, const void* unit_seg, const void* unit_start,
           const void* unit_count, void* grid, int nunits, int npix,
           int tile, int nta, double beta, cudaStream_t s) {
  constexpr int kBatch = Batch<T>::kSize;
  const int buf = tile + S;
  const size_t smem = 2 * sizeof(Coords<T>) +
                      (kBatch * 2 * (size_t)S + 2 * (size_t)buf * (buf + 1)) * sizeof(T) +
                      4 * kBatch * sizeof(int);
  cudaFuncSetAttribute(unit_tiles_kernel<T, S>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaFuncSetAttribute(unit_tiles_kernel<T, S>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  unit_tiles_kernel<T, S><<<nunits, Groups<S>::kThreads, smem, s>>>(
      (const T*)u, (const T*)v, (const T*)vals, (const T*)ulo,
      (const T*)vlo, (const int*)unit_seg, (const int*)unit_start,
      (const int*)unit_count, (T*)grid, npix, tile, nta, (T)beta);
  return ska_last_error();
}

template <typename T>
int launch_support(const void* u, const void* v, const void* vals,
                   const void* ulo, const void* vlo, const void* unit_seg,
                   const void* unit_start, const void* unit_count, void* grid,
                   int nunits, int npix, int tile, int nta, int support,
                   double beta, cudaStream_t s) {
#define SKA_UNIT_TILES_CASE(S)                                               \
  case S:                                                                    \
    return launch<T, S>(u, v, vals, ulo, vlo, unit_seg, unit_start,          \
                        unit_count, grid, nunits, npix, tile, nta, beta, s);
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
#undef SKA_UNIT_TILES_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// u, v, ulo, vlo: [n] real (ulo and vlo both given or both null); vals: [n]
// complex (interleaved re, im); unit_*: [nunits] int32; grid: [nplanes,
// npix, npix] complex, zero-filled by the caller. f64 selects double
// precision.
SKA_EXPORT int ska_unit_tiles(const void* u, const void* v, const void* vals,
                              const void* ulo, const void* vlo,
                              const void* unit_seg, const void* unit_start,
                              const void* unit_count, void* grid, int nunits,
                              int npix, int tile, int nta, int support,
                              double beta, int f64, void* stream) {
  if (nunits == 0) return 0;
  if ((ulo == nullptr) != (vlo == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch_support<double>(u, v, vals, ulo, vlo, unit_seg,
                                  unit_start, unit_count, grid, nunits, npix,
                                  tile, nta, support, beta, s);
  return launch_support<float>(u, v, vals, ulo, vlo, unit_seg, unit_start,
                               unit_count, grid, nunits, npix, tile, nta,
                               support, beta, s);
}
