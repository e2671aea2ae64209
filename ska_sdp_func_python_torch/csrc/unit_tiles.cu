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
// through the (start, count, segment) unit table. Work form: the window
// form. The ES kernel is zero outside its support, so a CTA evaluates only
// the `support` non-zero taps per axis of each entry (stage 1, staged in
// shared memory for a batch of entries) and adds their support^2 products
// into a [buf, buf] (re, im) tile in shared memory with shared atomics
// (stage 2); the dense buf x C evaluation of the TPU kernel does about
// (buf / support)^2 times the multiply-adds. The flush adds the tile into
// the complex grids with global atomics, as K1 folds K2.
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
// What bounds it on the card: the shared-memory atomics of stage 2 (2 per
// tap per entry; f64 shared atomics are slower than f32) and, for short
// units, the global atomics of the flush (2 per non-zero cell of the
// tile). The bytes it must move are the sorted stream once and the grids
// once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 64;  // entries whose taps are staged at once
constexpr int kMaxSupport = 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    unit_tiles_kernel(const T* __restrict__ u, const T* __restrict__ v,
                      const T* __restrict__ vals, const T* __restrict__ ulo,
                      const T* __restrict__ vlo,
                      const int* __restrict__ unit_seg,
                      const int* __restrict__ unit_start,
                      const int* __restrict__ unit_count,
                      T* __restrict__ grid, int npix, int tile, int nta,
                      int support, T beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf = tile + support;
  const int ld = buf + 1;  // padded rows against bank conflicts
  const int nb = buf * ld;
  T* acc = reinterpret_cast<T*>(smem_raw);  // [2][buf][ld]: re, im
  T* taps = acc + 2 * nb;                   // [kBatch][2][support]: v, u
  T* val = taps + kBatch * 2 * support;     // [kBatch][2]: re, im
  int* rel = reinterpret_cast<int*>(val + 2 * kBatch);  // [kBatch][2]: v, u

  for (int i = threadIdx.x; i < 2 * nb; i += kThreads) acc[i] = T(0);

  const int seg = unit_seg[blockIdx.x];
  const int start = unit_start[blockIdx.x];
  const int count = unit_count[blockIdx.x];
  const int ntiles = nta * nta;
  const int plane = seg / ntiles;
  const int t = seg - plane * ntiles;
  const int tv0 = (t / nta) * tile;
  const int tu0 = (t % nta) * tile;
  const int half = support / 2;
  const T halff = T(half);
  const int s2 = support * support;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int nbatch = min(kBatch, count - b0);
    __syncthreads();  // acc zeroed / the previous batch consumed
    // stage 1: the support taps of each axis of each entry of the batch
    for (int i = threadIdx.x; i < nbatch * 2 * support; i += kThreads) {
      const int j = i / (2 * support);
      const int k = i - j * 2 * support;
      const int axis = k / support;  // 0: v (rows), 1: u (columns)
      const int kk = k - axis * support;
      const int e = start + b0 + j;
      const T pix = axis == 0 ? v[e] : u[e];
      const T* lop = axis == 0 ? vlo : ulo;
      const T lo = lop != nullptr ? lop[e] : T(0);
      const int t0 = axis == 0 ? tv0 : tu0;
      // the window of the `support` non-zero taps starts at floor(pix +
      // lo) - (half - 1): one cell lower than the hi coordinate's window
      // when hi is an integer and lo < 0 (|lo| < 1). Unit entries lie in
      // the grid, so only a tap left of cell 0 of the tile (r < 0, which
      // the dense form does not have either) falls outside; stage 2 skips it
      const int shift = (pix == floor_(pix) && lo < T(0)) ? 1 : 0;
      const int i0 = (int)floor_(pix) - (half - 1) - shift;
      const int r = i0 - t0 + kk;  // cell of the tap in the tile
      const T offs = sub_rn(add_rn(sub_rn(T(t0), pix), T(r)), lo);
      taps[(2 * j + axis) * support + kk] = es_tap(offs, halff, beta);
      if (kk == 0) rel[2 * j + axis] = i0 - t0;
      if (k == 0) {
        val[2 * j] = vals[2 * (size_t)e];
        val[2 * j + 1] = vals[2 * (size_t)e + 1];
      }
    }
    __syncthreads();
    // stage 2: support^2 products of each entry into the shared tile
    for (int i = threadIdx.x; i < nbatch * s2; i += kThreads) {
      const int j = i / s2;
      const int tap = i - j * s2;
      const int dy = tap / support;
      const int dx = tap - dy * support;
      const int ry = rel[2 * j] + dy;
      const int rx = rel[2 * j + 1] + dx;
      if (ry < 0 || ry >= buf || rx < 0 || rx >= buf) continue;
      const T kv = taps[(2 * j) * support + dy];
      const T ku = taps[(2 * j + 1) * support + dx];
      if (kv == T(0) || ku == T(0)) continue;
      const int cell = ry * ld + rx;
      atomicAdd(&acc[cell], mul_rn(mul_rn(kv, val[2 * j]), ku));
      atomicAdd(&acc[nb + cell], mul_rn(mul_rn(kv, val[2 * j + 1]), ku));
    }
  }
  __syncthreads();

  // overlap-add: the tile and its halo into the plane grid; halo cells past
  // the grid edge are zero (unit entries lie in the grid) and are skipped
  for (int i = threadIdx.x; i < buf * buf; i += kThreads) {
    const int y = i / buf;
    const int x = i - y * buf;
    const int gy = tv0 + y;
    const int gx = tu0 + x;
    if (gy >= npix || gx >= npix) continue;
    const T re = acc[y * ld + x];
    const T im = acc[nb + y * ld + x];
    if (re != T(0) || im != T(0)) {
      T* g = grid + 2 * (((size_t)plane * npix + gy) * npix + gx);
      atomicAdd(g, re);
      atomicAdd(g + 1, im);
    }
  }
}

template <typename T>
int launch(const void* u, const void* v, const void* vals, const void* ulo,
           const void* vlo, const void* unit_seg, const void* unit_start,
           const void* unit_count, void* grid, int nunits, int npix,
           int tile, int nta, int support, double beta, cudaStream_t s) {
  const int buf = tile + support;
  const size_t smem = (2 * (size_t)buf * (buf + 1) + kBatch * 2 * support +
                       2 * kBatch) * sizeof(T) +
                      2 * kBatch * sizeof(int);
  cudaFuncSetAttribute(unit_tiles_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  unit_tiles_kernel<T><<<nunits, kThreads, smem, s>>>(
      (const T*)u, (const T*)v, (const T*)vals, (const T*)ulo,
      (const T*)vlo, (const int*)unit_seg, (const int*)unit_start,
      (const int*)unit_count, (T*)grid, npix, tile, nta, support, (T)beta);
  return ska_last_error();
}

}  // namespace

// u, v, ulo, vlo: [n] real (ulo/vlo may be null); vals: [n] complex
// (interleaved re, im); unit_*: [nunits] int32; grid: [nplanes, npix, npix]
// complex, zero-filled by the caller. f64 selects double precision.
SKA_EXPORT int ska_unit_tiles(const void* u, const void* v, const void* vals,
                              const void* ulo, const void* vlo,
                              const void* unit_seg, const void* unit_start,
                              const void* unit_count, void* grid, int nunits,
                              int npix, int tile, int nta, int support,
                              double beta, int f64, void* stream) {
  if (nunits == 0) return 0;
  if (support < 2 || support > kMaxSupport || support % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(u, v, vals, ulo, vlo, unit_seg, unit_start,
                          unit_count, grid, nunits, npix, tile, nta, support,
                          beta, s);
  return launch<float>(u, v, vals, ulo, vlo, unit_seg, unit_start,
                       unit_count, grid, nunits, npix, tile, nta, support,
                       beta, s);
}
