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
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kStage = 16;   // entries a group stages per batch
constexpr int kRunCap = 64;  // the most entries one register sum takes
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block

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

template <int P, int NACC, bool kFull>
int launch(const void* vals, const void* iu0, const void* iv0,
           const void* frac, const void* ku, const void* kv, const void* order,
           const void* chunk_seg, const void* chunk_start,
           const void* chunk_count, const void* tap_bound, const void* vsum,
           void* grid64, int nchunks, int npix, int tile, int nta, int support,
           cudaStream_t s) {
  const int buf = tile + support;
  auto smem_of = [&](int ld) {
    return 2 * sizeof(Stage<P>) + (size_t)NACC * buf * ld * sizeof(long long);
  };
  int ld = tile_ld(buf);
  if (smem_of(ld) > kMaxSmem) ld = buf;  // unpadded rows: bank conflicts only
  const size_t smem = smem_of(ld);
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

}  // namespace

// vals [n] complex64; iu0, iv0, order [n] int32; frac [n] f32; ku, kv
// [n, P] f32 (P = 8 for support <= 8, 16 for support <= 16), 16-byte
// aligned; chunk_*: [nchunks] int32; tap_bound [1] f32, the plan's; vsum
// [1] f32, the sum of |re| + |im| over vals; grid64 [nplanes, npix, npix,
// 2] int64 scratch; grid [nplanes, npix, npix] complex64 out. nacc 4:
// linear w-stacking (plane pairs); 2: one plane a segment (single-plane or
// nearest-plane plans).
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
  if (support < 1 || support > 16) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaMemsetAsync(grid64, 0, n * sizeof(long long), s);
  if (nchunks > 0) {
#define SKA_GRID_LAUNCH(P, NACC, FULL)                                        \
  launch<P, NACC, FULL>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,     \
                        chunk_start, chunk_count, tap_bound, vsum, grid64,  \
                        nchunks, npix, tile, nta, support, s)
    const bool four = nacc == 4;
    int rc;
    if (support == 8)
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
  const size_t blocks = min((n + 255) / 256, (size_t)65536);
  grid_convert<<<(unsigned)blocks, 256, 0, s>>>(
      (const long long*)grid64, (float*)grid, n, (const float*)tap_bound,
      (const float*)vsum);
  return ska_last_error();
}
