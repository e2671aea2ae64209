// K1+K2: plan-sorted w-stacked gridding with the overlap-add folded in.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_grid_slot_kernel
// (the per-slot [buf, buf] tile accumulation) and the inner kernel of
// _assemble_execute (the overlap-add of each tile's 8-wide halo into its
// neighbours).
//
// Each CTA takes one chunk of one (plane-pair, tile) segment of the
// plan-sorted entry stream and accumulates sum kv * val * w * ku^T for the
// lower and upper w-plane (re, im) of its [buf, buf] tile (buf = tile + 8)
// in f32 FMA: no TF32, no bf16. It then adds the tile, halo included, into
// the complex plane grids with global atomics, which replaces the TPU's
// sequential grid-carried accumulator and its separate assemble pass. Only
// touched cells are flushed.
//
// Work distribution (Romein 2012): the 8 x 8 window of an entry touches
// exactly one cell of each residue class (x mod 8, y mod 8). Each of 64
// threads of a group owns one class (a, b), finds the one cell of each
// entry's window in its class and sums tap * value in registers for as
// long as consecutive entries hit that cell; it adds its registers to the
// shared tile only when the cell changes, after kRunCap entries (which
// bounds the length of a sequential f32 sum) and at the end. A CTA runs
// four such groups, each over a contiguous quarter of its chunk.
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
// grids once) are an order of magnitude less. Atomics make the summation
// order vary from run to run: results agree with the plain version to f32
// rounding (tolerance stated in the tests and chip_smoke.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 64;  // entry walks of a CTA
constexpr int kStage = 16;              // entries a group stages per batch
constexpr int kSlots = kGroups * kStage;
constexpr int kRunCap = 64;  // the most entries one register sum takes

// one batch of staged entries of all groups
struct Stage {
  float4 taps[kSlots][4];  // ku[0:4], ku[4:8], kv[0:4], kv[4:8]
  float4 meta[kSlots];     // val.re, val.im, iu0, iv0 (int bits)
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

template <int NACC>
__global__ void __launch_bounds__(kThreads, 3)
    grid_kernel(const float2* __restrict__ vals, const int* __restrict__ iu0,
                const int* __restrict__ iv0, const float* __restrict__ frac,
                const float4* __restrict__ ku, const float4* __restrict__ kv,
                const int* __restrict__ order,
                const int* __restrict__ chunk_seg,
                const int* __restrict__ chunk_start,
                const int* __restrict__ chunk_count, float* __restrict__ grid,
                int npix, int tile, int nta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stage = reinterpret_cast<Stage*>(smem_raw);  // [2]
  // [NACC][buf][ld]: re_lo, im_lo, re_hi, im_hi
  float* acc = reinterpret_cast<float*>(stage + 2);
  const int buf = tile + 8;
  const int ld = tile_ld(buf);
  const int nb = buf * ld;
  for (int i = threadIdx.x; i < NACC * nb; i += kThreads) acc[i] = 0.f;

  const int seg = chunk_seg[blockIdx.x];
  const int start = chunk_start[blockIdx.x];
  const int end = start + chunk_count[blockIdx.x];
  const int ntiles = nta * nta;
  const int plane = seg / ntiles;
  const int t = seg - plane * ntiles;
  const int tv0 = (t / nta) * tile;
  const int tu0 = (t % nta) * tile;
  // group g walks [start + g q, start + (g + 1) q) of the chunk
  const int q = (chunk_count[blockIdx.x] + kGroups - 1) / kGroups;
  const int nbatch = (q + kStage - 1) / kStage;

  // loader role: thread stages piece (threadIdx & 3) of slot (threadIdx >> 2)
  const int slot = threadIdx.x >> 2;
  const int piece = threadIdx.x & 3;
  const int lbeg = start + (slot / kStage) * q + slot % kStage;
  const int lend = min(start + (slot / kStage + 1) * q, end);
  auto entry_of = [&](int k) {
    const int p = lbeg + k * kStage;
    return p < lend ? order[p] : -1;
  };
  auto issue = [&](int k, int e) {
    if (e >= 0) {
      Stage& s = stage[k & 1];
      const float4* src = piece < 2 ? ku + 2 * (size_t)e + piece
                                    : kv + 2 * (size_t)e + (piece - 2);
      ska_cp_async<16>(&s.taps[slot][piece], src);
      float* m = reinterpret_cast<float*>(&s.meta[slot]);
      if (piece == 0)
        ska_cp_async<8>(m, vals + e);
      else if (piece == 1)
        ska_cp_async<4>(m + 2, iu0 + e);
      else if (piece == 2)
        ska_cp_async<4>(m + 3, iv0 + e);
      else if (NACC == 4)
        ska_cp_async<4>(&s.frac[slot], frac + e);
    }
    ska_cp_async_commit();
  };

  // compute role: residue class (a, b) of group g
  const int g = threadIdx.x >> 6;
  const int a = threadIdx.x & 7;
  const int b = (threadIdx.x >> 3) & 7;
  const int gbeg = start + g * q;
  const int gend = min(gbeg + q, end);
  int cur = -1, run = 0;
  float r0 = 0.f, i0 = 0.f, r1 = 0.f, i1 = 0.f;
  auto flush = [&]() {
    if (cur >= 0) {
      atomicAdd(&acc[cur], r0);
      atomicAdd(&acc[nb + cur], i0);
      if (NACC == 4) {
        atomicAdd(&acc[2 * nb + cur], r1);
        atomicAdd(&acc[3 * nb + cur], i1);
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
    const Stage& s = stage[k & 1];
    const int j0 = gbeg + k * kStage;
    const int nj = min(kStage, gend - j0);
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const int sl = g * kStage + j;
      const float4 m = s.meta[sl];
      const int ru = __float_as_int(m.z) - tu0;
      const int rv = __float_as_int(m.w) - tv0;
      const int dx = (a - ru) & 7;
      const int dy = (b - rv) & 7;
      const int y = rv + dy;
      const int cell = y * ld + swz(y, ru + dx, ld);
      const float kk = reinterpret_cast<const float*>(&s.taps[sl][2])[dy] *
                       reinterpret_cast<const float*>(&s.taps[sl][0])[dx];
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

  // overlap-add: the tile and its right/bottom halo go straight into the
  // plane grids; untouched cells are zero and skipped, halo cells past the
  // grid edge are zero by construction (entries are clipped in-grid)
  for (int i = threadIdx.x; i < buf * buf; i += kThreads) {
    const int y = i / buf;
    const int x = i - y * buf;
    const int gy = tv0 + y;
    const int gx = tu0 + x;
    if (gy >= npix || gx >= npix) continue;
    const int cell = y * ld + swz(y, x, ld);
#pragma unroll
    for (int p = 0; p < NACC / 2; ++p) {
      const float re = acc[2 * p * nb + cell];
      const float im = acc[(2 * p + 1) * nb + cell];
      if (re != 0.f || im != 0.f) {
        float* gp = grid + 2 * (((size_t)(plane + p) * npix + gy) * npix + gx);
        atomicAdd(gp, re);
        atomicAdd(gp + 1, im);
      }
    }
  }
}

template <int NACC>
int launch(const void* vals, const void* iu0, const void* iv0,
           const void* frac, const void* ku, const void* kv, const void* order,
           const void* chunk_seg, const void* chunk_start,
           const void* chunk_count, void* grid, int nchunks, int npix,
           int tile, int nta, cudaStream_t s) {
  const int buf = tile + 8;
  const int ld = tile_ld(buf);
  const size_t smem = 2 * sizeof(Stage) + (size_t)NACC * buf * ld * sizeof(float);
  cudaFuncSetAttribute(grid_kernel<NACC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(grid_kernel<NACC>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  grid_kernel<NACC><<<nchunks, kThreads, smem, s>>>(
      (const float2*)vals, (const int*)iu0, (const int*)iv0,
      (const float*)frac, (const float4*)ku, (const float4*)kv,
      (const int*)order, (const int*)chunk_seg, (const int*)chunk_start,
      (const int*)chunk_count, (float*)grid, npix, tile, nta);
  return ska_last_error();
}

}  // namespace

// vals [n] complex64; iu0, iv0, order [n] int32; frac [n] f32; ku, kv
// [n, 8] f32, 16-byte aligned; chunk_*: [nchunks] int32; grid [nplanes,
// npix, npix] complex64, zero-filled by the caller. nacc 4: w-stacked.
SKA_EXPORT int ska_grid(const void* vals, const void* iu0, const void* iv0,
                        const void* frac, const void* ku, const void* kv,
                        const void* order, const void* chunk_seg,
                        const void* chunk_start, const void* chunk_count,
                        void* grid, int nchunks, int npix, int tile, int nta,
                        int nacc, void* stream) {
  if (nchunks == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nacc == 4)
    return launch<4>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                     chunk_start, chunk_count, grid, nchunks, npix, tile, nta,
                     s);
  return launch<2>(vals, iu0, iv0, frac, ku, kv, order, chunk_seg,
                   chunk_start, chunk_count, grid, nchunks, npix, tile, nta, s);
}
