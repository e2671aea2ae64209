// K1+K2: plan-sorted w-stacked gridding with the overlap-add folded in.
//
// Replaces ska_sdp_func_python_tpu/ops/gridding_fused.py:_grid_slot_kernel
// (the per-slot [buf, buf] tile accumulation) and the inner kernel of
// _assemble_execute (the overlap-add of each tile's 8-wide halo into its
// neighbours).
//
// Each CTA takes one chunk of one (plane-pair, tile) segment of the
// plan-sorted entry stream. It accumulates sum kv * val * w * ku^T for the
// lower and upper w-plane (re, im) into four [buf, buf] tiles in shared
// memory (buf = tile + 8, rows padded to buf + 1 floats against bank
// conflicts), in f32 FMA: no TF32, no bf16. It then adds its tile, halo
// included, into the complex plane grids with global atomicAdd, which
// replaces the TPU's sequential grid-carried accumulator and its separate
// assemble pass.
//
// What bounds it on the card: the shared-memory atomics of the accumulate
// loop (4 per tap per entry) and the global atomics of the flush (one
// tile per chunk). Entries arrive sorted by tile, so the loop reads the
// stream once, coalesced; chunks of one segment share a tile, so the
// flush is small against the accumulation. Atomics make the summation
// order vary from run to run: results agree with the plain version to
// f32 rounding (tolerance stated in the tests and chip_smoke.py).
#include "common.cuh"

namespace {

template <int NACC>
__global__ void grid_kernel(const float2* __restrict__ vals,
                            const int* __restrict__ iu0,
                            const int* __restrict__ iv0,
                            const float* __restrict__ frac,
                            const float* __restrict__ ku,
                            const float* __restrict__ kv,
                            const int* __restrict__ chunk_seg,
                            const int* __restrict__ chunk_start,
                            const int* __restrict__ chunk_count,
                            float* __restrict__ grid, int npix, int tile,
                            int nta) {
  extern __shared__ float acc[];  // [NACC][buf][ld]: re_lo, im_lo, re_hi, im_hi
  const int buf = tile + 8;
  const int ld = buf + 1;
  const int nb = buf * ld;
  for (int i = threadIdx.x; i < NACC * nb; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int seg = chunk_seg[blockIdx.x];
  const int start = chunk_start[blockIdx.x];
  const int end = start + chunk_count[blockIdx.x];
  const int ntiles = nta * nta;
  const int plane = seg / ntiles;
  const int t = seg - plane * ntiles;
  const int tv0 = (t / nta) * tile;
  const int tu0 = (t % nta) * tile;

  // 64 taps of one entry per 64 threads: the taps of one entry hit 64
  // distinct cells, and the blockDim/64 entry lanes run concurrently
  const int tap = threadIdx.x & 63;
  const int dy = tap >> 3;
  const int dx = tap & 7;
  const int nlanes = blockDim.x >> 6;
  for (int e = start + (threadIdx.x >> 6); e < end; e += nlanes) {
    const size_t e8 = 8 * (size_t)e;
    const float k = kv[e8 + dy] * ku[e8 + dx];
    const float2 v = vals[e];
    const int cell = (iv0[e] - tv0 + dy) * ld + (iu0[e] - tu0 + dx);
    if (NACC == 4) {
      const float f = frac[e];
      const float w0 = 1.f - f;
      atomicAdd(&acc[cell], k * (v.x * w0));
      atomicAdd(&acc[nb + cell], k * (v.y * w0));
      atomicAdd(&acc[2 * nb + cell], k * (v.x * f));
      atomicAdd(&acc[3 * nb + cell], k * (v.y * f));
    } else {
      atomicAdd(&acc[cell], k * v.x);
      atomicAdd(&acc[nb + cell], k * v.y);
    }
  }
  __syncthreads();

  // overlap-add: the tile and its right/bottom halo go straight into the
  // plane grids; halo cells past the grid edge are zero by construction
  // (entries are clipped in-grid) and are skipped
  for (int i = threadIdx.x; i < buf * buf; i += blockDim.x) {
    const int y = i / buf;
    const int x = i - y * buf;
    const int gy = tv0 + y;
    const int gx = tu0 + x;
    if (gy >= npix || gx >= npix) continue;
    const int cell = y * ld + x;
#pragma unroll
    for (int q = 0; q < NACC / 2; ++q) {
      const float re = acc[2 * q * nb + cell];
      const float im = acc[(2 * q + 1) * nb + cell];
      if (re != 0.f || im != 0.f) {
        float* g = grid + 2 * (((size_t)(plane + q) * npix + gy) * npix + gx);
        atomicAdd(g, re);
        atomicAdd(g + 1, im);
      }
    }
  }
}

}  // namespace

SKA_EXPORT int ska_grid(const void* vals, const void* iu0, const void* iv0,
                        const void* frac, const void* ku, const void* kv,
                        const void* chunk_seg, const void* chunk_start,
                        const void* chunk_count, void* grid, int nchunks,
                        int npix, int tile, int nta, int nacc,
                        void* stream) {
  if (nchunks == 0) return 0;
  const int buf = tile + 8;
  const size_t smem = (size_t)nacc * buf * (buf + 1) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  if (nacc == 4) {
    cudaFuncSetAttribute(grid_kernel<4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    grid_kernel<4><<<nchunks, 256, smem, s>>>(
        (const float2*)vals, (const int*)iu0, (const int*)iv0,
        (const float*)frac, (const float*)ku, (const float*)kv,
        (const int*)chunk_seg, (const int*)chunk_start,
        (const int*)chunk_count, (float*)grid, npix, tile, nta);
  } else {
    cudaFuncSetAttribute(grid_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    grid_kernel<2><<<nchunks, 256, smem, s>>>(
        (const float2*)vals, (const int*)iu0, (const int*)iv0,
        (const float*)frac, (const float*)ku, (const float*)kv,
        (const int*)chunk_seg, (const int*)chunk_start,
        (const int*)chunk_count, (float*)grid, npix, tile, nta);
  }
  return ska_last_error();
}
