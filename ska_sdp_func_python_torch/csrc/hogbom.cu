// K5: the whole Hogbom CLEAN minor-cycle loop in one kernel.
//
// Replaces ska_sdp_func_python_tpu/ops/cleaners.py:_hogbom_pallas_kernel
// (components as an image, up to 512^2) and _hogbom_pallas_list_kernel
// (components as [niter, 128] rows, up to 1024^2). Both compute the same
// function; here components always go out as [niter, 4] rows
// (y, x, val, used), which the wrapper scatters into the component image.
//
// One CTA of 1024 threads runs one (chan, pol) lane. The residual lives in
// device memory (a 1024^2 f32 residual is 4 MB, resident in the 50 MB L2).
// Each iteration:
//   * mval = val * gain / pmax at the current peak;
//   * one sweep subtracts mval * PSF over the PSF footprint around the
//     peak, clipped at the image edges as overlapIndices clips, and in the
//     same sweep finds the next peak of |residual| as a block
//     (value, min-index) reduction: ties go to the first index;
//   * stop when |val - mval * psf_centre| < 0.9 * absthresh, with
//     absthresh = max(thresh, fracthresh * max|dirty|).
// The residual update res - psf * mval is one fused multiply-add with a
// single rounding (__fmaf_rn), the rounding the JAX package's CPU loop
// gets from XLA's multiply-subtract contraction and the plain version
// reproduces in f64; mval = val * gain / pmax is rounded per operation
// (__fmul_rn, __fdiv_rn), so no other contraction changes a result and
// near-tied peaks resolve the same way.
//
// What bounds it on the card: one SM streams the residual and the PSF
// patch through L2 once per iteration (fused subtract + search halves the
// traffic of a separate search pass). A cluster- or grid-wide version is
// later work.
#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// block-wide (max value, min index) reduction; every thread gets the result
__device__ void block_argmax(float& v, int& idx, float* s_v, int* s_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    better(v, idx, ov, oi);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // s_v/s_i free from the previous reduction
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    v = s_v[lane];
    idx = s_i[lane];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      better(v, idx, ov, oi);
    }
    if (lane == 0) {
      s_v[32] = v;
      s_i[32] = idx;
    }
  }
  __syncthreads();
  v = s_v[32];
  idx = s_i[32];
}

__global__ void __launch_bounds__(kThreads)
    hogbom_kernel(const float* __restrict__ dirty,
                  const float* __restrict__ psf, float* __restrict__ res,
                  float* __restrict__ comps, int ny, int nx, int py, int px,
                  int niter, float gain, float thresh, float fracthresh) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  const size_t npx = (size_t)ny * nx;
  const float* d = dirty + blockIdx.x * npx;
  const float* p = psf + (size_t)blockIdx.x * py * px;
  float* r = res + blockIdx.x * npx;
  float* c = comps + (size_t)blockIdx.x * niter * 4;
  const int cy = py / 2, cx = px / 2;

  // PSF peak and centre value
  float pmax = -FLT_MAX;
  int pidx = 0;
  for (int q = threadIdx.x; q < py * px; q += kThreads) better(pmax, pidx, p[q], q);
  block_argmax(pmax, pidx, s_v, s_i);
  const float psf_c = p[cy * px + cx];

  // residual = dirty, and the first peak of |residual|
  float best = -1.f;
  int bidx = INT_MAX;
  for (int q = threadIdx.x; q < (int)npx; q += kThreads) {
    const float v = d[q];
    r[q] = v;
    better(best, bidx, fabsf(v), q);
  }
  block_argmax(best, bidx, s_v, s_i);
  const float absthresh = fmaxf(thresh, __fmul_rn(fracthresh, best));
  const float stop = __fmul_rn(0.9f, absthresh);

  int it = 0;
  while (it < niter) {
    const int my = bidx / nx;
    const int mx = bidx - my * nx;
    const float val = r[bidx];
    const float mval = __fdiv_rn(__fmul_rn(val, gain), pmax);
    __syncthreads();  // every thread has read val before the sweep writes
    // footprint of the PSF centred on the peak, clipped to the image
    const int y0 = max(0, my - cy), y1 = min(ny, my - cy + py);
    const int x0 = max(0, mx - cx), x1 = min(nx, mx - cx + px);
    best = -1.f;
    bidx = INT_MAX;
    for (int q = threadIdx.x; q < (int)npx; q += kThreads) {
      const int y = q / nx;
      const int x = q - y * nx;
      float v = r[q];
      if (y >= y0 && y < y1 && x >= x0 && x < x1) {
        const float pv = p[(y - my + cy) * px + (x - mx + cx)];
        v = __fmaf_rn(-pv, mval, v);
        r[q] = v;
      }
      better(best, bidx, fabsf(v), q);
    }
    if (threadIdx.x == 0) {
      float* row = c + 4 * (size_t)it;
      row[0] = (float)my;
      row[1] = (float)mx;
      row[2] = mval;
      row[3] = 1.f;
    }
    ++it;
    block_argmax(best, bidx, s_v, s_i);
    const float val_new = __fmaf_rn(-mval, psf_c, val);
    if (fabsf(val_new) < stop) break;
  }
  for (int q = 4 * it + threadIdx.x; q < 4 * niter; q += kThreads) c[q] = 0.f;
}

}  // namespace

SKA_EXPORT int ska_hogbom(const void* dirty, const void* psf, void* res,
                          void* comps, int nlanes, int ny, int nx, int py,
                          int px, int niter, float gain, float thresh,
                          float fracthresh, void* stream) {
  if (nlanes == 0) return 0;
  hogbom_kernel<<<nlanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dirty, (const float*)psf, (float*)res, (float*)comps, ny,
      nx, py, px, niter, gain, thresh, fracthresh);
  return ska_last_error();
}
