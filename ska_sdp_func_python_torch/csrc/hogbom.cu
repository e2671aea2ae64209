// K5: the whole Hogbom CLEAN minor-cycle loop in one kernel, and K6 its
// complex (Q + iU) form.
//
// K5 replaces ska_sdp_func_python_tpu/ops/cleaners.py:_hogbom_pallas_kernel
// (components as an image, up to 512^2) and _hogbom_pallas_list_kernel
// (components as [niter, 128] rows, up to 1024^2). Both compute the same
// function; here components always go out as [niter, 4] rows
// (y, x, val, used), which the wrapper scatters into the component image.
// K6 replaces _hogbom_complex_pallas_kernel and
// _hogbom_complex_pallas_list_kernel the same way, with [niter, 5] rows
// (y, x, mq, mu, used).
//
// One CTA of 1024 threads runs one (chan, pol) lane. The residual lives in
// device memory (a 1024^2 f32 residual is 4 MB, resident in the 50 MB L2).
// Each iteration:
//   * mval = val * gain / pmax at the current peak;
//   * one sweep subtracts mval * PSF over the PSF footprint around the
//     peak, clipped at the image edges as overlapIndices clips, and in the
//     same sweep finds the next peak of |residual * window| as a block
//     (value, min-index) reduction: ties go to the first index;
//   * K5 stops when |val - mval * psf_centre| < 0.9 * absthresh, with
//     absthresh = max(thresh, fracthresh * max|dirty|).
// The residual update res - psf * mval is one fused multiply-add with a
// single rounding (__fmaf_rn), the rounding the JAX package's CPU loop
// gets from XLA's multiply-subtract contraction and the plain version
// reproduces in f64; mval = val * gain / pmax is rounded per operation
// (__fmul_rn, __fdiv_rn), so no other contraction changes a result and
// near-tied peaks resolve the same way. The window (1 = allowed) only
// masks the search, |res * window| rounded as __fmul_rn; the windowless
// instantiation is the same code as without the option.
//
// K6 differs in three places, each of which changes which components come
// out, and follows the JAX package's XLA loop in all three: the search is
// hypot(Q, U) (the TPU list kernel searches Q^2 + U^2 and may break
// near-ties otherwise); pmax is the peak of the (Q) PSF; the loop stops
// when |res_new[peak]| < absthresh with no 0.9 factor, where
// absthresh = max(thresh, fracthresh * max hypot(Q, U)).
//
// What bounds them on the card: one SM streams the residual and the PSF
// patch through L2 once per iteration (fused subtract + search halves the
// traffic of a separate search pass). A cluster- or grid-wide version is
// later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
    hogbom_kernel(const float* __restrict__ dirty,
                  const float* __restrict__ psf,
                  const float* __restrict__ window, float* __restrict__ res,
                  float* __restrict__ comps, int ny, int nx, int py, int px,
                  int niter, float gain, float thresh, float fracthresh) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  const size_t npx = (size_t)ny * nx;
  const float* d = dirty + blockIdx.x * npx;
  const float* p = psf + (size_t)blockIdx.x * py * px;
  const float* w = kWindow ? window + blockIdx.x * npx : nullptr;
  float* r = res + blockIdx.x * npx;
  float* c = comps + (size_t)blockIdx.x * niter * 4;
  const int cy = py / 2, cx = px / 2;

  // PSF peak and centre value
  float pmax = -FLT_MAX;
  int pidx = 0;
  for (int q = threadIdx.x; q < py * px; q += kThreads) ska_better(pmax, pidx, p[q], q);
  ska_block_argmax<kThreads>(pmax, pidx, s_v, s_i);
  const float psf_c = p[cy * px + cx];

  // residual = dirty, the first peak of |residual * window|, and (with a
  // window) max|dirty| for the threshold
  float best = -1.f;
  int bidx = INT_MAX;
  float dmax = -1.f;
  for (int q = threadIdx.x; q < (int)npx; q += kThreads) {
    const float v = d[q];
    r[q] = v;
    if (kWindow) {
      ska_better(best, bidx, fabsf(__fmul_rn(v, w[q])), q);
      dmax = fmaxf(dmax, fabsf(v));
    } else {
      ska_better(best, bidx, fabsf(v), q);
    }
  }
  ska_block_argmax<kThreads>(best, bidx, s_v, s_i);
  float amax = best;
  if (kWindow) {
    int unused = 0;
    ska_block_argmax<kThreads>(dmax, unused, s_v, s_i);
    amax = dmax;
  }
  const float absthresh = fmaxf(thresh, __fmul_rn(fracthresh, amax));
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
      ska_better(best, bidx, kWindow ? fabsf(__fmul_rn(v, w[q])) : fabsf(v), q);
    }
    if (threadIdx.x == 0) {
      float* row = c + 4 * (size_t)it;
      row[0] = (float)my;
      row[1] = (float)mx;
      row[2] = mval;
      row[3] = 1.f;
    }
    ++it;
    ska_block_argmax<kThreads>(best, bidx, s_v, s_i);
    const float val_new = __fmaf_rn(-mval, psf_c, val);
    if (fabsf(val_new) < stop) break;
  }
  for (int q = 4 * it + threadIdx.x; q < 4 * niter; q += kThreads) c[q] = 0.f;
}

__device__ __forceinline__ float windowed_hypot(float q, float u, const float* w,
                                                int i) {
  return w ? hypotf(__fmul_rn(q, w[i]), __fmul_rn(u, w[i])) : hypotf(q, u);
}

__global__ void __launch_bounds__(kThreads)
    hogbom_complex_kernel(const float* __restrict__ dirty_q,
                          const float* __restrict__ dirty_u,
                          const float* __restrict__ psf,
                          const float* __restrict__ window,
                          float* __restrict__ res_q, float* __restrict__ res_u,
                          float* __restrict__ rows, int ny, int nx, int py,
                          int px, int niter, float gain, float thresh,
                          float fracthresh) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  const size_t npx = (size_t)ny * nx;
  const float* dq = dirty_q + blockIdx.x * npx;
  const float* du = dirty_u + blockIdx.x * npx;
  const float* p = psf + (size_t)blockIdx.x * py * px;
  const float* w = window ? window + blockIdx.x * npx : nullptr;
  float* rq = res_q + blockIdx.x * npx;
  float* ru = res_u + blockIdx.x * npx;
  float* c = rows + (size_t)blockIdx.x * niter * 5;
  const int cy = py / 2, cx = px / 2;

  float pmax = -FLT_MAX;
  int pidx = 0;
  for (int q = threadIdx.x; q < py * px; q += kThreads) ska_better(pmax, pidx, p[q], q);
  ska_block_argmax<kThreads>(pmax, pidx, s_v, s_i);
  const float psf_c = p[cy * px + cx];

  float best = -1.f;
  int bidx = INT_MAX;
  float amax = -1.f;
  for (int q = threadIdx.x; q < (int)npx; q += kThreads) {
    const float vq = dq[q], vu = du[q];
    rq[q] = vq;
    ru[q] = vu;
    ska_better(best, bidx, windowed_hypot(vq, vu, w, q), q);
    amax = fmaxf(amax, hypotf(vq, vu));
  }
  ska_block_argmax<kThreads>(best, bidx, s_v, s_i);
  int unused = 0;
  ska_block_argmax<kThreads>(amax, unused, s_v, s_i);
  const float absthresh = fmaxf(thresh, __fmul_rn(fracthresh, amax));

  int it = 0;
  while (it < niter) {
    const int my = bidx / nx;
    const int mx = bidx - my * nx;
    const float vq = rq[bidx], vu = ru[bidx];
    const float mq = __fdiv_rn(__fmul_rn(vq, gain), pmax);
    const float mu = __fdiv_rn(__fmul_rn(vu, gain), pmax);
    __syncthreads();  // every thread has read the peak before the sweep
    const int y0 = max(0, my - cy), y1 = min(ny, my - cy + py);
    const int x0 = max(0, mx - cx), x1 = min(nx, mx - cx + px);
    best = -1.f;
    bidx = INT_MAX;
    for (int q = threadIdx.x; q < (int)npx; q += kThreads) {
      const int y = q / nx;
      const int x = q - y * nx;
      float a = rq[q], b = ru[q];
      if (y >= y0 && y < y1 && x >= x0 && x < x1) {
        const float pv = p[(y - my + cy) * px + (x - mx + cx)];
        a = __fmaf_rn(-pv, mq, a);
        b = __fmaf_rn(-pv, mu, b);
        rq[q] = a;
        ru[q] = b;
      }
      ska_better(best, bidx, windowed_hypot(a, b, w, q), q);
    }
    if (threadIdx.x == 0) {
      float* row = c + 5 * (size_t)it;
      row[0] = (float)my;
      row[1] = (float)mx;
      row[2] = mq;
      row[3] = mu;
      row[4] = 1.f;
    }
    ++it;
    ska_block_argmax<kThreads>(best, bidx, s_v, s_i);
    const float nq = __fmaf_rn(-mq, psf_c, vq);
    const float nu = __fmaf_rn(-mu, psf_c, vu);
    if (hypotf(nq, nu) < absthresh) break;
  }
  for (int q = 5 * it + threadIdx.x; q < 5 * niter; q += kThreads) c[q] = 0.f;
}

}  // namespace

SKA_EXPORT int ska_hogbom(const void* dirty, const void* psf,
                          const void* window, void* res, void* comps,
                          int nlanes, int ny, int nx, int py, int px,
                          int niter, float gain, float thresh,
                          float fracthresh, void* stream) {
  if (nlanes == 0) return 0;
  auto kernel = window ? hogbom_kernel<true> : hogbom_kernel<false>;
  kernel<<<nlanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dirty, (const float*)psf, (const float*)window,
      (float*)res, (float*)comps, ny, nx, py, px, niter, gain, thresh,
      fracthresh);
  return ska_last_error();
}

SKA_EXPORT int ska_hogbom_complex(const void* dirty_q, const void* dirty_u,
                                  const void* psf, const void* window,
                                  void* res_q, void* res_u, void* rows,
                                  int nlanes, int ny, int nx, int py, int px,
                                  int niter, float gain, float thresh,
                                  float fracthresh, void* stream) {
  if (nlanes == 0) return 0;
  hogbom_complex_kernel<<<nlanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dirty_q, (const float*)dirty_u, (const float*)psf,
      (const float*)window, (float*)res_q, (float*)res_u, (float*)rows, ny,
      nx, py, px, niter, gain, thresh, fracthresh);
  return ska_last_error();
}
