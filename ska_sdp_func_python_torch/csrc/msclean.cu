// K7: the msclean minor-cycle loop, spread over the whole card.
//
// Replaces ska_sdp_func_python_tpu/ops/cleaners.py:_msclean_corner_kernel
// (component rows, chained blocks) and _msclean_pallas_kernel (K7v1,
// components as an image). Both compute the minor loop of the JAX
// package's XLA fallback, _msclean_loop, which this kernel follows:
//   * search |res_s / cd_s * window_s * sens * sens| over the whole
//     [scale, y, x] stack, first index in (scale, y, x) order on ties;
//   * stop BEFORE the subtraction once |res[peak]| < 0.9 * absthresh,
//     absthresh = max(thresh, fracthresh * max|res_stack[0]|) taken once
//     from the initial stack;
//   * gm = gain * (res[peak] / cd[peak scale]); every scale plane s'
//     subtracts psf_ss[s', peak scale] * gm over the PSF footprint centred
//     on the peak and clipped at the image edges; emit the row
//     (y, x, scale, gm, used).
// The residual stack stays unscaled (divided by cd only in the search) and
// every update is one fused multiply-add (__fmaf_rn), the rounding of the
// XLA loop on the CPU (it contracts res - patch * gm); divisions and
// products are rounded per operation (__fdiv_rn, __fmul_rn). So the plain
// version (msclean_rows_plain) and this kernel agree bit for bit.
//
// What bounds it on the card: a full-width stack is 4 x 1024^2 f32 = 16 MB
// and the PSF footprint covers most of it, so one iteration reads the
// stack and read-modify-writes up to the whole of it against psf_ss[:, ms]
// (~48 MB); one SM would need several hundred ms for 300 iterations. The
// work of each iteration is therefore spread over the card in two
// launches, which the host enqueues for all iterations without reading the
// device:
//   sweep: a grid of CTAs, each over a few rows of the stack, subtracts
//     the current peak's patch and searches the updated rows; each CTA
//     writes its (value, first index) partial;
//   pick: one CTA reduces the partials (first index on ties, so the
//     (scale, y, x) order holds across CTAs), applies the stop rule,
//     writes the row and publishes the next peak and gm in a small state
//     block in device memory, with a done flag.
// After the loop stops, the remaining launches read the done flag and
// return at once.
#include "common.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kPickThreads = 1024;

struct MsState {
  int done;      // the loop has stopped
  int has_peak;  // the next sweep subtracts this peak
  int ms, my, mx;
  float gm;
  float absthresh;
  float stop;
};

template <bool kWin, bool kSens>
__global__ void __launch_bounds__(kSweepThreads)
    msclean_sweep(float* __restrict__ res, const float* __restrict__ psf_ss,
                  const float* __restrict__ cd, const float* __restrict__ win,
                  const float* __restrict__ sens,
                  const MsState* __restrict__ st, float* __restrict__ part_v,
                  int* __restrict__ part_i, float* __restrict__ part_m0,
                  int ns, int ny, int nx, int py, int px, int rows_per_cta,
                  int search, int first) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  if (st->done) return;
  const int has_peak = st->has_peak;
  const int ms = has_peak ? st->ms : 0;
  const int my = has_peak ? st->my : 0;
  const int mx = has_peak ? st->mx : 0;
  const float gm = has_peak ? st->gm : 0.f;
  const int cy = py / 2, cx = px / 2;
  const int x0 = max(0, mx - cx), x1 = min(nx, mx - cx + px);
  float best = -1.f;
  int bidx = INT_MAX;
  float m0 = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(ns * ny, r0 + rows_per_cta);
  for (int r = r0; r < r1; ++r) {
    const int s = r / ny;
    const int y = r - s * ny;
    float* row = res + (size_t)r * nx;
    const float cds = cd[s];
    const int dy = y - my + cy;
    const bool hit = has_peak && dy >= 0 && dy < py;
    const float* prow =
        hit ? psf_ss + (((size_t)s * ns + ms) * py + dy) * px + (cx - mx)
            : nullptr;
    for (int x = threadIdx.x; x < nx; x += kSweepThreads) {
      float v = row[x];
      if (hit && x >= x0 && x < x1) {
        v = __fmaf_rn(-prow[x], gm, v);
        row[x] = v;
      }
      if (first && s == 0) m0 = fmaxf(m0, fabsf(v));
      if (search) {
        float a = __fdiv_rn(v, cds);
        if (kWin) a = __fmul_rn(a, win[(size_t)r * nx + x]);
        if (kSens) {
          const float sv = sens[(size_t)y * nx + x];
          a = __fmul_rn(__fmul_rn(a, sv), sv);
        }
        ska_better(best, bidx, fabsf(a), r * nx + x);
      }
    }
  }
  if (search) {
    ska_block_argmax<kSweepThreads>(best, bidx, s_v, s_i);
    if (threadIdx.x == 0) {
      part_v[blockIdx.x] = best;
      part_i[blockIdx.x] = bidx;
    }
  }
  if (first) {
    int unused = 0;
    ska_block_argmax<kSweepThreads>(m0, unused, s_v, s_i);
    if (threadIdx.x == 0) part_m0[blockIdx.x] = m0;
  }
}

__global__ void __launch_bounds__(kPickThreads)
    msclean_pick(const float* __restrict__ res, const float* __restrict__ cd,
                 MsState* __restrict__ st, const float* __restrict__ part_v,
                 const int* __restrict__ part_i,
                 const float* __restrict__ part_m0, int nparts,
                 float* __restrict__ rows, int it, int ny, int nx, float gain,
                 float thresh, float fracthresh) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  if (st->done) return;
  float best = -1.f;
  int bidx = INT_MAX;
  for (int q = threadIdx.x; q < nparts; q += kPickThreads)
    ska_better(best, bidx, part_v[q], part_i[q]);
  ska_block_argmax<kPickThreads>(best, bidx, s_v, s_i);
  float stop;
  if (it == 0) {
    float m0 = 0.f;
    int unused = 0;
    for (int q = threadIdx.x; q < nparts; q += kPickThreads)
      m0 = fmaxf(m0, part_m0[q]);
    ska_block_argmax<kPickThreads>(m0, unused, s_v, s_i);
    const float absthresh = fmaxf(thresh, __fmul_rn(fracthresh, m0));
    stop = __fmul_rn(0.9f, absthresh);
    if (threadIdx.x == 0) {
      st->absthresh = absthresh;
      st->stop = stop;
    }
  } else {
    stop = st->stop;
  }
  if (threadIdx.x != 0) return;
  const float val = bidx == INT_MAX ? 0.f : res[bidx];
  if (bidx == INT_MAX || fabsf(val) < stop) {
    st->done = 1;
    st->has_peak = 0;
    return;
  }
  const int plane = ny * nx;
  const int s = bidx / plane;
  const int rem = bidx - s * plane;
  const int y = rem / nx;
  const int x = rem - y * nx;
  const float gm = __fmul_rn(gain, __fdiv_rn(val, cd[s]));
  st->ms = s;
  st->my = y;
  st->mx = x;
  st->gm = gm;
  st->has_peak = 1;
  float* row = rows + 5 * (size_t)it;
  row[0] = (float)y;
  row[1] = (float)x;
  row[2] = (float)s;
  row[3] = gm;
  row[4] = 1.f;
}

using SweepFn = void (*)(float*, const float*, const float*, const float*,
                         const float*, const MsState*, float*, int*, float*,
                         int, int, int, int, int, int, int, int);

}  // namespace

// One lane: res [ns, ny, nx] (updated in place: the wrapper passes a copy
// of the initial stack), psf_ss [ns, ns, py, px], cd [ns], win
// [ns, ny, nx] or null, sens [ny, nx] or null, rows [niter, 5] out,
// scratch of (16 + 3 * nparts) 32-bit words.
SKA_EXPORT int ska_msclean(void* res, const void* psf_ss, const void* cd,
                           const void* win, const void* sens, void* rows,
                           void* scratch, int nparts, int ns, int ny, int nx,
                           int py, int px, int niter, float gain,
                           float thresh, float fracthresh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nrows = ns * ny;
  if (nrows == 0 || nx == 0 || niter <= 0) return 0;
  const int rows_per_cta = (nrows + nparts - 1) / nparts;
  const int grid = (nrows + rows_per_cta - 1) / rows_per_cta;
  MsState* st = (MsState*)scratch;
  float* part_v = (float*)scratch + 16;
  int* part_i = (int*)scratch + 16 + nparts;
  float* part_m0 = (float*)scratch + 16 + 2 * nparts;
  SweepFn sweep = win ? (sens ? msclean_sweep<true, true> : msclean_sweep<true, false>)
                      : (sens ? msclean_sweep<false, true> : msclean_sweep<false, false>);
  cudaMemsetAsync(rows, 0, sizeof(float) * 5 * (size_t)niter, s);
  cudaMemsetAsync(st, 0, sizeof(MsState), s);
  float* r = (float*)res;
  const float* p = (const float*)psf_ss;
  const float* c = (const float*)cd;
  const float* w = (const float*)win;
  const float* sv = (const float*)sens;
  sweep<<<grid, kSweepThreads, 0, s>>>(r, p, c, w, sv, st, part_v, part_i,
                                       part_m0, ns, ny, nx, py, px,
                                       rows_per_cta, 1, 1);
  for (int it = 0; it < niter; ++it) {
    msclean_pick<<<1, kPickThreads, 0, s>>>(r, c, st, part_v, part_i,
                                            part_m0, grid, (float*)rows, it,
                                            ny, nx, gain, thresh, fracthresh);
    sweep<<<grid, kSweepThreads, 0, s>>>(r, p, c, w, sv, st, part_v, part_i,
                                         part_m0, ns, ny, nx, py, px,
                                         rows_per_cta, it + 1 < niter, 0);
  }
  return ska_last_error();
}
