// K8: the MSMFS (multi-scale multi-frequency CLEAN) minor-cycle loop,
// spread over the whole card.
//
// Replaces ska_sdp_func_python_tpu/ops/cleaners.py:_msmfs_corner_kernel
// (component rows, chained blocks). Like it, this kernel computes the
// minor loop of the JAX package's XLA loop, _msmfs_loop, and follows that
// loop's semantics rather than the TPU kernel's layout (no roll frame, no
// padded list rows, no VMEM shape gate: it runs at every size, window and
// peak criterion):
//   * the criterion of scale s at a pixel is the moment-0 principal
//     solution sol0 = sum_m ih[s, m, 0] smres[s, m] ("RASCIL"), or CASA's
//     2 sum_m sol_m smres_m - sum_{m,n} h[s, m, n] sol_m sol_n, times the
//     window stack when there is one;
//   * the scale is that of the first argmax of |criterion| over the whole
//     [scale, y, x] stack; the pixel is the first argmax of the UNWINDOWED
//     |sol0| of that scale (the reference's choice);
//   * mval[n] = sum_m ih[ms, m, n] smres[ms, m] at the pixel; stop BEFORE
//     the subtraction once |mval[0]| < absthresh (no 0.9 factor),
//     absthresh = max(thresh, fracthresh * max|smres[0, 0]|) taken once
//     from the initial stack;
//   * gm = gain * mval; every (scale t, moment qp) plane subtracts
//     sum_q canvas[ms, t, qp + q] * gm[q] over the PSF footprint centred on
//     the pixel and clipped at the image edges (the moment-moment PSF of
//     moments (qp, q) depends only on qp + q, so the canvas holds 2nm - 1
//     planes per (ms, t)); emit the row (y, x, scale, used, gm[0..nm-1]).
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), in the order of the plain version
// (msmfs_rows_plain), so the two agree bit for bit.
//
// As in K7 (msclean.cu), each iteration is two launches that the host
// enqueues for all iterations without reading the device:
//   sweep: one CTA per few image rows of one scale subtracts the current
//     pick's patch from all moment planes of its rows, rebuilds the
//     criterion there, and writes two (value, first index) partials: the
//     (windowed) criterion, and the unwindowed |sol0| of its scale;
//   pick: one CTA reduces the criterion partials to the scale, the |sol0|
//     partials of that scale's CTAs to the pixel, computes mval and the
//     stop rule, writes the row and publishes the next pick in a small
//     state block in device memory, with a done flag.
#include "common.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kPickThreads = 1024;
constexpr int kMaxMoments = 6;

struct MfState {
  int done;      // the loop has stopped
  int has_peak;  // the next sweep subtracts this pick
  int ms, my, mx;
  float absthresh;
  float gm[kMaxMoments];
};

// The scratch: the state in the first 32 words, then five arrays of
// nparts words each: criterion value and index, |sol0| value and index,
// and the initial max|smres[0, 0]|.
constexpr int kStateWords = 32;
static_assert(sizeof(MfState) <= kStateWords * sizeof(int), "state block");

// sum_m ih_s[m, n] * v[m] in m order, each operation rounded
template <int NM>
__device__ __forceinline__ float moment_solution(const float* __restrict__ ih_s,
                                                 const float (&v)[NM], int n) {
  float acc = __fmul_rn(ih_s[n], v[0]);
#pragma unroll
  for (int m = 1; m < NM; ++m)
    acc = __fadd_rn(acc, __fmul_rn(ih_s[m * NM + n], v[m]));
  return acc;
}

template <int NM, bool kWin, bool kCasa>
__global__ void __launch_bounds__(kSweepThreads)
    msmfs_sweep(float* __restrict__ res, const float* __restrict__ canvas,
                const float* __restrict__ hsmm,
                const float* __restrict__ ihsmm,
                const float* __restrict__ win,
                const MfState* __restrict__ st, float* __restrict__ part_cv,
                int* __restrict__ part_ci, float* __restrict__ part_sv,
                int* __restrict__ part_si, float* __restrict__ part_m0,
                int ns, int ny, int nx, int py, int px, int cps,
                int rows_per_cta, int search, int first) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  if (st->done) return;
  const int has_peak = st->has_peak;
  const int ms = has_peak ? st->ms : 0;
  const int my = has_peak ? st->my : 0;
  const int mx = has_peak ? st->mx : 0;
  float gm[NM];
#pragma unroll
  for (int q = 0; q < NM; ++q) gm[q] = has_peak ? st->gm[q] : 0.f;
  const int t = blockIdx.x / cps;
  const int y0 = (blockIdx.x - t * cps) * rows_per_cta;
  const int y1 = min(ny, y0 + rows_per_cta);
  const int cy = py / 2, cx = px / 2;
  const int x0 = max(0, mx - cx), x1 = min(nx, mx - cx + px);
  const size_t plane = (size_t)ny * nx;
  const size_t cplane = (size_t)py * px;
  float* res_t = res + (size_t)t * NM * plane;
  const float* ih_t = ihsmm + t * NM * NM;
  const float* h_t = hsmm + t * NM * NM;
  float cbest = -1.f, sbest = -1.f, m0 = 0.f;
  int cidx = INT_MAX, sidx = INT_MAX;
  for (int y = y0; y < y1; ++y) {
    const int dy = y - my + cy;
    const bool hit = has_peak && dy >= 0 && dy < py;
    // canvas[ms, t, 0, dy, :], shifted so that column x of the image
    // reads the PSF column x - mx + cx
    const float* crow =
        hit ? canvas + (((size_t)ms * ns + t) * (2 * NM - 1) * py + dy) * px +
                  (cx - mx)
            : nullptr;
    for (int x = threadIdx.x; x < nx; x += kSweepThreads) {
      const size_t o = (size_t)y * nx + x;
      float v[NM];
#pragma unroll
      for (int q = 0; q < NM; ++q) v[q] = res_t[q * plane + o];
      if (hit && x >= x0 && x < x1) {
#pragma unroll
        for (int qp = 0; qp < NM; ++qp) {
          float acc = __fmul_rn(crow[qp * cplane + x], gm[0]);
#pragma unroll
          for (int q = 1; q < NM; ++q)
            acc = __fadd_rn(acc, __fmul_rn(crow[(qp + q) * cplane + x], gm[q]));
          v[qp] = __fsub_rn(v[qp], acc);
          res_t[qp * plane + o] = v[qp];
        }
      }
      if (first && t == 0) m0 = fmaxf(m0, fabsf(v[0]));
      if (search) {
        const float sol0 = moment_solution<NM>(ih_t, v, 0);
        float crit = sol0;
        if (kCasa) {
          float sol[NM];
          sol[0] = sol0;
#pragma unroll
          for (int n = 1; n < NM; ++n) sol[n] = moment_solution<NM>(ih_t, v, n);
          float a = __fmul_rn(sol[0], v[0]);
#pragma unroll
          for (int m = 1; m < NM; ++m) a = __fadd_rn(a, __fmul_rn(sol[m], v[m]));
          float b = 0.f;
#pragma unroll
          for (int m = 0; m < NM; ++m) {
#pragma unroll
            for (int n = 0; n < NM; ++n) {
              const float term = __fmul_rn(__fmul_rn(h_t[m * NM + n], sol[m]), sol[n]);
              b = (m == 0 && n == 0) ? term : __fadd_rn(b, term);
            }
          }
          crit = __fsub_rn(__fmul_rn(2.f, a), b);
        }
        if (kWin) crit = __fmul_rn(crit, win[(size_t)t * plane + o]);
        ska_better(cbest, cidx, fabsf(crit), (int)((size_t)t * plane + o));
        ska_better(sbest, sidx, fabsf(sol0), (int)o);
      }
    }
  }
  if (search) {
    ska_block_argmax<kSweepThreads>(cbest, cidx, s_v, s_i);
    ska_block_argmax<kSweepThreads>(sbest, sidx, s_v, s_i);
    if (threadIdx.x == 0) {
      part_cv[blockIdx.x] = cbest;
      part_ci[blockIdx.x] = cidx;
      part_sv[blockIdx.x] = sbest;
      part_si[blockIdx.x] = sidx;
    }
  }
  if (first) {
    int unused = 0;
    ska_block_argmax<kSweepThreads>(m0, unused, s_v, s_i);
    if (threadIdx.x == 0) part_m0[blockIdx.x] = m0;
  }
}

template <int NM>
__global__ void __launch_bounds__(kPickThreads)
    msmfs_pick(const float* __restrict__ res, const float* __restrict__ ihsmm,
               MfState* __restrict__ st, const float* __restrict__ part_cv,
               const int* __restrict__ part_ci,
               const float* __restrict__ part_sv,
               const int* __restrict__ part_si,
               const float* __restrict__ part_m0, int nparts, int cps,
               float* __restrict__ rows, int it, int ny, int nx, float gain,
               float thresh, float fracthresh) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  if (st->done) return;
  float best = -1.f;
  int bidx = INT_MAX;
  for (int q = threadIdx.x; q < nparts; q += kPickThreads)
    ska_better(best, bidx, part_cv[q], part_ci[q]);
  ska_block_argmax<kPickThreads>(best, bidx, s_v, s_i);
  float absthresh;
  if (it == 0) {
    float m0 = 0.f;
    int unused = 0;
    for (int q = threadIdx.x; q < nparts; q += kPickThreads)
      m0 = fmaxf(m0, part_m0[q]);
    ska_block_argmax<kPickThreads>(m0, unused, s_v, s_i);
    absthresh = fmaxf(thresh, __fmul_rn(fracthresh, m0));
    if (threadIdx.x == 0) st->absthresh = absthresh;
  } else {
    absthresh = st->absthresh;
  }
  if (bidx == INT_MAX) {  // uniform across the block
    if (threadIdx.x == 0) {
      st->done = 1;
      st->has_peak = 0;
    }
    return;
  }
  const size_t plane = (size_t)ny * nx;
  const int s = (int)(bidx / plane);
  // the pixel: first argmax of the unwindowed |sol0| of scale s, over the
  // partials of that scale's CTAs
  float sv = -1.f;
  int sidx = INT_MAX;
  for (int q = threadIdx.x; q < cps; q += kPickThreads)
    ska_better(sv, sidx, part_sv[s * cps + q], part_si[s * cps + q]);
  ska_block_argmax<kPickThreads>(sv, sidx, s_v, s_i);
  if (threadIdx.x != 0) return;
  if (sidx == INT_MAX) {
    st->done = 1;
    st->has_peak = 0;
    return;
  }
  const int y = sidx / nx;
  const int x = sidx - y * nx;
  const float* res_s = res + (size_t)s * NM * plane + sidx;
  float v[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) v[m] = res_s[m * plane];
  const float* ih_s = ihsmm + s * NM * NM;
  float mval[NM];
#pragma unroll
  for (int n = 0; n < NM; ++n) mval[n] = moment_solution<NM>(ih_s, v, n);
  if (fabsf(mval[0]) < absthresh) {
    st->done = 1;
    st->has_peak = 0;
    return;
  }
  float* row = rows + (size_t)(4 + NM) * it;
  row[0] = (float)y;
  row[1] = (float)x;
  row[2] = (float)s;
  row[3] = 1.f;
  st->ms = s;
  st->my = y;
  st->mx = x;
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    const float g = __fmul_rn(gain, mval[n]);
    st->gm[n] = g;
    row[4 + n] = g;
  }
  st->has_peak = 1;
}

template <int NM>
int run(float* res, const float* canvas, const float* hsmm,
        const float* ihsmm, const float* win, float* rows, int* scratch,
        int cps, int rows_per_cta, int ns, int ny, int nx, int py, int px,
        int niter, bool casa, float gain, float thresh, float fracthresh,
        cudaStream_t s) {
  using SweepFn = void (*)(float*, const float*, const float*, const float*,
                           const float*, const MfState*, float*, int*, float*,
                           int*, float*, int, int, int, int, int, int, int,
                           int, int);
  const int nparts = ns * cps;
  MfState* st = (MfState*)scratch;
  float* part_cv = (float*)(scratch + kStateWords);
  int* part_ci = scratch + kStateWords + nparts;
  float* part_sv = (float*)(scratch + kStateWords + 2 * nparts);
  int* part_si = scratch + kStateWords + 3 * nparts;
  float* part_m0 = (float*)(scratch + kStateWords + 4 * nparts);
  SweepFn sweep =
      win ? (casa ? msmfs_sweep<NM, true, true> : msmfs_sweep<NM, true, false>)
          : (casa ? msmfs_sweep<NM, false, true> : msmfs_sweep<NM, false, false>);
  cudaMemsetAsync(rows, 0, sizeof(float) * (4 + NM) * (size_t)niter, s);
  cudaMemsetAsync(st, 0, sizeof(MfState), s);
  sweep<<<nparts, kSweepThreads, 0, s>>>(res, canvas, hsmm, ihsmm, win, st,
                                         part_cv, part_ci, part_sv, part_si,
                                         part_m0, ns, ny, nx, py, px, cps,
                                         rows_per_cta, 1, 1);
  for (int it = 0; it < niter; ++it) {
    msmfs_pick<NM><<<1, kPickThreads, 0, s>>>(
        res, ihsmm, st, part_cv, part_ci, part_sv, part_si, part_m0, nparts,
        cps, rows, it, ny, nx, gain, thresh, fracthresh);
    sweep<<<nparts, kSweepThreads, 0, s>>>(res, canvas, hsmm, ihsmm, win, st,
                                           part_cv, part_ci, part_sv, part_si,
                                           part_m0, ns, ny, nx, py, px, cps,
                                           rows_per_cta, it + 1 < niter, 0);
  }
  return ska_last_error();
}

}  // namespace

// One lane: res [ns, nm, ny, nx] (updated in place: the wrapper passes a
// copy of the initial stack), canvas [ns, ns, 2nm-1, py, px], hsmm and
// ihsmm [ns, nm, nm], win [ns, ny, nx] or null, rows [niter, 4 + nm] out,
// scratch of (32 + 5 * ns * cps) 32-bit words. The sweep runs cps CTAs per
// scale, each over rows_per_cta image rows.
SKA_EXPORT int ska_msmfs(void* res, const void* canvas, const void* hsmm,
                         const void* ihsmm, const void* win, void* rows,
                         void* scratch, int cps, int rows_per_cta, int ns,
                         int nm, int ny, int nx, int py, int px, int niter,
                         int casa, float gain, float thresh, float fracthresh,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ns == 0 || ny == 0 || nx == 0 || niter <= 0) return 0;
  float* r = (float*)res;
  const float* c = (const float*)canvas;
  const float* h = (const float*)hsmm;
  const float* ih = (const float*)ihsmm;
  const float* w = (const float*)win;
  float* out = (float*)rows;
  int* sc = (int*)scratch;
#define SKA_MSMFS_CASE(NM)                                                     \
  case NM:                                                                     \
    return run<NM>(r, c, h, ih, w, out, sc, cps, rows_per_cta, ns, ny, nx, py, \
                   px, niter, casa != 0, gain, thresh, fracthresh, s);
  switch (nm) {
    SKA_MSMFS_CASE(1)
    SKA_MSMFS_CASE(2)
    SKA_MSMFS_CASE(3)
    SKA_MSMFS_CASE(4)
    SKA_MSMFS_CASE(5)
    SKA_MSMFS_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SKA_MSMFS_CASE
}
