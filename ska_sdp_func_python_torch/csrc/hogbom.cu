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
// Each iteration of a (chan, pol) lane:
//   * mval = val * gain / pmax at the current peak;
//   * mval * PSF is subtracted over the PSF footprint around the peak,
//     clipped at the image edges as overlapIndices clips, and the next
//     peak of |residual * window| is found, ties to the first index in
//     row-major order;
//   * K5 stops when |val - mval * psf_centre| < 0.9 * absthresh, with
//     absthresh = max(thresh, fracthresh * max|dirty|).
// The residual update res - psf * mval is one fused multiply-add with a
// single rounding (__fmaf_rn), the rounding the JAX package's CPU loop
// gets from XLA's multiply-subtract contraction and the plain version
// reproduces in f64; mval = val * gain / pmax is rounded per operation
// (__fmul_rn, __fdiv_rn), so no other contraction changes a result and
// near-tied peaks resolve the same way. The window (1 = allowed) only
// masks the search, |res * window| rounded as __fmul_rn.
//
// K6 differs in three places, each of which changes which components come
// out, and follows the JAX package's XLA loop in all three: the search is
// hypot(Q, U) (the TPU list kernel searches Q^2 + U^2 and may break
// near-ties otherwise); pmax is the peak of the (Q) PSF; the loop stops
// when |res_new[peak]| < absthresh with no 0.9 factor, where
// absthresh = max(thresh, fracthresh * max hypot(Q, U)).
//
// What bounds them on the card: an iteration reads the residual once for
// the search and read-modify-writes it against the PSF over the footprint
// (at 1024^2 with a 1024^2 PSF patch, up to 12 MB per plane, held in the
// 50 MB L2), a few microseconds of traffic, but each iteration depends on
// the one before. So one lane is spread over the card and the loop is one
// persistent kernel, launched cooperatively so that every CTA is resident:
//   * the lanes of a launch share the resident CTAs; each lane has `ctas`
//     CTAs, each over a band of `band` contiguous rows (the wrapper's
//     split: all of them for one lane, a few each for 64 lanes of 256^2,
//     one each when the lanes outnumber them, in several launches);
//   * per iteration each CTA subtracts the current peak's footprint from
//     its rows and searches them, walking rows x columns (threads over
//     whole rows, several rows at once when a row is narrower than the
//     CTA, and the loads of four pixels issued before any is used), and
//     writes its (value, first index, residual) partial into a buffer
//     chosen by the iteration's parity; a CTA whose band misses the
//     footprint did not change and writes the partial it kept;
//   * after one barrier of the lane's CTAs (an arrival counter per lane;
//     lanes do not wait for each other) every CTA reduces its lane's
//     partials itself (first index on ties, so the row-major order holds
//     across CTAs), so each knows the next peak, mval and the stop decision
//     without a second barrier, and all CTAs of a lane stop together; the
//     parity buffers keep a fast CTA's next partial from overwriting one a
//     slow CTA is still reading;
//   * the start pass (residual = dirty, the first peak, the maximum for
//     the threshold and the PSF peak) is the same sweep with one barrier.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBatch = 4;  // pixels whose loads a thread issues together
constexpr int kPart = 8;   // floats per partial: key, index, v0, v1, amax, pmax

struct Args {
  const float* dirty[2];  // K5: dirty[0]; K6: Q, U
  const float* psf;
  const float* window;  // or null
  float* res[2];
  float* rows;
  float* part;  // [2][nlanes * ctas][kPart]
  int* bar;     // [nlanes], zeroed: arrivals at the lane's barriers
  int nlanes, ctas, band, ny, nx, py, px, niter;
  float gain, thresh, fracthresh;
};

template <bool kComplex>
__device__ __forceinline__ float search_key(const float* v, bool win, float wv) {
  if (kComplex)
    return win ? hypotf(__fmul_rn(v[0], wv), __fmul_rn(v[1], wv)) : hypotf(v[0], v[1]);
  return win ? fabsf(__fmul_rn(v[0], wv)) : fabsf(v[0]);
}

// The first-index argmax of the `ctas` partials at `part`; every thread of
// the CTA gets the peak's index and residual values (index INT_MAX if no
// partial has one). The value travels with the partial, so the winning
// thread hands it over in shared memory.
template <int NP>
__device__ void lane_peak(const float* part, int ctas, int& bidx, float* val,
                          float* s_v, int* s_i, float* s_val) {
  float kv = -1.f, kval[2] = {0.f, 0.f};
  int ki = INT_MAX;
  for (int q = threadIdx.x; q < ctas; q += kThreads) {
    const float4 e = __ldcg(reinterpret_cast<const float4*>(part + kPart * q));
    const int i = __float_as_int(e.y);
    if (e.x > kv || (e.x == kv && i < ki)) {
      kv = e.x;
      ki = i;
      kval[0] = e.z;
      kval[1] = e.w;
    }
  }
  bidx = ki;
  ska_block_argmax<kThreads>(kv, bidx, s_v, s_i);
  if (bidx != INT_MAX && ki == bidx)  // indices are unique: one writer
    for (int k = 0; k < NP; ++k) s_val[k] = kval[k];
  __syncthreads();
  for (int k = 0; k < NP; ++k) val[k] = bidx == INT_MAX ? 0.f : s_val[k];
}

// The CTA's (key, first index, residual) partial from each thread's best:
// the winning thread keeps it in s_kept and writes it to `out` (thread 0
// writes an empty one if the band has no candidate).
template <int NP>
__device__ void band_partial(float best, int bi, const float* bv, float* out,
                             float* s_v, int* s_i, float* s_kept) {
  float v = best;
  int i = bi;
  ska_block_argmax<kThreads>(v, i, s_v, s_i);
  if ((i != INT_MAX && bi == i) || (i == INT_MAX && threadIdx.x == 0)) {
    s_kept[0] = v;
    s_kept[1] = __int_as_float(i);
    s_kept[2] = i == INT_MAX ? 0.f : bv[0];
    s_kept[3] = i == INT_MAX || NP == 1 ? 0.f : bv[NP - 1];
    *reinterpret_cast<float4*>(out) = make_float4(s_kept[0], s_kept[1], s_kept[2], s_kept[3]);
  }
}

// Where a thread works in a band: columns tx, tx + tpr, ... of rows
// b0 + ty, b0 + ty + rps, ... (tpr threads a row, rps rows at once).
struct Walk {
  int tpr, rps, ty, tx;
};

// One pass over the band [b0, b1) of one lane. At the start (kStart) the
// residual r becomes the dirty image d and amax gathers the band's maximum
// for the threshold; otherwise m * PSF is subtracted over the footprint
// [y0, y1) x [x0, x1), whose PSF pixel for (y, x) is p[y * px + x + poff].
// Each thread keeps its best (key, first index, residual values).
template <bool kComplex, bool kStart>
__device__ __forceinline__ void sweep(const Walk& t, int nx, int b0, int b1,
                                      const float* const* d, float* const* r,
                                      const float* w, const float* p, int px,
                                      int poff, const float* m, int y0,
                                      int y1, int x0, int x1, float& best,
                                      int& bi, float* bv, float& amax) {
  constexpr int NP = kComplex ? 2 : 1;
  int y = t.ty < t.rps && t.tx < nx ? b0 + t.ty : b1;
  int x = t.tx;
  while (y < b1) {
    int q[kBatch], iy[kBatch], ix[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      iy[u] = y;
      ix[u] = x;
      q[u] = y * nx + x;
      x += t.tpr;
      if (x >= nx) {
        x = t.tx;
        y += t.rps;
      }
    }
    // the loads of the batch first
    float v[kBatch][NP], pv[kBatch], wv[kBatch];
    bool hit[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      wv[u] = 1.f;
      hit[u] = false;
      if (iy[u] >= b1) continue;
      for (int k = 0; k < NP; ++k) v[u][k] = kStart ? d[k][q[u]] : r[k][q[u]];
      if (!kStart) {
        hit[u] = iy[u] >= y0 && iy[u] < y1 && ix[u] >= x0 && ix[u] < x1;
        if (hit[u]) pv[u] = p[iy[u] * px + ix[u] + poff];
      }
      if (w) wv[u] = w[q[u]];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (iy[u] >= b1) continue;
      if (kStart) {
        for (int k = 0; k < NP; ++k) r[k][q[u]] = v[u][k];
        amax = fmaxf(amax, kComplex ? hypotf(v[u][0], v[u][NP - 1]) : fabsf(v[u][0]));
      } else if (hit[u]) {
        for (int k = 0; k < NP; ++k) {
          v[u][k] = __fmaf_rn(-pv[u], m[k], v[u][k]);
          r[k][q[u]] = v[u][k];
        }
      }
      const float key = search_key<kComplex>(v[u], w != nullptr, wv[u]);
      if (key > best || (key == best && q[u] < bi)) {
        best = key;
        bi = q[u];
        for (int k = 0; k < NP; ++k) bv[k] = v[u][k];
      }
    }
  }
}

template <bool kComplex>
__global__ void __launch_bounds__(kThreads, 2) hogbom_loop(const Args a) {
  constexpr int NP = kComplex ? 2 : 1;
  constexpr int kRow = kComplex ? 5 : 4;
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  __shared__ float s_val[2];
  __shared__ __align__(16) float s_kept[4];
  const int lane = blockIdx.x / a.ctas;
  const int c = blockIdx.x - lane * a.ctas;
  const int ny = a.ny, nx = a.nx, py = a.py, px = a.px;
  const size_t npx = (size_t)ny * nx;
  const float* d[NP];
  float* r[NP];
  for (int k = 0; k < NP; ++k) {
    d[k] = a.dirty[k] + lane * npx;
    r[k] = a.res[k] + lane * npx;
  }
  const float* p = a.psf + (size_t)lane * py * px;
  const float* w = a.window ? a.window + lane * npx : nullptr;
  float* rows = a.rows + (size_t)lane * a.niter * kRow;
  int* bar = a.bar + lane;
  // the lane's partials in the buffer of parity 0; parity 1 is `stride` on
  const size_t stride = (size_t)a.nlanes * a.ctas * kPart;
  float* part0 = a.part + (size_t)lane * a.ctas * kPart;
  const int b0 = c * a.band, b1 = min(ny, b0 + a.band);
  const int cy = py / 2, cx = px / 2;
  const bool leader = c == 0 && threadIdx.x == 0;
  Walk t;
  t.tpr = min(kThreads, (nx + 31) & ~31);
  t.rps = kThreads / t.tpr;
  t.ty = threadIdx.x / t.tpr;
  t.tx = threadIdx.x - t.ty * t.tpr;

  // start: residual = dirty, the band's first peak and maximum, and the
  // PSF peak over this CTA's share of the PSF rows
  float best = -1.f, amax = -1.f, pmax = -FLT_MAX, bv[NP] = {};
  int bi = INT_MAX;
  sweep<kComplex, true>(t, nx, b0, b1, d, r, w, p, px, 0, nullptr, 0, 0, 0, 0,
                        best, bi, bv, amax);
  const int pband = (py + a.ctas - 1) / a.ctas;
  for (int y = c * pband; y < min(py, (c + 1) * pband); ++y)
    for (int x = threadIdx.x; x < px; x += kThreads) pmax = fmaxf(pmax, p[y * px + x]);
  band_partial<NP>(best, bi, bv, part0 + kPart * c, s_v, s_i, s_kept);
  int unused = 0;
  ska_block_argmax<kThreads>(amax, unused, s_v, s_i);
  ska_block_argmax<kThreads>(pmax, unused, s_v, s_i);
  if (threadIdx.x == 0) {
    part0[kPart * c + 4] = amax;
    part0[kPart * c + 5] = pmax;
  }
  ska_lane_barrier(bar, a.ctas);

  int bidx;
  float val[NP];
  lane_peak<NP>(part0, a.ctas, bidx, val, s_v, s_i, s_val);
  amax = -1.f;
  pmax = -FLT_MAX;
  for (int q = threadIdx.x; q < a.ctas; q += kThreads) {
    amax = fmaxf(amax, __ldcg(part0 + kPart * q + 4));
    pmax = fmaxf(pmax, __ldcg(part0 + kPart * q + 5));
  }
  ska_block_argmax<kThreads>(amax, unused, s_v, s_i);
  ska_block_argmax<kThreads>(pmax, unused, s_v, s_i);
  const float absthresh = fmaxf(a.thresh, __fmul_rn(a.fracthresh, amax));
  const float stop = kComplex ? absthresh : __fmul_rn(0.9f, absthresh);
  const float psf_c = p[cy * px + cx];

  // every CTA of the lane takes the same decisions from the same peak, so
  // they leave the loop together
  for (int it = 0; it < a.niter && bidx != INT_MAX; ++it) {
    float* next = part0 + ((it + 1) & 1) * stride;
    const int my = bidx / nx;
    const int mx = bidx - my * nx;
    float m[NP];
    for (int k = 0; k < NP; ++k) m[k] = __fdiv_rn(__fmul_rn(val[k], a.gain), pmax);
    // footprint of the PSF centred on the peak, clipped to the image
    const int y0 = max(0, my - cy), y1 = min(ny, my - cy + py);
    const int x0 = max(0, mx - cx), x1 = min(nx, mx - cx + px);
    if (b0 < y1 && y0 < b1) {
      best = -1.f;
      bi = INT_MAX;
      sweep<kComplex, false>(t, nx, b0, b1, d, r, w, p, px,
                             (cy - my) * px + (cx - mx), m, y0, y1, x0, x1,
                             best, bi, bv, amax);
      band_partial<NP>(best, bi, bv, next + kPart * c, s_v, s_i, s_kept);
    } else if (threadIdx.x == 0) {  // the band did not change
      *reinterpret_cast<float4*>(next + kPart * c) =
          *reinterpret_cast<const float4*>(s_kept);
    }
    if (leader) {
      float* row = rows + kRow * (size_t)it;
      row[0] = (float)my;
      row[1] = (float)mx;
      for (int k = 0; k < NP; ++k) row[2 + k] = m[k];
      row[kRow - 1] = 1.f;
    }
    float nv[NP];
    for (int k = 0; k < NP; ++k) nv[k] = __fmaf_rn(-m[k], psf_c, val[k]);
    const float mag = kComplex ? hypotf(nv[0], nv[NP - 1]) : fabsf(nv[0]);
    if (mag < stop || it + 1 == a.niter) break;
    ska_lane_barrier(bar, (it + 2) * a.ctas);
    lane_peak<NP>(next, a.ctas, bidx, val, s_v, s_i, s_val);
  }
}

template <bool kComplex>
int run(Args a, int nlanes, int per_launch, void* scratch, cudaStream_t s) {
  constexpr int NP = kComplex ? 2 : 1;
  constexpr int kRow = kComplex ? 5 : 4;
  if (nlanes <= 0) return 0;
  if (per_launch <= 0 || a.ctas <= 0 || a.band <= 0) return (int)cudaErrorInvalidValue;
  const size_t npx = (size_t)a.ny * a.nx;
  cudaMemsetAsync(a.rows, 0, sizeof(float) * kRow * (size_t)nlanes * a.niter, s);
  a.part = (float*)scratch;
  a.bar = (int*)scratch + 2 * kPart * (size_t)per_launch * a.ctas;
  const Args whole = a;
  for (int l0 = 0; l0 < nlanes; l0 += per_launch) {
    a.nlanes = min(per_launch, nlanes - l0);
    for (int k = 0; k < NP; ++k) {
      a.dirty[k] = whole.dirty[k] + l0 * npx;
      a.res[k] = whole.res[k] + l0 * npx;
    }
    a.psf = whole.psf + (size_t)l0 * a.py * a.px;
    a.window = whole.window ? whole.window + l0 * npx : nullptr;
    a.rows = whole.rows + (size_t)l0 * a.niter * kRow;
    cudaMemsetAsync(a.bar, 0, sizeof(int) * (size_t)a.nlanes, s);
    void* args[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)hogbom_loop<kComplex>, dim3(a.nlanes * a.ctas),
        dim3(kThreads), args, 0, s);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  return ska_last_error();
}

}  // namespace

// CTAs of the K5 (cplx 0) or K6 (cplx 1) kernel that can be resident on
// the current device at once: the SMs times the occupancy of one SM.
// Returns minus the CUDA error on failure.
SKA_EXPORT int ska_hogbom_resident(int cplx) {
  return ska_coop_resident(
      cplx ? (const void*)hogbom_loop<true> : (const void*)hogbom_loop<false>, kThreads, 0);
}

// dirty, res [nlanes, ny, nx]; psf [nlanes, py, px]; window as dirty or
// null; comps [nlanes, niter, 4] out; scratch of
// 16 * per_launch * ctas + per_launch 32-bit words. Lanes go in launches of
// per_launch, each lane on `ctas` CTAs of `band` rows.
SKA_EXPORT int ska_hogbom(const void* dirty, const void* psf,
                          const void* window, void* res, void* comps,
                          void* scratch, int nlanes, int per_launch, int ctas,
                          int band, int ny, int nx, int py, int px, int niter,
                          float gain, float thresh, float fracthresh,
                          void* stream) {
  Args a{};
  a.dirty[0] = (const float*)dirty;
  a.psf = (const float*)psf;
  a.window = (const float*)window;
  a.res[0] = (float*)res;
  a.rows = (float*)comps;
  a.ctas = ctas;
  a.band = band;
  a.ny = ny;
  a.nx = nx;
  a.py = py;
  a.px = px;
  a.niter = niter;
  a.gain = gain;
  a.thresh = thresh;
  a.fracthresh = fracthresh;
  return run<false>(a, nlanes, per_launch, scratch, (cudaStream_t)stream);
}

// As ska_hogbom for Q and U with one real PSF; rows [nlanes, niter, 5].
SKA_EXPORT int ska_hogbom_complex(const void* dirty_q, const void* dirty_u,
                                  const void* psf, const void* window,
                                  void* res_q, void* res_u, void* rows,
                                  void* scratch, int nlanes, int per_launch,
                                  int ctas, int band, int ny, int nx, int py,
                                  int px, int niter, float gain, float thresh,
                                  float fracthresh, void* stream) {
  Args a{};
  a.dirty[0] = (const float*)dirty_q;
  a.dirty[1] = (const float*)dirty_u;
  a.psf = (const float*)psf;
  a.window = (const float*)window;
  a.res[0] = (float*)res_q;
  a.res[1] = (float*)res_u;
  a.rows = (float*)rows;
  a.ctas = ctas;
  a.band = band;
  a.ny = ny;
  a.nx = nx;
  a.py = py;
  a.px = px;
  a.niter = niter;
  a.gain = gain;
  a.thresh = thresh;
  a.fracthresh = fracthresh;
  return run<true>(a, nlanes, per_launch, scratch, (cudaStream_t)stream);
}
