// K7: the msclean minor-cycle loop in one cooperative launch, each CTA's
// band of the residual stack and of the component image held on chip.
//
// Replaces ska_sdp_func_python_tpu/ops/cleaners.py:_msclean_corner_kernel
// (component rows, chained blocks) and _msclean_pallas_kernel (K7v1,
// components as an image). Both compute the minor loop of the JAX
// package's XLA fallback, _msclean_loop, which this kernel follows; it
// emits both outputs, the rows and the component image:
//   * search |res_s / cd_s * window_s * sens * sens| over the whole
//     [scale, y, x] stack, first index in (scale, y, x) order on ties;
//   * stop BEFORE the subtraction once |res[peak]| < 0.9 * absthresh,
//     absthresh = max(thresh, fracthresh * max|res_stack[0]|) taken once
//     from the initial stack;
//   * gm = gain * (res[peak] / cd[peak scale]); every scale plane s'
//     subtracts psf_ss[s', peak scale] * gm over the PSF footprint centred
//     on the peak and clipped at the image edges; the component image adds
//     pscalestack[peak scale] * gm over the same footprint; emit the row
//     (y, x, scale, gm, used).
// The residual stack stays unscaled (divided by cd only in the search) and
// every update is one fused multiply-add (__fmaf_rn), the rounding of the
// XLA loop on the CPU (it contracts res - patch * gm); divisions and
// products are rounded per operation (__fdiv_rn, __fmul_rn), and the
// component image adds __fmul_rn(blob, gm) with __fadd_rn in emission
// order. So the plain version (msclean_rows_plain, and
// msclean_rows_to_comps of its rows) and this kernel agree bit for bit.
//
// What bounds it on the card: at the flagship the stack is 4 x 1024^2 f32 =
// 16.8 MB and the component image 4.2 MB; each iteration searches the
// whole stack and read-modify-writes it over the PSF footprint (most of
// the image for a 1024^2 PSF), and each depends on the one before. So the
// loop is one persistent kernel, launched cooperatively so that every CTA
// is resident (as K5, hogbom.cu):
//   * the lanes of a launch share the resident CTAs (the wrapper's split,
//     cleaners.clean_split); each lane has `ctas` CTAs, each over a band of
//     `band` contiguous image rows in EVERY scale plane, so that the
//     footprint covers the same rows in each plane and the work per band
//     stays balanced;
//   * the band ([ns, band, nx] of the stack and [band, nx] of the component
//     image) lives in dynamic shared memory for the whole loop and goes to
//     device memory once, at the end: (ns + 1) * band * nx * 4 bytes, which
//     the card allows up to its opt-in limit per CTA (227 KB on the H100,
//     less the kernel's static shared memory) and the lanes' CTAs must fit
//     the resident count at that size (about 30 MB over the card). A stack
//     beyond that (4 x 2048^2, or lanes times stack beyond ~30 MB) keeps its
//     band in device memory, in the output arrays, and runs the same loop:
//     the template parameter kShared, which the wrapper picks from the
//     sizes;
//   * per iteration each CTA subtracts the current peak's footprint from
//     its band, reading psf_ss[:, ms] and pscalestack[ms] from device memory
//     (L2-resident while the peak's scale repeats), and searches the band
//     (the loads of four pixels issued before any is used), then writes
//     its (key, first index, residual) partial into a buffer chosen by the
//     iteration's parity; a CTA whose band misses the footprint did not
//     change and writes the partial it kept;
//   * after one barrier of the lane's CTAs every CTA reduces its lane's
//     partials itself (first index on ties, so the (scale, y, x) order
//     holds across bands), so each knows the next peak, gm and the stop
//     decision without a second barrier; all CTAs of a lane stop together
//     and nothing runs after the stop;
//   * the start pass (band = initial stack, the first peak and the maximum
//     of |res[0]| for the threshold) is the same sweep with one barrier.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBatch = 4;  // pixels whose loads a thread issues together
constexpr int kPart = 4;   // floats per partial: key, index, residual, max|res[0]|
constexpr int kRow = 5;    // y, x, scale, gm, used

struct Args {
  const float* in;      // [nlanes, ns, ny, nx] initial residual stacks
  const float* psf_ss;  // [nlanes, ns, ns, py, px]
  const float* cd;      // [nlanes, ns]
  const float* win;     // [nlanes, ns, ny, nx] or null
  const float* sens;    // [nlanes, ny, nx] or null
  const float* blobs;   // [nlanes, ns, py, px] the scale blobs (pscalestack)
  float* res;           // [nlanes, ns, ny, nx] out
  float* comps;         // [nlanes, ny, nx] out
  float* rows;          // [nlanes, niter, kRow] out
  float* part;          // [2][nlanes * ctas][kPart]
  int* bar;             // [nlanes], zeroed: arrivals at the lane's barriers
  int nlanes, ctas, band, ns, ny, nx, py, px, niter;
  float gain, thresh, fracthresh;
};

// Where a thread works in a band: columns tx, tx + tpr, ... of rows
// ty, ty + rps, ... (tpr threads a row, rps rows at once).
struct Walk {
  int tpr, rps, ty, tx;
};

// The peak being subtracted: its footprint [y0, y1) x [x0, x1), whose PSF
// pixel for image pixel (y, x) is plane[y * px + x + poff], and gm.
struct Peak {
  int y0, y1, x0, x1, poff;
  float gm;
};

// One pass over scale plane s of the band of nb rows from image row b0.
// The band's plane is `bs` (row b0 at bs[0], rows nx apart) and the
// component band `cb`, touched in plane 0. At the start (kStart) the band
// becomes the input plane `is` and amax gathers max|res[0]|; otherwise
// gm * `ps` (psf_ss[s, ms]) is subtracted over the footprint and, in plane
// 0, gm * `bl` (the blob of scale ms) added to the component band. Each
// thread keeps its best (key, first flat index, residual): it visits its
// pixels in increasing flat index (scales in order, then rows, then
// columns), so only a strictly larger key replaces its best; ties between
// threads and bands go to the smaller index in the reductions.
template <bool kStart, bool kWin, bool kSens>
__device__ __forceinline__ void sweep(const Walk& t, int s, int b0, int nb,
                                      int ny, int nx, int px, const float* is,
                                      float* bs, float* cb, const float* ps,
                                      const float* bl, const float* ws,
                                      const float* sens, float cds,
                                      const Peak& pk, float& best, int& bi,
                                      float& bv, float& amax) {
  const int qs = s * ny * nx;
  int yl = t.ty < t.rps && t.tx < nx ? t.ty : nb;
  int x = t.tx;
  while (yl < nb) {
    int iy[kBatch], ix[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      iy[u] = yl;
      ix[u] = x;
      x += t.tpr;
      if (x >= nx) {
        x = t.tx;
        yl += t.rps;
      }
    }
    // the loads of the batch first
    float v[kBatch], pv[kBatch], bv_[kBatch], cv[kBatch], wv[kBatch], sv[kBatch];
    bool hit[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      hit[u] = false;
      if (iy[u] >= nb) continue;
      const int y = b0 + iy[u];
      const int o = iy[u] * nx + ix[u];
      const int g = y * nx + ix[u];
      v[u] = kStart ? is[g] : bs[o];
      if (!kStart) {
        hit[u] = y >= pk.y0 && y < pk.y1 && ix[u] >= pk.x0 && ix[u] < pk.x1;
        if (hit[u]) {
          const int pq = y * px + ix[u] + pk.poff;
          pv[u] = ps[pq];
          if (s == 0) {
            bv_[u] = bl[pq];
            cv[u] = cb[o];
          }
        }
      }
      if (kWin) wv[u] = ws[g];
      if (kSens) sv[u] = sens[g];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (iy[u] >= nb) continue;
      const int y = b0 + iy[u];
      const int o = iy[u] * nx + ix[u];
      if (kStart) {
        bs[o] = v[u];
        if (s == 0) {
          amax = fmaxf(amax, fabsf(v[u]));
          cb[o] = 0.f;
        }
      } else if (hit[u]) {
        v[u] = __fmaf_rn(-pv[u], pk.gm, v[u]);
        bs[o] = v[u];
        if (s == 0) cb[o] = __fadd_rn(cv[u], __fmul_rn(bv_[u], pk.gm));
      }
      float k = __fdiv_rn(v[u], cds);
      if (kWin) k = __fmul_rn(k, wv[u]);
      if (kSens) k = __fmul_rn(__fmul_rn(k, sv[u]), sv[u]);
      k = fabsf(k);
      if (k > best) {  // a thread's pixels come in increasing flat index
        best = k;
        bi = qs + y * nx + ix[u];
        bv = v[u];
      }
    }
  }
}

// The CTA's (key, first index, residual, amax) partial from each thread's
// best: the winning thread keeps it in s_kept and writes it to `out`
// (thread 0 writes an empty one if the band has no candidate).
__device__ void band_partial(float best, int bi, float bv, float amax,
                             float* out, float* s_v, int* s_i, float* s_kept) {
  float v = best;
  int i = bi;
  ska_block_argmax<kThreads>(v, i, s_v, s_i);
  if ((i != INT_MAX && bi == i) || (i == INT_MAX && threadIdx.x == 0)) {
    s_kept[0] = v;
    s_kept[1] = __int_as_float(i);
    s_kept[2] = i == INT_MAX ? 0.f : bv;
    s_kept[3] = amax;
    *reinterpret_cast<float4*>(out) = make_float4(s_kept[0], s_kept[1], s_kept[2], s_kept[3]);
  }
}

// The first-index argmax of the lane's `ctas` partials at `part`: every
// thread gets the peak's flat index (INT_MAX if no partial has one) and
// residual, and with `start` the maximum of the partials' amax.
__device__ void lane_peak(const float* part, int ctas, bool start, int& bidx,
                          float& val, float& amax, float* s_v, int* s_i,
                          float* s_val) {
  float kv = -1.f, kval = 0.f, am = 0.f;
  int ki = INT_MAX;
  for (int q = threadIdx.x; q < ctas; q += kThreads) {
    const float4 e = __ldcg(reinterpret_cast<const float4*>(part + kPart * q));
    const int i = __float_as_int(e.y);
    if (e.x > kv || (e.x == kv && i < ki)) {
      kv = e.x;
      ki = i;
      kval = e.z;
    }
    am = fmaxf(am, e.w);
  }
  bidx = ki;
  ska_block_argmax<kThreads>(kv, bidx, s_v, s_i);
  if (bidx != INT_MAX && ki == bidx) *s_val = kval;  // indices are unique
  __syncthreads();
  val = bidx == INT_MAX ? 0.f : *s_val;
  if (start) {
    int unused = 0;
    ska_block_argmax<kThreads>(am, unused, s_v, s_i);
    amax = am;
  }
}

template <bool kShared, bool kWin, bool kSens>
__global__ void __launch_bounds__(kThreads, 2) msclean_loop(const Args a) {
  extern __shared__ __align__(16) float s_band[];
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  __shared__ float s_val;
  __shared__ __align__(16) float s_kept[kPart];
  const int lane = blockIdx.x / a.ctas;
  const int c = blockIdx.x - lane * a.ctas;
  const int ns = a.ns, ny = a.ny, nx = a.nx, py = a.py, px = a.px;
  const size_t npx = (size_t)ny * nx, ppx = (size_t)py * px;
  const float* in = a.in + lane * ns * npx;
  const float* psf = a.psf_ss + lane * ns * ns * ppx;
  const float* cd = a.cd + lane * ns;
  const float* win = kWin ? a.win + lane * ns * npx : nullptr;
  const float* sens = kSens ? a.sens + lane * npx : nullptr;
  const float* blobs = a.blobs + lane * ns * ppx;
  float* res = a.res + lane * ns * npx;
  float* comps = a.comps + lane * npx;
  float* rows = a.rows + (size_t)lane * a.niter * kRow;
  int* bar = a.bar + lane;
  // the lane's partials in the buffer of parity 0; parity 1 is `stride` on
  const size_t stride = (size_t)a.nlanes * a.ctas * kPart;
  float* part0 = a.part + (size_t)lane * a.ctas * kPart;
  const int b0 = c * a.band, nb = min(ny, b0 + a.band) - b0;
  // the band: plane s at band + s * bplane, the component rows at cband
  const size_t bplane = kShared ? (size_t)a.band * nx : npx;
  float* band = kShared ? s_band : res + (size_t)b0 * nx;
  float* cband = kShared ? s_band + ns * bplane : comps + (size_t)b0 * nx;
  const int cy = py / 2, cx = px / 2;
  const bool leader = c == 0 && threadIdx.x == 0;
  Walk t;
  t.tpr = min(kThreads, (nx + 31) & ~31);
  t.rps = kThreads / t.tpr;
  t.ty = threadIdx.x / t.tpr;
  t.tx = threadIdx.x - t.ty * t.tpr;

  // start: the band = the initial stack, its first peak and max|res[0]|
  float best = -1.f, bv = 0.f, amax = 0.f;
  int bi = INT_MAX;
  const Peak none{};
  for (int s = 0; s < ns; ++s)
    sweep<true, kWin, kSens>(t, s, b0, nb, ny, nx, px, in + s * npx, band + s * bplane,
                             cband, nullptr, nullptr, kWin ? win + s * npx : nullptr,
                             sens, cd[s], none, best, bi, bv, amax);
  int unused = 0;
  ska_block_argmax<kThreads>(amax, unused, s_v, s_i);
  band_partial(best, bi, bv, amax, part0 + kPart * c, s_v, s_i, s_kept);
  ska_lane_barrier(bar, a.ctas);

  int bidx;
  float val;
  lane_peak(part0, a.ctas, true, bidx, val, amax, s_v, s_i, &s_val);
  const float absthresh = fmaxf(a.thresh, __fmul_rn(a.fracthresh, amax));
  const float stop = __fmul_rn(0.9f, absthresh);
  const int plane = ny * nx;

  // every CTA of the lane takes the same decisions from the same peak, so
  // they leave the loop together
  for (int it = 0; it < a.niter; ++it) {
    if (bidx == INT_MAX || fabsf(val) < stop) break;
    const int ms = bidx / plane;
    const int rem = bidx - ms * plane;
    const int my = rem / nx;
    const int mx = rem - my * nx;
    Peak pk;
    pk.gm = __fmul_rn(a.gain, __fdiv_rn(val, cd[ms]));
    // footprint of the PSF centred on the peak, clipped to the image
    pk.y0 = max(0, my - cy);
    pk.y1 = min(ny, my - cy + py);
    pk.x0 = max(0, mx - cx);
    pk.x1 = min(nx, mx - cx + px);
    pk.poff = (cy - my) * px + (cx - mx);
    if (leader) {
      float* row = rows + kRow * (size_t)it;
      row[0] = (float)my;
      row[1] = (float)mx;
      row[2] = (float)ms;
      row[3] = pk.gm;
      row[4] = 1.f;
    }
    float* next = part0 + ((it + 1) & 1) * stride;
    if (b0 < pk.y1 && pk.y0 < b0 + nb) {
      best = -1.f;
      bi = INT_MAX;
      const float* bl = blobs + ms * ppx;
      for (int s = 0; s < ns; ++s)
        sweep<false, kWin, kSens>(t, s, b0, nb, ny, nx, px, nullptr, band + s * bplane,
                                  cband, psf + ((size_t)s * ns + ms) * ppx, bl,
                                  kWin ? win + s * npx : nullptr, sens, cd[s], pk,
                                  best, bi, bv, amax);
      band_partial(best, bi, bv, 0.f, next + kPart * c, s_v, s_i, s_kept);
    } else if (threadIdx.x == 0) {  // the band did not change
      *reinterpret_cast<float4*>(next + kPart * c) =
          *reinterpret_cast<const float4*>(s_kept);
    }
    if (it + 1 == a.niter) break;
    ska_lane_barrier(bar, (it + 2) * a.ctas);
    lane_peak(next, a.ctas, false, bidx, val, amax, s_v, s_i, &s_val);
  }

  if (kShared) {  // the band goes to device memory once
    __syncthreads();
    const int n = nb * nx;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      for (int s = 0; s < ns; ++s) res[s * npx + (size_t)b0 * nx + i] = band[s * bplane + i];
      comps[(size_t)b0 * nx + i] = cband[i];
    }
  }
}

using LoopFn = void (*)(const Args);

// the instance for (band in shared memory, window, sensitivity)
LoopFn loop_fn(bool shared, bool win, bool sens) {
  static const LoopFn fns[8] = {
      msclean_loop<false, false, false>, msclean_loop<false, false, true>,
      msclean_loop<false, true, false>,  msclean_loop<false, true, true>,
      msclean_loop<true, false, false>,  msclean_loop<true, false, true>,
      msclean_loop<true, true, false>,   msclean_loop<true, true, true>,
  };
  return fns[4 * shared + 2 * win + sens];
}

}  // namespace

// CTAs of the K7 kernel for a window (variant bit 0) and a sensitivity
// image (bit 1) that can be resident at once with `smem` bytes of dynamic
// shared memory each (smem 0: the instance whose band stays in device
// memory); 0 when the card refuses that much shared memory for one CTA,
// minus the CUDA error on failure.
SKA_EXPORT int ska_msclean_resident(int variant, int smem) {
  return ska_coop_resident((const void*)loop_fn(smem > 0, variant & 1, variant & 2),
                           kThreads, smem);
}

// in [nlanes, ns, ny, nx]; psf_ss [nlanes, ns, ns, py, px]; cd [nlanes,
// ns]; win [nlanes, ns, ny, nx] or null; sens [nlanes, ny, nx] or null;
// blobs [nlanes, ns, py, px]; res as in, comps [nlanes, ny, nx] and rows
// [nlanes, niter, 5] out; scratch of 8 * per_launch * ctas + per_launch
// 32-bit words. Lanes go in launches of per_launch, each lane on `ctas`
// CTAs of `band` rows with `smem` bytes of dynamic shared memory each
// ((ns + 1) * band * nx * 4, or 0 to keep the bands in device memory).
SKA_EXPORT int ska_msclean(const void* in, const void* psf_ss, const void* cd,
                           const void* win, const void* sens, const void* blobs,
                           void* res, void* comps, void* rows, void* scratch,
                           int nlanes, int per_launch, int ctas, int band,
                           int smem, int ns, int ny, int nx, int py, int px,
                           int niter, float gain, float thresh,
                           float fracthresh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nlanes <= 0 || niter <= 0) return 0;
  if (per_launch <= 0 || ctas <= 0 || band <= 0 || ns <= 0) return (int)cudaErrorInvalidValue;
  if (smem > 0 && (size_t)smem < sizeof(float) * (ns + 1) * (size_t)band * nx)
    return (int)cudaErrorInvalidValue;
  const LoopFn fn = loop_fn(smem > 0, win != nullptr, sens != nullptr);
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  const size_t npx = (size_t)ny * nx, ppx = (size_t)py * px;
  Args a{};
  a.ctas = ctas;
  a.band = band;
  a.ns = ns;
  a.ny = ny;
  a.nx = nx;
  a.py = py;
  a.px = px;
  a.niter = niter;
  a.gain = gain;
  a.thresh = thresh;
  a.fracthresh = fracthresh;
  a.part = (float*)scratch;
  a.bar = (int*)scratch + 2 * kPart * (size_t)per_launch * ctas;
  cudaMemsetAsync(rows, 0, sizeof(float) * kRow * (size_t)nlanes * niter, st);
  for (int l0 = 0; l0 < nlanes; l0 += per_launch) {
    a.nlanes = min(per_launch, nlanes - l0);
    a.in = (const float*)in + l0 * ns * npx;
    a.psf_ss = (const float*)psf_ss + l0 * ns * ns * ppx;
    a.cd = (const float*)cd + l0 * ns;
    a.win = win ? (const float*)win + l0 * ns * npx : nullptr;
    a.sens = sens ? (const float*)sens + l0 * npx : nullptr;
    a.blobs = (const float*)blobs + l0 * ns * ppx;
    a.res = (float*)res + l0 * ns * npx;
    a.comps = (float*)comps + l0 * npx;
    a.rows = (float*)rows + (size_t)l0 * niter * kRow;
    cudaMemsetAsync(a.bar, 0, sizeof(int) * (size_t)a.nlanes, st);
    void* args[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)fn, dim3(a.nlanes * ctas), dim3(kThreads), args, (size_t)smem, st);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  return ska_last_error();
}
