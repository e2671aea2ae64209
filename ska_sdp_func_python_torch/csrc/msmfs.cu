// K8: the MSMFS (multi-scale multi-frequency CLEAN) minor-cycle loop in one
// cooperative launch, each CTA's band of the scale-moment residual and of
// the moment model held on chip.
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
//     planes per (ms, t)); moment n of the model adds
//     gm[n] * pscalestack[ms] over the same footprint; emit the row
//     (y, x, scale, used, gm[0..nm-1]).
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), in the order of the plain version
// (msmfs_rows_plain, and msmfs_rows_to_model of its rows, which adds in
// emission order), so the two agree bit for bit.
//
// What bounds it on the card: the config-4 cube's stack is 4 scales x 3
// moments x 256^2 f32 = 3.1 MB; each iteration rebuilds the criterion over
// all of it and read-modify-writes every plane over the footprint, and
// each depends on the one before. The design is K7's (msclean.cu): one
// persistent kernel, launched cooperatively, the lanes sharing the
// resident CTAs (cleaners.clean_split), each CTA over a band of `band`
// image rows in every (scale, moment) plane:
//   * the band ([ns, nm, band, nx] of the residual and [nm, band, nx] of the
//     model) lives in dynamic shared memory for the whole loop and goes to
//     device memory once at the end: (ns + 1) * nm * band * nx * 4 bytes,
//     up to the card's opt-in limit per CTA (227 KB on the H100, less the
//     static shared memory), with the lanes' CTAs fitting the resident
//     count at that size (about 30 MB over the card); beyond that the band
//     stays in device memory, in the output arrays, and runs the same loop
//     (the template parameter kShared, picked by the wrapper from the
//     sizes);
//   * per iteration each CTA subtracts the pick's footprint from its band
//     (reading canvas[ms] over the footprint from device memory) and
//     rebuilds the criterion there, scale by scale, the loads of a pixel's
//     moments and canvas planes issued before any is used, and writes a
//     partial into a buffer chosen by the iteration's parity: the windowed
//     |criterion| and its first flat index, and for each scale the
//     unwindowed |sol0|, its first pixel index and the nm residual moments
//     there; on the start pass also max|smres[0, 0]|. A CTA whose band
//     misses the footprint did not change and copies the partial it wrote
//     before;
//   * after one barrier of the lane's CTAs every CTA reduces the lane's
//     partials itself: the scale from the criterion partials, then the
//     pixel and its moments from that scale's |sol0| partials, first index
//     on ties in both (the reference's two-level choice); so every CTA
//     knows mval and the stop decision without a second barrier, all CTAs
//     of a lane stop together and nothing runs after the stop.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 2;  // pixels whose loads a thread issues together
constexpr int kHead = 4;   // partial head: |crit|, its index, max|smres[0,0]|, pad

struct Args {
  const float* in;      // [nlanes, ns, nm, ny, nx] initial residuals
  const float* canvas;  // [ns, ns, 2nm-1, py, px]
  const float* hsmm;    // [ns, nm, nm]
  const float* ihsmm;   // [ns, nm, nm]
  const float* win;     // [nlanes, ns, ny, nx] or null
  const float* blobs;   // [ns, py, px] the scale blobs (pscalestack)
  float* res;           // [nlanes, ns, nm, ny, nx] out
  float* model;         // [nlanes, nm, ny, nx] out
  float* rows;          // [nlanes, niter, 4 + nm] out
  float* part;          // [2][nlanes * ctas][kHead + ns * (2 + nm)]
  int* bar;             // [nlanes], zeroed: arrivals at the lane's barriers
  int nlanes, ctas, band, ns, ny, nx, py, px, niter;
  float gain, thresh, fracthresh;
};

struct Walk {
  int tpr, rps, ty, tx;
};

template <int NM>
struct Peak {
  int y0, y1, x0, x1, poff;
  float gm[NM];
};

// sum_m ih_s[m, n] * v[m] in m order, each operation rounded
template <int NM>
__device__ __forceinline__ float moment_solution(const float* __restrict__ ih_s,
                                                 const float (&v)[NM], int n) {
  float acc = __fmul_rn(__ldg(ih_s + n), v[0]);
#pragma unroll
  for (int m = 1; m < NM; ++m) acc = __fadd_rn(acc, __fmul_rn(__ldg(ih_s + m * NM + n), v[m]));
  return acc;
}

// One pass over scale ts of the band of nb rows from image row b0: the
// moment planes of the band `bs` (row b0 at bs[0], planes bplane apart),
// the model band `mb` (touched for ts 0). At the start (kStart) the band
// becomes the input `is` (planes npx apart, from row 0) and amax gathers
// max|smres[0, 0]|; otherwise the pick's footprint is subtracted with the
// canvas planes `cv` (canvas[ms, ts], ppx apart) and, for ts 0, the blob
// `bl` times gm added to the model. Each thread keeps its best windowed
// |criterion| (flat index over the stack) and, for this scale, its best
// |sol0| (pixel index) with the residual moments there.
template <int NM, bool kCasa, bool kStart>
__device__ __forceinline__ void sweep(const Walk& t, int ts, int b0, int nb,
                                      int nx, int px, size_t npx,
                                      size_t bplane, size_t ppx,
                                      const float* is, float* bs, float* mb,
                                      const float* cv, const float* bl,
                                      const float* ws, const float* ih,
                                      const float* h, const Peak<NM>& pk,
                                      float& cbest, int& cidx, float& sbest,
                                      int& sidx, float (&sv)[NM],
                                      float& amax) {
  constexpr int NC = 2 * NM - 1;
  const int qs = (int)(ts * npx);
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
    float v[kBatch][NM], c[kBatch][NC], mv[kBatch][NM], b[kBatch], w[kBatch];
    bool hit[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      hit[u] = false;
      if (iy[u] >= nb) continue;
      const int y = b0 + iy[u];
      const int o = iy[u] * nx + ix[u];
      const int g = y * nx + ix[u];
#pragma unroll
      for (int m = 0; m < NM; ++m) v[u][m] = kStart ? is[m * npx + g] : bs[m * bplane + o];
      if (!kStart) {
        hit[u] = y >= pk.y0 && y < pk.y1 && ix[u] >= pk.x0 && ix[u] < pk.x1;
        if (hit[u]) {
          const int pq = y * px + ix[u] + pk.poff;
#pragma unroll
          for (int j = 0; j < NC; ++j) c[u][j] = cv[j * ppx + pq];
          if (ts == 0) {
            b[u] = bl[pq];
#pragma unroll
            for (int n = 0; n < NM; ++n) mv[u][n] = mb[n * bplane + o];
          }
        }
      }
      if (ws) w[u] = ws[g];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (iy[u] >= nb) continue;
      const int o = iy[u] * nx + ix[u];
      const int g = (b0 + iy[u]) * nx + ix[u];
      if (kStart) {
#pragma unroll
        for (int m = 0; m < NM; ++m) bs[m * bplane + o] = v[u][m];
        if (ts == 0) {
          amax = fmaxf(amax, fabsf(v[u][0]));
#pragma unroll
          for (int n = 0; n < NM; ++n) mb[n * bplane + o] = 0.f;
        }
      } else if (hit[u]) {
#pragma unroll
        for (int qp = 0; qp < NM; ++qp) {
          float acc = __fmul_rn(c[u][qp], pk.gm[0]);
#pragma unroll
          for (int q = 1; q < NM; ++q) acc = __fadd_rn(acc, __fmul_rn(c[u][qp + q], pk.gm[q]));
          v[u][qp] = __fsub_rn(v[u][qp], acc);
          bs[qp * bplane + o] = v[u][qp];
        }
        if (ts == 0) {
#pragma unroll
          for (int n = 0; n < NM; ++n)
            mb[n * bplane + o] = __fadd_rn(mv[u][n], __fmul_rn(pk.gm[n], b[u]));
        }
      }
      const float sol0 = moment_solution<NM>(ih, v[u], 0);
      float crit = sol0;
      if (kCasa) {
        float sol[NM];
        sol[0] = sol0;
#pragma unroll
        for (int n = 1; n < NM; ++n) sol[n] = moment_solution<NM>(ih, v[u], n);
        float a = __fmul_rn(sol[0], v[u][0]);
#pragma unroll
        for (int m = 1; m < NM; ++m) a = __fadd_rn(a, __fmul_rn(sol[m], v[u][m]));
        float bb = 0.f;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
#pragma unroll
          for (int n = 0; n < NM; ++n) {
            const float term = __fmul_rn(__fmul_rn(__ldg(h + m * NM + n), sol[m]), sol[n]);
            bb = (m == 0 && n == 0) ? term : __fadd_rn(bb, term);
          }
        }
        crit = __fsub_rn(__fmul_rn(2.f, a), bb);
      }
      if (ws) crit = __fmul_rn(crit, w[u]);
      // a thread's pixels come in increasing index: only a strictly larger
      // key replaces its best
      const float ck = fabsf(crit);
      if (ck > cbest) {
        cbest = ck;
        cidx = qs + g;
      }
      const float sk = fabsf(sol0);
      if (sk > sbest) {
        sbest = sk;
        sidx = g;
#pragma unroll
        for (int m = 0; m < NM; ++m) sv[m] = v[u][m];
      }
    }
  }
}

// The CTA's |sol0| partial of one scale at `out`: (value, first pixel
// index, the nm residual moments there), the moments from the winning
// thread.
template <int NM>
__device__ void scale_partial(float sbest, int sidx, const float (&sv)[NM],
                              float* out, float* s_v, int* s_i) {
  float v = sbest;
  int i = sidx;
  ska_block_argmax<kThreads>(v, i, s_v, s_i);
  if (i != INT_MAX && sidx == i) {
#pragma unroll
    for (int m = 0; m < NM; ++m) out[2 + m] = sv[m];
  }
  if (threadIdx.x == 0) {
    out[0] = v;
    out[1] = __int_as_float(i);
  }
}

// The CTA's criterion partial at `out` (value, first flat index, amax).
__device__ void crit_partial(float cbest, int cidx, float amax, float* out,
                             float* s_v, int* s_i) {
  ska_block_argmax<kThreads>(cbest, cidx, s_v, s_i);
  if (threadIdx.x == 0) {
    out[0] = cbest;
    out[1] = __int_as_float(cidx);
    out[2] = amax;
  }
}

// The lane's pick from its `ctas` partials of P floats at `part`: the
// scale ms of the first argmax of the criterion partials (cidx INT_MAX if
// none), then the first argmax of that scale's |sol0| partials, its pixel
// index sidx (INT_MAX if none) and the residual moments v there; with
// `start` also the maximum of the partials' amax. Every thread gets them.
template <int NM>
__device__ void lane_peak(const float* part, int ctas, int P, int plane,
                          bool start, int& cidx, int& ms, int& sidx,
                          float (&v)[NM], float& amax, float* s_v, int* s_i,
                          float* s_val) {
  float kv = -1.f, am = 0.f;
  int ki = INT_MAX;
  for (int q = threadIdx.x; q < ctas; q += kThreads) {
    const float* e = part + (size_t)P * q;
    const float k = __ldcg(e);
    const int i = __float_as_int(__ldcg(e + 1));
    if (k > kv || (k == kv && i < ki)) {
      kv = k;
      ki = i;
    }
    if (start) am = fmaxf(am, __ldcg(e + 2));
  }
  ska_block_argmax<kThreads>(kv, ki, s_v, s_i);
  cidx = ki;
  if (start) {
    int unused = 0;
    ska_block_argmax<kThreads>(am, unused, s_v, s_i);
    amax = am;
  }
  ms = 0;
  sidx = INT_MAX;
  if (cidx == INT_MAX) return;  // uniform across the CTA
  ms = cidx / plane;
  const int off = kHead + ms * (2 + NM);
  kv = -1.f;
  int si = INT_MAX, qb = 0;
  for (int q = threadIdx.x; q < ctas; q += kThreads) {
    const float* e = part + (size_t)P * q + off;
    const float k = __ldcg(e);
    const int i = __float_as_int(__ldcg(e + 1));
    if (k > kv || (k == kv && i < si)) {
      kv = k;
      si = i;
      qb = q;
    }
  }
  int sb = si;
  ska_block_argmax<kThreads>(kv, sb, s_v, s_i);
  if (sb != INT_MAX && si == sb) {  // pixel indices are unique across bands
#pragma unroll
    for (int m = 0; m < NM; ++m) s_val[m] = __ldcg(part + (size_t)P * qb + off + 2 + m);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NM; ++m) v[m] = sb == INT_MAX ? 0.f : s_val[m];
  sidx = sb;
}

template <int NM, bool kShared, bool kCasa>
__global__ void __launch_bounds__(kThreads, 2) msmfs_loop(const Args a) {
  constexpr int NC = 2 * NM - 1;
  constexpr int kRow = 4 + NM;
  extern __shared__ __align__(16) float s_band[];
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  __shared__ float s_val[NM];
  const int lane = blockIdx.x / a.ctas;
  const int c = blockIdx.x - lane * a.ctas;
  const int ns = a.ns, ny = a.ny, nx = a.nx, py = a.py, px = a.px;
  const int P = kHead + ns * (2 + NM);
  const size_t npx = (size_t)ny * nx, ppx = (size_t)py * px;
  const float* in = a.in + lane * ns * NM * npx;
  const float* win = a.win ? a.win + lane * ns * npx : nullptr;
  float* res = a.res + lane * ns * NM * npx;
  float* model = a.model + lane * NM * npx;
  float* rows = a.rows + (size_t)lane * a.niter * kRow;
  int* bar = a.bar + lane;
  // the lane's partials in the buffer of parity 0; parity 1 is `stride` on
  const size_t stride = (size_t)a.nlanes * a.ctas * P;
  float* part0 = a.part + (size_t)lane * a.ctas * P;
  const int b0 = c * a.band, nb = min(ny, b0 + a.band) - b0;
  // the band: plane (t, m) at band + (t * NM + m) * bplane, the model's
  // moment n at mband + n * bplane
  const size_t bplane = kShared ? (size_t)a.band * nx : npx;
  float* band = kShared ? s_band : res + (size_t)b0 * nx;
  float* mband = kShared ? s_band + ns * NM * bplane : model + (size_t)b0 * nx;
  const int cy = py / 2, cx = px / 2;
  const bool leader = c == 0 && threadIdx.x == 0;
  Walk t;
  t.tpr = min(kThreads, (nx + 31) & ~31);
  t.rps = kThreads / t.tpr;
  t.ty = threadIdx.x / t.tpr;
  t.tx = threadIdx.x - t.ty * t.tpr;

  // start: the band = the initial stack, its partials and max|smres[0, 0]|
  float cbest = -1.f, amax = 0.f;
  int cidx = INT_MAX;
  {
    const Peak<NM> none{};
    float* mine = part0 + (size_t)P * c;
    for (int ts = 0; ts < ns; ++ts) {
      float sbest = -1.f, sv[NM] = {};
      int sidx = INT_MAX;
      sweep<NM, kCasa, true>(t, ts, b0, nb, nx, px, npx, bplane, ppx, in + ts * NM * npx,
                             band + ts * NM * bplane, mband, nullptr, nullptr,
                             win ? win + ts * npx : nullptr, a.ihsmm + ts * NM * NM,
                             a.hsmm + ts * NM * NM, none, cbest, cidx, sbest, sidx, sv,
                             amax);
      scale_partial<NM>(sbest, sidx, sv, mine + kHead + ts * (2 + NM), s_v, s_i);
    }
    int unused = 0;
    ska_block_argmax<kThreads>(amax, unused, s_v, s_i);
    crit_partial(cbest, cidx, amax, mine, s_v, s_i);
  }
  ska_lane_barrier(bar, a.ctas);

  int ms, sidx;
  float v[NM];
  lane_peak<NM>(part0, a.ctas, P, (int)npx, true, cidx, ms, sidx, v, amax, s_v, s_i, s_val);
  const float absthresh = fmaxf(a.thresh, __fmul_rn(a.fracthresh, amax));

  // every CTA of the lane takes the same decisions from the same pick, so
  // they leave the loop together
  for (int it = 0; it < a.niter; ++it) {
    if (cidx == INT_MAX || sidx == INT_MAX) break;
    const float* ih_s = a.ihsmm + ms * NM * NM;
    float mval[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) mval[n] = moment_solution<NM>(ih_s, v, n);
    if (fabsf(mval[0]) < absthresh) break;
    const int my = sidx / nx;
    const int mx = sidx - my * nx;
    Peak<NM> pk;
#pragma unroll
    for (int n = 0; n < NM; ++n) pk.gm[n] = __fmul_rn(a.gain, mval[n]);
    // footprint of the PSF centred on the pixel, clipped to the image
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
      row[3] = 1.f;
#pragma unroll
      for (int n = 0; n < NM; ++n) row[4 + n] = pk.gm[n];
    }
    const float* cur = part0 + (it & 1) * stride + (size_t)P * c;
    float* next = part0 + ((it + 1) & 1) * stride + (size_t)P * c;
    if (b0 < pk.y1 && pk.y0 < b0 + nb) {
      cbest = -1.f;
      cidx = INT_MAX;
      for (int ts = 0; ts < ns; ++ts) {
        float sbest = -1.f, sv[NM] = {};
        int sidx_t = INT_MAX;
        sweep<NM, kCasa, false>(t, ts, b0, nb, nx, px, npx, bplane, ppx, nullptr,
                                band + ts * NM * bplane, mband,
                                a.canvas + ((size_t)ms * ns + ts) * NC * ppx,
                                a.blobs + ms * ppx, win ? win + ts * npx : nullptr,
                                a.ihsmm + ts * NM * NM, a.hsmm + ts * NM * NM, pk, cbest,
                                cidx, sbest, sidx_t, sv, amax);
        scale_partial<NM>(sbest, sidx_t, sv, next + kHead + ts * (2 + NM), s_v, s_i);
      }
      crit_partial(cbest, cidx, 0.f, next, s_v, s_i);
    } else {  // the band did not change: its partial stays
      for (int i = threadIdx.x; i < P; i += kThreads) next[i] = __ldcg(cur + i);
    }
    if (it + 1 == a.niter) break;
    ska_lane_barrier(bar, (it + 2) * a.ctas);
    lane_peak<NM>(part0 + ((it + 1) & 1) * stride, a.ctas, P, (int)npx, false, cidx, ms,
                  sidx, v, amax, s_v, s_i, s_val);
  }

  if (kShared) {  // the band goes to device memory once
    __syncthreads();
    const int n = nb * nx;
    const size_t o = (size_t)b0 * nx;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      for (int p = 0; p < ns * NM; ++p) res[p * npx + o + i] = band[p * bplane + i];
#pragma unroll
      for (int m = 0; m < NM; ++m) model[m * npx + o + i] = mband[m * bplane + i];
    }
  }
}

using LoopFn = void (*)(const Args);

template <int NM>
LoopFn loop_fn_nm(bool shared, bool casa) {
  static const LoopFn fns[4] = {msmfs_loop<NM, false, false>, msmfs_loop<NM, false, true>,
                                msmfs_loop<NM, true, false>, msmfs_loop<NM, true, true>};
  return fns[2 * shared + casa];
}

// the instance for nm moments (1..6; null otherwise), band in shared memory
// or not, CASA's criterion or not
LoopFn loop_fn(int nm, bool shared, bool casa) {
  switch (nm) {
    case 1: return loop_fn_nm<1>(shared, casa);
    case 2: return loop_fn_nm<2>(shared, casa);
    case 3: return loop_fn_nm<3>(shared, casa);
    case 4: return loop_fn_nm<4>(shared, casa);
    case 5: return loop_fn_nm<5>(shared, casa);
    case 6: return loop_fn_nm<6>(shared, casa);
    default: return nullptr;
  }
}

}  // namespace

// CTAs of the K8 kernel for nm moments and CASA's criterion (casa 1) that
// can be resident at once with `smem` bytes of dynamic shared memory each
// (smem 0: the instance whose band stays in device memory); 0 when the
// card refuses that much shared memory for one CTA, minus the CUDA error
// on failure.
SKA_EXPORT int ska_msmfs_resident(int nm, int casa, int smem) {
  const LoopFn fn = loop_fn(nm, smem > 0, casa != 0);
  if (!fn) return -(int)cudaErrorInvalidValue;
  return ska_coop_resident((const void*)fn, kThreads, smem);
}

// in [nlanes, ns, nm, ny, nx]; canvas [ns, ns, 2nm-1, py, px]; hsmm and
// ihsmm [ns, nm, nm]; win [nlanes, ns, ny, nx] or null; blobs [ns, py, px];
// res as in, model [nlanes, nm, ny, nx] and rows [nlanes, niter, 4 + nm]
// out; scratch of 2 * per_launch * ctas * (4 + ns * (2 + nm)) + per_launch
// 32-bit words. Lanes go in launches of per_launch, each lane on `ctas`
// CTAs of `band` rows with `smem` bytes of dynamic shared memory each
// ((ns + 1) * nm * band * nx * 4, or 0 to keep the bands in device memory).
SKA_EXPORT int ska_msmfs(const void* in, const void* canvas, const void* hsmm,
                         const void* ihsmm, const void* win, const void* blobs,
                         void* res, void* model, void* rows, void* scratch,
                         int nlanes, int per_launch, int ctas, int band,
                         int smem, int ns, int nm, int ny, int nx, int py,
                         int px, int niter, int casa, float gain,
                         float thresh, float fracthresh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nlanes <= 0 || niter <= 0) return 0;
  const LoopFn fn = loop_fn(nm, smem > 0, casa != 0);
  if (!fn || per_launch <= 0 || ctas <= 0 || band <= 0 || ns <= 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 0 && (size_t)smem < sizeof(float) * (ns + 1) * nm * (size_t)band * nx)
    return (int)cudaErrorInvalidValue;
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  const size_t npx = (size_t)ny * nx;
  const int P = kHead + ns * (2 + nm);
  Args a{};
  a.canvas = (const float*)canvas;
  a.hsmm = (const float*)hsmm;
  a.ihsmm = (const float*)ihsmm;
  a.blobs = (const float*)blobs;
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
  a.bar = (int*)scratch + 2 * (size_t)P * per_launch * ctas;
  cudaMemsetAsync(rows, 0, sizeof(float) * (4 + nm) * (size_t)nlanes * niter, st);
  for (int l0 = 0; l0 < nlanes; l0 += per_launch) {
    a.nlanes = min(per_launch, nlanes - l0);
    a.in = (const float*)in + l0 * ns * nm * npx;
    a.win = win ? (const float*)win + l0 * ns * npx : nullptr;
    a.res = (float*)res + l0 * ns * nm * npx;
    a.model = (float*)model + l0 * nm * npx;
    a.rows = (float*)rows + (size_t)l0 * niter * (4 + nm);
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
