"""CLEAN minor cycles: Hogbom (kernel K5), complex Hogbom (K6), multi-scale
CLEAN (K7, which also stands for K7v1) and multi-scale multi-frequency
CLEAN (MSMFS, K8).

Counterpart of ``hogbom``, ``hogbom_complex``, ``msclean``, ``msmfsclean``
and the scale-stack and moment-stack helpers in
``ska_sdp_func_python_tpu/ops/cleaners.py``. The semantics of the JAX
package's XLA loops are kept exactly:

* Hogbom: the peak of |residual * window| with ties to the first index;
  mval = val * gain / pmax; the PSF subtracted over its footprint around
  the peak, clipped at the image edges; stop once
  |val - mval * psf_centre| < 0.9 * absthresh with
  absthresh = max(thresh, fracthresh * max|dirty|).
* Complex Hogbom of Q + iU: the search is |Q + iU| (times the window),
  mval = val * gain / pmax with pmax the peak of the Q PSF, and the loop
  stops when |res_new[peak]| < absthresh, with no 0.9 factor.
* msclean: the search is |res_s / cd_s * windowstack * sensitivity^2| over
  the whole [scale, y, x] stack, first index in (scale, y, x) order; the
  loop stops BEFORE the subtraction once |res[peak]| < 0.9 * absthresh,
  with absthresh taken once from the initial stack's scale 0.
* MSMFS (Rau & Cornwell 2011, Algorithm 1): the criterion is the moment-0
  principal solution ``sum_m ih[s, m, 0] smres[s, m]`` (RASCIL) or the
  CASA ``dchisq``, times the window stack; its first argmax over (scale,
  y, x) gives the scale, and the unwindowed argmax of |moment-0 solution|
  of that scale gives the pixel; the loop stops BEFORE the subtraction
  once |mval[0]| < absthresh (no 0.9 factor), absthresh taken once from
  the initial scale-0, moment-0 residual.

Every loop leaves its components as rows. On CUDA each loop is one
cooperative launch of a hand-written kernel (``csrc/hogbom.cu``,
``csrc/msclean.cu``, ``csrc/msmfs.cu``); the Hogbom rows are scattered
into component images, and the msclean and MSMFS kernels build their
component image and moment model themselves, bit for bit as
:func:`msclean_rows_to_comps` and :func:`msmfs_rows_to_model` rebuild
them from the rows. On the CPU the plain version beside each kernel runs
and its rows rebuild the images.

Rounding: the JAX package's CPU loops (XLA) contract every residual
update ``res - patch * m`` into one fused multiply-subtract, at f32 as
well. The kernels use ``__fmaf_rn`` and the plain versions :func:`_fms`,
so both round as the JAX loop does and the kernels agree bit for bit with
their plain versions.
"""

from __future__ import annotations

import math
import typing

import torch

from .. import kernels
from ..config import not_ported, resolve_device
from .pswf import grdsf

__all__ = [
    "hogbom",
    "hogbom_lanes",
    "hogbom_rows_plain",
    "hogbom_split",
    "clean_split",
    "hogbom_complex",
    "hogbom_complex_lanes",
    "hogbom_complex_rows_plain",
    "msclean",
    "msclean_lanes",
    "msclean_rows_plain",
    "msclean_psf_stacks",
    "msclean_rows_to_comps",
    "msclean_with_stacks",
    "MSCleanStacks",
    "create_scalestack",
    "convolve_scalestack",
    "convolve_convolve_scalestack",
    "calculate_scale_moment_residual",
    "calculate_scale_scale_moment_moment_psf",
    "calculate_scale_inverse_moment_moment_hessian",
    "msmfs_rows_plain",
    "msmfs_lanes",
    "msmfs_rows_to_model",
    "msmfs_psf_stacks",
    "msmfs_with_stacks",
    "msmfsclean",
    "MSMFSStacks",
]


def _fms(c, a, b):
    """c - a * b in c's dtype. For f32, rounded once as a fused
    multiply-subtract rounds it: the rounding the JAX package's CPU loops
    get from XLA's contraction and the CUDA kernels from ``__fmaf_rn``.

    The f32 product is exact in f64, but rounding the f64 difference to
    nearest and then to f32 can round twice the wrong way at a tie. So the
    f64 difference is rounded to odd (its exact error from TwoSum moves an
    even result one f64 step toward the exact value), after which rounding
    to f32 is the correctly rounded result."""
    if c.dtype == torch.float64:
        return c - a * b
    x, y = c.double(), -(a.double() * b.double())
    s = x + y
    t = s - x
    err = (x - (s - t)) + (y - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(c.dtype)


def _footprint(my, mx, ny, nx, py, px):
    """Image and PSF slices of the PSF footprint centred on (my, mx),
    clipped at the image edges (the JAX package's padded-canvas slice)."""
    cy, cx = py // 2, px // 2
    y0, y1 = max(0, my - cy), min(ny, my - cy + py)
    x0, x1 = max(0, mx - cx), min(nx, mx - cx + px)
    img = (slice(y0, y1), slice(x0, x1))
    psf = (slice(y0 - my + cy, y1 - my + cy), slice(x0 - mx + cx, x1 - mx + cx))
    return img, psf


def _check_psf(dirty_shape, psf_shape):
    ny, nx = dirty_shape[-2:]
    py, px = psf_shape[-2:]
    if py > 2 * ny or px > 2 * nx:
        raise ValueError(f"psf: shape {tuple(psf_shape)} for {tuple(dirty_shape)}")


# ---------------------------------------------------------------- Hogbom


def hogbom_rows_plain(
    dirty,
    psf,
    window=None,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
):
    """Plain version of the K5 loop for one lane: returns ([niter, 4]
    rows (y, x, val, used), residual)."""
    ny, nx = dirty.shape
    py, px = psf.shape
    cy, cx = py // 2, px // 2
    res = dirty.clone()
    rows = torch.zeros((niter, 4), dtype=torch.float32, device=dirty.device)
    pmax = psf.max()
    psf_c = psf[cy, cx]
    absthresh = torch.clamp(fracthresh * dirty.abs().max(), min=thresh)
    stop = 0.9 * absthresh
    for i in range(niter):
        search = res.abs() if window is None else (res * window).abs()
        my, mx = divmod(int(torch.argmax(search)), nx)
        val = res[my, mx].clone()
        mval = val * gain / pmax
        img, pat = _footprint(my, mx, ny, nx, py, px)
        res[img] = _fms(res[img], psf[pat], mval)
        rows[i, 0], rows[i, 1], rows[i, 2], rows[i, 3] = my, mx, mval, 1.0
        if bool(_fms(val, mval, psf_c).abs() < stop):
            break
    return rows, res


def _rows_to_image(rows, ny, nx, col=2, used=3):
    """Scatter [lanes, niter, k] component rows (y, x, ...) into
    [lanes, ny, nx], taking the value in column ``col`` of each used
    row."""
    nl = rows.shape[0]
    lane = torch.arange(nl, device=rows.device)[:, None].expand(
        -1, rows.shape[1]
    )
    vals = torch.where(rows[..., used] > 0.0, rows[..., col], 0.0)
    comps = torch.zeros((nl, ny, nx), dtype=rows.dtype, device=rows.device)
    comps.index_put_(
        (lane, rows[..., 0].long(), rows[..., 1].long()),
        vals,
        accumulate=True,
    )
    return comps


def _lane_windows(window, nl, ny, nx):
    if window is None:
        return None
    return torch.broadcast_to(window, (nl, ny, nx))


def _f32(t):
    """A contiguous f32 copy of ``t`` for a kernel (None stays None)."""
    return None if t is None else t.to(torch.float32).contiguous()


def hogbom_split(nlanes: int, ny: int, resident: int) -> tuple[int, int, int]:
    """How the cooperative CLEAN kernels (K5, K6; K7 and K8 through
    :func:`clean_split`) spread ``nlanes`` lanes of ``ny`` rows over
    ``resident`` CTAs, the most that can be resident on the card at once:
    (lanes per launch, CTAs per lane, rows per CTA). The lanes of a launch share the resident CTAs, each
    lane on a band of whole rows per CTA; when the lanes outnumber the
    CTAs, they go in launches of ``resident`` lanes of one CTA each."""
    rows = max(ny, 1)
    per_launch = max(1, min(nlanes, resident))
    band = -(-rows // min(max(1, resident // per_launch), rows))
    return per_launch, -(-rows // band), band


def clean_split(
    nlanes: int, ny: int, row_bytes: int, resident
) -> tuple[int, int, int, int]:
    """How the msclean and MSMFS kernels (K7, K8) spread ``nlanes`` lanes
    of ``ny`` rows over the CTAs of their cooperative launch, each CTA
    holding its band of rows in shared memory: (lanes per launch, CTAs per
    lane, rows per CTA, dynamic shared memory per CTA in bytes).

    ``row_bytes`` is the shared memory one image row of a band takes (the
    row in every plane of the stack and of the component output);
    ``resident(smem)`` is the number of CTAs that can be resident with
    ``smem`` bytes each, 0 when the card refuses that much for one CTA
    (``smem`` 0: the kernel whose bands stay in device memory). The split
    is :func:`hogbom_split`'s, first over the CTAs resident without shared
    memory and then over those resident at its bands' size, until the
    lanes' CTAs fit. Where no band fits (a stack beyond the card's shared
    memory), the bands stay in device memory: shared memory 0."""
    first = split = hogbom_split(nlanes, ny, resident(0))
    while True:
        smem = split[2] * row_bytes
        n = resident(smem)
        if n <= 0:
            return (*first, 0)
        if split[0] * split[1] <= n:
            return (*split, smem)
        split = hogbom_split(nlanes, ny, n)


# resident CTAs of the cooperative kernels, by (query, its arguments,
# device index)
_RESIDENT: dict = {}


def _resident(symbol: str, dev, *args: int) -> int:
    """The card's answer to the resident query ``symbol(*args)``, cached;
    raises on a CUDA error."""
    key = (symbol, args, dev.index)
    if key not in _RESIDENT:
        with torch.cuda.device(dev):
            n = kernels.query(symbol, *args)
        if n < 0:
            msg = kernels.load_library().ska_error_string(-n).decode()
            raise RuntimeError(f"{symbol}: no cooperative launch on {dev}: {msg}")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def _hogbom_launch_geometry(kind: int, nl: int, ny: int, dev):
    """The split of :func:`hogbom_split` for the card of ``dev``, and the
    kernel's scratch: two parity buffers of 8-word partials per CTA and one
    barrier counter per lane."""
    n = _resident("ska_hogbom_resident", dev, kind)
    if n <= 0:
        raise RuntimeError(f"hogbom: no CTA can be resident on {dev}")
    split = hogbom_split(nl, ny, n)
    nwords = 16 * split[0] * split[1] + split[0]
    return split, torch.empty(nwords, dtype=torch.int32, device=dev)


def _clean_launch_geometry(symbol, variant, nl, ny, row_bytes, part_words, dev):
    """The split of :func:`clean_split` for the card of ``dev`` and the
    resident query ``symbol(*variant, smem)``, and the kernel's scratch:
    two parity buffers of ``part_words``-word partials per CTA and one
    barrier counter per lane."""
    split = clean_split(
        nl, ny, row_bytes, lambda smem: _resident(symbol, dev, *variant, smem)
    )
    if _resident(symbol, dev, *variant, split[3]) <= 0:
        raise RuntimeError(f"{symbol}: no CTA can be resident on {dev}")
    nwords = 2 * part_words * split[0] * split[1] + split[0]
    return split, torch.empty(nwords, dtype=torch.int32, device=dev)


def hogbom_lanes(
    dirty: torch.Tensor,
    psf: torch.Tensor,
    window: torch.Tensor | None = None,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
):
    """Hogbom on a batch of independent lanes: dirty ``[lanes, ny, nx]``,
    psf ``[lanes, py, px]`` (f32), optional search window broadcastable
    to dirty. Returns (components, residual), both ``[lanes, ny, nx]``."""
    nl, ny, nx = dirty.shape
    py, px = psf.shape[-2:]
    win = _lane_windows(window, nl, ny, nx)
    if dirty.device.type == "cpu":
        out = [
            hogbom_rows_plain(
                dirty[i], psf[i], None if win is None else win[i],
                gain=gain, thresh=thresh, niter=niter, fracthresh=fracthresh,
            )
            for i in range(nl)
        ]
        rows = torch.stack([o[0] for o in out])
        res = torch.stack([o[1] for o in out])
        return _rows_to_image(rows, ny, nx), res
    dev = dirty.device
    chk = kernels.check_cuda_tensor
    if psf.shape[0] != nl:
        raise ValueError(f"psf: shape {tuple(psf.shape)} for {tuple(dirty.shape)}")
    _check_psf(dirty.shape, psf.shape)
    res = torch.empty_like(dirty)
    rows = torch.empty((nl, niter, 4), dtype=torch.float32, device=dev)
    win = _f32(win)
    split, scratch = _hogbom_launch_geometry(0, nl, ny, dev)
    kernels.KERNELS["hogbom"].launch(
        chk("dirty", dirty, torch.float32, dev),
        chk("psf", psf, torch.float32, dev),
        None if win is None else chk("window", win, torch.float32, dev),
        res.data_ptr(),
        rows.data_ptr(),
        scratch.data_ptr(),
        nl,
        *split,
        ny,
        nx,
        py,
        px,
        int(niter),
        float(gain),
        float(thresh),
        float(fracthresh),
    )
    return _rows_to_image(rows, ny, nx), res


def hogbom(
    dirty: torch.Tensor,
    psf: torch.Tensor,
    window=None,
    gain: float = 0.1,
    thresh: float = 0.0,
    niter: int = 100,
    fracthresh: float = 0.01,
):
    """Hogbom CLEAN of one image, with an optional search window
    ``[ny, nx]`` (1 = allowed). Returns (components, residual)."""
    comps, res = hogbom_lanes(
        dirty[None].to(torch.float32).contiguous(),
        psf[None].to(torch.float32).contiguous(),
        None if window is None else window[None],
        gain=gain,
        thresh=thresh,
        niter=niter,
        fracthresh=fracthresh,
    )
    return comps[0], res[0]


# -------------------------------------------------------- complex Hogbom


def hogbom_complex_rows_plain(
    dirty_q,
    dirty_u,
    psf,
    window=None,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
):
    """Plain version of the K6 loop for one lane of Q + iU with a real
    PSF: returns ([niter, 5] rows (y, x, mq, mu, used), res_q, res_u).

    Held to the JAX package's XLA loop: the search is hypot(Q, U) and the
    loop stops when |res_new[peak]| < absthresh. (The TPU list kernel
    searches Q^2 + U^2 and can break near-ties otherwise.)"""
    ny, nx = dirty_q.shape
    py, px = psf.shape
    cy, cx = py // 2, px // 2
    rq, ru = dirty_q.clone(), dirty_u.clone()
    rows = torch.zeros((niter, 5), dtype=rq.dtype, device=rq.device)
    pmax = psf.max()
    psf_c = psf[cy, cx]
    absthresh = torch.clamp(
        fracthresh * torch.hypot(dirty_q, dirty_u).max(), min=thresh
    )
    for i in range(niter):
        if window is None:
            search = torch.hypot(rq, ru)
        else:
            search = torch.hypot(rq * window, ru * window)
        my, mx = divmod(int(torch.argmax(search)), nx)
        vq, vu = rq[my, mx].clone(), ru[my, mx].clone()
        mq = vq * gain / pmax
        mu = vu * gain / pmax
        img, pat = _footprint(my, mx, ny, nx, py, px)
        rq[img] = _fms(rq[img], psf[pat], mq)
        ru[img] = _fms(ru[img], psf[pat], mu)
        rows[i, 0], rows[i, 1], rows[i, 2], rows[i, 3] = my, mx, mq, mu
        rows[i, 4] = 1.0
        if bool(torch.hypot(_fms(vq, mq, psf_c), _fms(vu, mu, psf_c)) < absthresh):
            break
    return rows, rq, ru


def hogbom_complex_lanes(
    dirty_q: torch.Tensor,
    dirty_u: torch.Tensor,
    psf: torch.Tensor,
    window: torch.Tensor | None = None,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
):
    """Complex Hogbom on a batch of lanes: Q and U ``[lanes, ny, nx]``,
    the real PSF ``[lanes, py, px]``, optional window broadcastable to Q.
    Returns (comps_q, comps_u, res_q, res_u), each ``[lanes, ny, nx]``."""
    nl, ny, nx = dirty_q.shape
    py, px = psf.shape[-2:]
    win = _lane_windows(window, nl, ny, nx)
    if dirty_q.device.type == "cpu":
        out = [
            hogbom_complex_rows_plain(
                dirty_q[i], dirty_u[i], psf[i], None if win is None else win[i],
                gain=gain, thresh=thresh, niter=niter, fracthresh=fracthresh,
            )
            for i in range(nl)
        ]
        rows = torch.stack([o[0] for o in out])
        rq = torch.stack([o[1] for o in out])
        ru = torch.stack([o[2] for o in out])
    else:
        dev = dirty_q.device
        chk = kernels.check_cuda_tensor
        if psf.shape[0] != nl or dirty_u.shape != dirty_q.shape:
            raise ValueError(
                f"shapes: q {tuple(dirty_q.shape)}, u {tuple(dirty_u.shape)}, "
                f"psf {tuple(psf.shape)}"
            )
        _check_psf(dirty_q.shape, psf.shape)
        rq = torch.empty_like(dirty_q)
        ru = torch.empty_like(dirty_u)
        rows = torch.empty((nl, niter, 5), dtype=torch.float32, device=dev)
        win = _f32(win)
        split, scratch = _hogbom_launch_geometry(1, nl, ny, dev)
        kernels.KERNELS["hogbom_complex"].launch(
            chk("dirty_q", dirty_q, torch.float32, dev),
            chk("dirty_u", dirty_u, torch.float32, dev),
            chk("psf", psf, torch.float32, dev),
            None if win is None else chk("window", win, torch.float32, dev),
            rq.data_ptr(),
            ru.data_ptr(),
            rows.data_ptr(),
            scratch.data_ptr(),
            nl,
            *split,
            ny,
            nx,
            py,
            px,
            int(niter),
            float(gain),
            float(thresh),
            float(fracthresh),
        )
    cq = _rows_to_image(rows, ny, nx, col=2, used=4)
    cu = _rows_to_image(rows, ny, nx, col=3, used=4)
    return cq, cu, rq, ru


def hogbom_complex(
    dirty_q,
    dirty_u,
    psf_q,
    psf_u,
    window=None,
    gain: float = 0.1,
    thresh: float = 0.0,
    niter: int = 100,
    fracthresh: float = 0.01,
):
    """Complex Hogbom CLEAN of Q + iU. Only ``psf_q`` is used (``psf_u`` is
    accepted and ignored, as in the JAX package). On the CPU the inputs
    keep their dtype; on CUDA the kernel runs in f32.

    Returns (comps_q, comps_u, res_q, res_u)."""
    if dirty_q.device.type != "cpu":
        dirty_q, dirty_u, psf_q = (
            t.to(torch.float32) for t in (dirty_q, dirty_u, psf_q)
        )
    cq, cu, rq, ru = hogbom_complex_lanes(
        dirty_q[None].contiguous(),
        dirty_u[None].contiguous(),
        psf_q[None].contiguous(),
        None if window is None else window[None],
        gain=gain,
        thresh=thresh,
        niter=niter,
        fracthresh=fracthresh,
    )
    return cq[0], cu[0], rq[0], ru[0]


# ------------------------------------------------------------ scale stacks


def create_scalestack(
    npixel_y: int,
    npixel_x: int,
    scales,
    norm: bool = True,
    dtype: torch.dtype = torch.float64,
    device=None,
):
    """Scale basis blobs ``[nscales, ny, nx]``: a truncated paraboloid
    tapered by the PSWF, centred at (ceil(ny/2), ceil(nx/2)); scale 0 is
    a delta. ``device`` None is the CUDA card."""
    device = resolve_device(device)
    ycen = int(math.ceil(float(npixel_y) / 2.0))
    xcen = int(math.ceil(float(npixel_x) / 2.0))
    iy = torch.arange(npixel_y, device=device)[:, None] - ycen
    ix = torch.arange(npixel_x, device=device)[None, :] - xcen
    stacks = []
    for scale in scales:
        if scale > 0:
            r = torch.sqrt((iy**2 + ix**2).to(dtype)) / (scale / 2.0)
            blob = grdsf(torch.clamp(r, max=1.0))[0] * (1.0 - r**2)
            blob = torch.where(r < 1.0, blob, 0.0)
            blob = torch.clamp(blob, min=0.0)
            if norm:
                blob = blob / blob.sum()
        else:
            blob = torch.zeros((npixel_y, npixel_x), dtype=dtype, device=device)
            blob[ycen, xcen] = 1.0
        stacks.append(blob)
    return torch.stack(stacks)


def _cfft(img):
    return torch.fft.fftshift(
        torch.fft.fft2(torch.fft.fftshift(img, dim=(-2, -1)), dim=(-2, -1)),
        dim=(-2, -1),
    )


def _cifft(img):
    return torch.fft.ifftshift(
        torch.fft.ifft2(torch.fft.ifftshift(img, dim=(-2, -1)), dim=(-2, -1)),
        dim=(-2, -1),
    )


def convolve_scalestack(scalestack, img):
    """FFT-convolve ``img`` with every scale: ``[ns, ny, nx]``."""
    ximg = _cfft(img)
    xscale = _cfft(scalestack)
    return _cifft(ximg[None] * xscale.conj()).real


def convolve_convolve_scalestack(scalestack, img):
    """Doubly scale-convolved image ``[ns, ns, ny, nx]``: entry [i, j] is
    img convolved with scale j and correlated with scale i."""
    ximg = _cfft(img)
    xscale = _cfft(scalestack)
    xmult = ximg[None, None] * xscale[None, :] * xscale[:, None].conj()
    return _cifft(xmult).real


# ---------------------------------------------------------------- msclean


def msclean_rows_plain(
    res_stack,
    psf_ss,
    coupling_diag,
    windowstack=None,
    sensitivity=None,
    *,
    gain: float,
    thresh: float,
    fracthresh: float,
    niter: int,
):
    """Plain version of the K7 loop for one lane, in the dtype of its
    inputs: residual stack ``[ns, ny, nx]``, cross-scale PSF stack
    ``psf_ss [ns, ns, py, px]`` (entry [s', s]: the effect on scale s' of
    a component of scale s), coupling diagonal ``[ns]``. Returns
    ([niter, 5] rows (y, x, scale, gain * mval, used), residual stack)."""
    ns, ny, nx = res_stack.shape
    py, px = psf_ss.shape[-2:]
    res = res_stack.clone()
    rows = torch.zeros((niter, 5), dtype=res.dtype, device=res.device)
    cd = coupling_diag
    absthresh = torch.clamp(fracthresh * res_stack[0].abs().max(), min=thresh)
    stop = 0.9 * absthresh
    for i in range(niter):
        scaled = res / cd[:, None, None]
        if windowstack is not None:
            scaled = scaled * windowstack
        if sensitivity is not None:
            # searched with sensitivity squared, as in the JAX package
            scaled = scaled * sensitivity * sensitivity
        ms, rem = divmod(int(torch.argmax(scaled.abs())), ny * nx)
        my, mx = divmod(rem, nx)
        val = res[ms, my, mx]
        if bool(val.abs() < stop):
            break
        gm = gain * (val / cd[ms])
        img, pat = _footprint(my, mx, ny, nx, py, px)
        res[:, img[0], img[1]] = _fms(
            res[:, img[0], img[1]], psf_ss[:, ms, pat[0], pat[1]], gm
        )
        rows[i, 0], rows[i, 1], rows[i, 2], rows[i, 3] = my, mx, ms, gm
        rows[i, 4] = 1.0
    return rows, res


def msclean_rows_to_comps(rows, pscalestack, ny: int, nx: int):
    """The component image of one lane's msclean rows: each used row adds
    its scale's blob, centred on (y, x), clipped at the image edges and
    scaled by gain * mval, in emission order (the JAX package's loop
    order). Shared by the kernel and the plain version."""
    py, px = pscalestack.shape[-2:]
    comps = torch.zeros((ny, nx), dtype=pscalestack.dtype, device=rows.device)
    for y, x, s, gm, used in rows.cpu().tolist():
        if used <= 0.0:
            continue
        img, pat = _footprint(int(y), int(x), ny, nx, py, px)
        comps[img] += pscalestack[int(s)][pat] * gm
    return comps


def msclean_lanes(
    res_stack: torch.Tensor,
    psf_ss: torch.Tensor,
    coupling_diag: torch.Tensor,
    pscalestack: torch.Tensor,
    windowstack: torch.Tensor | None = None,
    sensitivity: torch.Tensor | None = None,
    *,
    gain: float,
    thresh: float,
    fracthresh: float,
    niter: int,
):
    """The msclean minor-cycle loop on a batch of lanes: residual stacks
    ``[lanes, ns, ny, nx]``, cross-scale PSF stacks ``[lanes, ns, ns, py,
    px]``, coupling diagonals ``[lanes, ns]``, scale blobs at PSF size
    ``[lanes, ns, py, px]``, optional window stacks ``[lanes, ns, ny, nx]``
    and sensitivity images ``[lanes, ny, nx]``. Returns (rows ``[lanes,
    niter, 5]``, residual stacks, component images ``[lanes, ny, nx]``).

    On CUDA all lanes are one call of kernel K7 (f32), counted as one
    launch; it emits the component images itself. On the CPU each lane
    runs the plain loop and its rows rebuild the image."""
    nl, ns, ny, nx = res_stack.shape
    py, px = psf_ss.shape[-2:]

    def lane(t, i):
        return None if t is None else t[i]

    if res_stack.device.type == "cpu":
        out = [
            msclean_rows_plain(
                res_stack[i], psf_ss[i], coupling_diag[i],
                lane(windowstack, i), lane(sensitivity, i),
                gain=gain, thresh=thresh, fracthresh=fracthresh, niter=niter,
            )
            for i in range(nl)
        ]
        comps = [
            msclean_rows_to_comps(o[0], pscalestack[i], ny, nx)
            for i, o in enumerate(out)
        ]
        return (
            torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]),
            torch.stack(comps),
        )
    dev = res_stack.device
    chk = kernels.check_cuda_tensor
    if (
        psf_ss.shape[:3] != (nl, ns, ns)
        or coupling_diag.shape != (nl, ns)
        or pscalestack.shape != (nl, ns, py, px)
    ):
        raise ValueError(
            f"shapes: res_stack {tuple(res_stack.shape)}, psf_ss "
            f"{tuple(psf_ss.shape)}, coupling_diag {tuple(coupling_diag.shape)}, "
            f"pscalestack {tuple(pscalestack.shape)}"
        )
    _check_psf(res_stack.shape, psf_ss.shape)
    if ns * ny * nx >= 2**31:
        raise ValueError(f"res_stack: {tuple(res_stack.shape)} exceeds int32 indexing")
    for name, t in (("windowstack", windowstack), ("sensitivity", sensitivity)):
        if t is not None:
            chk(name, t, torch.float32, dev)
    res = torch.empty_like(res_stack)
    comps = torch.empty((nl, ny, nx), dtype=torch.float32, device=dev)
    rows = torch.empty((nl, niter, 5), dtype=torch.float32, device=dev)
    # a band row: the row in every scale plane and in the component image
    variant = (int(windowstack is not None) + 2 * int(sensitivity is not None),)
    split, scratch = _clean_launch_geometry(
        "ska_msclean_resident", variant, nl, ny, 4 * (ns + 1) * nx, 4, dev
    )
    kernels.KERNELS["msclean"].launch(
        chk("res_stack", res_stack, torch.float32, dev),
        chk("psf_ss", psf_ss, torch.float32, dev),
        chk("coupling_diag", coupling_diag, torch.float32, dev),
        None if windowstack is None else windowstack.data_ptr(),
        None if sensitivity is None else sensitivity.data_ptr(),
        chk("pscalestack", pscalestack, torch.float32, dev),
        res.data_ptr(),
        comps.data_ptr(),
        rows.data_ptr(),
        scratch.data_ptr(),
        nl,
        *split,
        ns,
        ny,
        nx,
        py,
        px,
        int(niter),
        float(gain),
        float(thresh),
        float(fracthresh),
    )
    return rows, res, comps


class MSCleanStacks(typing.NamedTuple):
    """What msclean derives from the PSF alone: the PSF peak, the scale
    stacks at image and PSF size, the cross-scale PSF stack and its
    coupling diagonal. The fused cycle builds it once per ``ical``."""

    pmax: torch.Tensor
    scalestack: torch.Tensor
    pscalestack: torch.Tensor
    psf_ss: torch.Tensor
    coupling_diag: torch.Tensor


def msclean_psf_stacks(psf: torch.Tensor, ny: int, nx: int, scales) -> MSCleanStacks:
    """The PSF-only part of :func:`msclean` for a ``[ny, nx]`` image, in the
    dtype and on the device of ``psf``."""
    dt, dev = psf.dtype, psf.device
    pmax = psf.max()
    scalestack = create_scalestack(ny, nx, scales, dtype=dt, device=dev)
    pscalestack = create_scalestack(
        psf.shape[0], psf.shape[1], scales, dtype=dt, device=dev
    )
    psf_ss = convolve_convolve_scalestack(pscalestack, psf / pmax).to(dt)
    coupling_diag = torch.diagonal(psf_ss.amax(dim=(-2, -1))).contiguous()
    return MSCleanStacks(
        pmax, scalestack, pscalestack, psf_ss.contiguous(), coupling_diag
    )


def msclean_with_stacks(
    stacks: MSCleanStacks,
    dirty: torch.Tensor,
    window=None,
    sensitivity=None,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
):
    """msclean of ``dirty`` with the PSF's stacks already built. Returns
    (comps, residual)."""
    dt = stacks.psf_ss.dtype
    ldirty = dirty.to(dt) / stacks.pmax
    res_stack = convolve_scalestack(stacks.scalestack, ldirty).to(dt)
    windowstack = None
    if window is not None:
        windowstack = (
            convolve_scalestack(stacks.scalestack, window.to(dt)) > 0.9
        ).to(dt)[None].contiguous()
    sens = None if sensitivity is None else sensitivity.to(dt)[None].contiguous()
    _, res, comps = msclean_lanes(
        res_stack[None].contiguous(),
        stacks.psf_ss[None],
        stacks.coupling_diag[None],
        stacks.pscalestack[None],
        windowstack,
        sens,
        gain=gain,
        thresh=thresh,
        fracthresh=fracthresh,
        niter=niter,
    )
    return comps[0], stacks.pmax * res[0, 0]


def msclean(
    dirty,
    psf,
    window=None,
    sensitivity=None,
    gain: float = 0.1,
    thresh: float = 0.0,
    niter: int = 100,
    scales=(0, 3, 10, 30),
    fracthresh: float = 0.01,
    use_pallas=None,
):
    """Multi-scale CLEAN (Cornwell 2008) of one image, with an optional
    search window and sensitivity image ``[ny, nx]``.

    The minor-cycle loop follows the JAX package's XLA loop
    (``_msclean_loop``), which it runs for every case its TPU shape gate
    refuses. ``use_pallas`` is accepted and ignored: the TPU kernels K7
    (``_msclean_corner_kernel``) and K7v1 (``_msclean_pallas_kernel``)
    compute the same loop, and both map to the one CUDA kernel here. On
    the CPU the inputs keep their dtype; on CUDA the kernel runs in f32.

    Returns (comps, residual)."""
    if dirty.device.type != "cpu":
        dirty, psf = dirty.to(torch.float32), psf.to(torch.float32)
        if sensitivity is not None:
            sensitivity = sensitivity.to(torch.float32)
    stacks = msclean_psf_stacks(psf, dirty.shape[0], dirty.shape[1], scales)
    return msclean_with_stacks(
        stacks,
        dirty,
        window,
        sensitivity,
        gain=gain,
        thresh=thresh,
        niter=niter,
        fracthresh=fracthresh,
    )


# ------------------------------------------------------------------ MSMFS


def calculate_scale_moment_residual(residual, scalestack):
    """``[nscales, nmoment, ny, nx]``: every moment plane of ``residual``
    ``[nmoment, ny, nx]`` convolved with every scale."""
    return torch.stack(
        [convolve_scalestack(scalestack, r) for r in residual], dim=1
    )


def _moment_canvas(psf, scalestack):
    """The compact scale-scale moment-moment PSF ``[ns, ns, 2nm-1, py,
    px]``: the moment-moment PSF of moments (t, q) is ``psf[t + q]``, so
    it has 2nm-1 distinct planes, nm = max(len(psf) // 2, 1)."""
    nm = max(psf.shape[0] // 2, 1)
    return torch.stack(
        [convolve_convolve_scalestack(scalestack, psf[j]) for j in range(2 * nm - 1)],
        dim=2,
    )


def _canvas_to_ssmm(canvas):
    nm = (canvas.shape[2] + 1) // 2
    j = torch.arange(nm, device=canvas.device)
    return canvas[:, :, j[:, None] + j[None, :]]


def calculate_scale_scale_moment_moment_psf(psf, scalestack):
    """``[ns, ns, nm, nm, py, px]``: entry [s, s', t, q] is the PSF of
    moment t + q convolved with scale s' and correlated with scale s."""
    return _canvas_to_ssmm(_moment_canvas(psf, scalestack))


def _hessian_inverse(hess):
    """The ``[ns, nm, nm]`` inverse, taken in f64 on the host and cast
    back: over a wide band the moment Hessian is poorly conditioned, and
    f32 inverses on the card and the CPU would differ."""
    inv = torch.linalg.inv(hess.detach().cpu().double())
    return inv.to(device=hess.device, dtype=hess.dtype).contiguous()


def calculate_scale_inverse_moment_moment_hessian(ssmmpsf):
    """(Hessian ``[ns, nm, nm]`` at the PSF centre, its inverse)."""
    ns = ssmmpsf.shape[0]
    py, px = ssmmpsf.shape[-2:]
    s = torch.arange(ns, device=ssmmpsf.device)
    hess = ssmmpsf[s, s, :, :, py // 2, px // 2]
    return hess, _hessian_inverse(hess)


def _moment_solution(ih, res, n):
    """sum_m ih[..., m, n] * res[..., m, :, :], one rounding per operation
    in m order: ``ih`` is ``[ns, nm, nm]``, ``res`` ``[ns, nm, ...]``. The
    kernel computes the same sums in the same order."""
    nm = ih.shape[-1]
    tail = (None,) * (res.ndim - 2)
    acc = ih[(slice(None), 0, n) + tail] * res[:, 0]
    for m in range(1, nm):
        acc = acc + ih[(slice(None), m, n) + tail] * res[:, m]
    return acc


def _dchisq(h, sols, res):
    """CASA's criterion 2 sum_m sol_m res_m - sum_{m,n} h[m,n] sol_m sol_n,
    in the kernel's order of operations."""
    nm = len(sols)
    tail = (None,) * (res.ndim - 2)
    a = sols[0] * res[:, 0]
    for m in range(1, nm):
        a = a + sols[m] * res[:, m]
    b = None
    for m in range(nm):
        for n in range(nm):
            t = (h[(slice(None), m, n) + tail] * sols[m]) * sols[n]
            b = t if b is None else b + t
    return 2.0 * a - b


def msmfs_rows_plain(
    smres,
    canvas,
    hsmm,
    ihsmm,
    windowstack=None,
    *,
    gain: float,
    thresh: float,
    fracthresh: float,
    niter: int,
    findpeak: str = "RASCIL",
):
    """Plain version of the K8 loop for one lane, in the dtype of its
    inputs: scale-moment residual ``[ns, nm, ny, nx]``, compact moment
    canvas ``[ns, ns, 2nm-1, py, px]``, Hessian and inverse ``[ns, nm,
    nm]``, optional window stack ``[ns, ny, nx]``. Returns ([niter, 4 + nm]
    rows (y, x, scale, used, gain * mval[0..nm-1]), residual stack)."""
    ns, nm, ny, nx = smres.shape
    py, px = canvas.shape[-2:]
    res = smres.clone()
    rows = torch.zeros((niter, 4 + nm), dtype=res.dtype, device=res.device)
    absthresh = torch.clamp(fracthresh * smres[0, 0].abs().max(), min=thresh)
    for i in range(niter):
        sol0 = _moment_solution(ihsmm, res, 0)
        if findpeak == "CASA":
            sols = [sol0] + [_moment_solution(ihsmm, res, n) for n in range(1, nm)]
            crit = _dchisq(hsmm, sols, res)
        else:
            crit = sol0
        search = crit if windowstack is None else crit * windowstack
        ms = int(torch.argmax(search.abs())) // (ny * nx)
        my, mx = divmod(int(torch.argmax(sol0[ms].abs())), nx)
        pix = res[ms : ms + 1, :, my, mx]
        mval = torch.stack(
            [_moment_solution(ihsmm[ms : ms + 1], pix, n)[0] for n in range(nm)]
        )
        if bool(mval[0].abs() < absthresh):
            break
        gm = gain * mval
        img, pat = _footprint(my, mx, ny, nx, py, px)
        c = canvas[ms][:, :, pat[0], pat[1]]  # [ns, 2nm-1, h, w]
        for qp in range(nm):
            acc = c[:, qp] * gm[0]
            for q in range(1, nm):
                acc = acc + c[:, qp + q] * gm[q]
            res[:, qp, img[0], img[1]] = res[:, qp, img[0], img[1]] - acc
        rows[i, 0], rows[i, 1], rows[i, 2], rows[i, 3] = my, mx, ms, 1.0
        rows[i, 4:] = gm
    return rows, res


# the kernel keeps each pixel's moments in registers
_MSMFS_MAX_MOMENTS = 6


def msmfs_lanes(
    smres: torch.Tensor,
    canvas: torch.Tensor,
    hsmm: torch.Tensor,
    ihsmm: torch.Tensor,
    pscalestack: torch.Tensor,
    windowstack: torch.Tensor | None = None,
    *,
    gain: float,
    thresh: float,
    fracthresh: float,
    niter: int,
    findpeak: str = "RASCIL",
):
    """The MSMFS minor-cycle loop on a batch of lanes that share one PSF:
    scale-moment residuals ``[lanes, ns, nm, ny, nx]``, the compact canvas
    ``[ns, ns, 2nm-1, py, px]``, Hessian and inverse ``[ns, nm, nm]``, the
    scale blobs at PSF size ``[ns, py, px]``, optional window stacks
    ``[lanes, ns, ny, nx]``. Returns (rows ``[lanes, niter, 4 + nm]``,
    residual stacks, moment models ``[lanes, nm, ny, nx]``).

    On CUDA all lanes are one call of kernel K8 (f32), counted as one
    launch; it emits the moment models itself. On the CPU each lane runs
    the plain loop and its rows rebuild the model."""
    nl, ns, nm, ny, nx = smres.shape
    py, px = canvas.shape[-2:]
    if (
        canvas.shape[:3] != (ns, ns, 2 * nm - 1)
        or ihsmm.shape != (ns, nm, nm)
        or pscalestack.shape != (ns, py, px)
    ):
        raise ValueError(
            f"shapes: smres {tuple(smres.shape)}, canvas {tuple(canvas.shape)}, "
            f"ihsmm {tuple(ihsmm.shape)}, pscalestack {tuple(pscalestack.shape)}"
        )
    if smres.device.type == "cpu":
        out = [
            msmfs_rows_plain(
                smres[i], canvas, hsmm, ihsmm,
                None if windowstack is None else windowstack[i],
                gain=gain, thresh=thresh, fracthresh=fracthresh, niter=niter,
                findpeak=findpeak,
            )
            for i in range(nl)
        ]
        models = [msmfs_rows_to_model(o[0], pscalestack, ny, nx) for o in out]
        return (
            torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]),
            torch.stack(models),
        )
    dev = smres.device
    chk = kernels.check_cuda_tensor
    _check_psf(smres.shape, canvas.shape)
    if nm > _MSMFS_MAX_MOMENTS:
        raise ValueError(f"msmfs kernel: {nm} moments, at most {_MSMFS_MAX_MOMENTS}")
    if ns * nm * ny * nx >= 2**31:
        raise ValueError(f"smres: {tuple(smres.shape)} exceeds int32 indexing")
    if windowstack is not None:
        chk("windowstack", windowstack, torch.float32, dev)
    res = torch.empty_like(smres)
    model = torch.empty((nl, nm, ny, nx), dtype=torch.float32, device=dev)
    rows = torch.empty((nl, niter, 4 + nm), dtype=torch.float32, device=dev)
    casa = int(findpeak == "CASA")
    # a band row: the row in every (scale, moment) plane and in the model;
    # a partial: the criterion's head and (|sol0|, index, moments) a scale
    split, scratch = _clean_launch_geometry(
        "ska_msmfs_resident", (nm, casa), nl, ny, 4 * (ns + 1) * nm * nx,
        4 + ns * (2 + nm), dev,
    )
    kernels.KERNELS["msmfs"].launch(
        chk("smres", smres, torch.float32, dev),
        chk("canvas", canvas, torch.float32, dev),
        chk("hsmm", hsmm, torch.float32, dev),
        chk("ihsmm", ihsmm, torch.float32, dev),
        None if windowstack is None else windowstack.data_ptr(),
        chk("pscalestack", pscalestack, torch.float32, dev),
        res.data_ptr(),
        model.data_ptr(),
        rows.data_ptr(),
        scratch.data_ptr(),
        nl,
        *split,
        ns,
        nm,
        ny,
        nx,
        py,
        px,
        int(niter),
        casa,
        float(gain),
        float(thresh),
        float(fracthresh),
    )
    return rows, res, model


def msmfs_rows_to_model(rows, pscalestack, ny: int, nx: int):
    """The moment model ``[nm, ny, nx]`` of one lane's MSMFS rows, on the
    rows' device: each used row adds gain * mval[n] times its scale's
    blob, centred on (y, x) and clipped at the image edges, in emission
    order (the JAX package's scan over the rows). Only the count of used
    rows, which are a prefix, is read on the host."""
    nm = rows.shape[-1] - 4
    ns, py, px = pscalestack.shape
    dev, dt = rows.device, pscalestack.dtype
    big = torch.zeros((ns, 2 * ny, 2 * nx), dtype=dt, device=dev)
    oy, ox = ny - py // 2, nx - px // 2
    big[:, oy : oy + py, ox : ox + px] = pscalestack
    flat = big.reshape(-1)
    offs = (
        torch.arange(ny, device=dev)[:, None] * (2 * nx)
        + torch.arange(nx, device=dev)[None, :]
    )
    rows = rows.to(dt)
    model = torch.zeros((nm, ny, nx), dtype=dt, device=dev)
    for i in range(int((rows[:, 3] > 0).sum())):
        r = rows[i]
        y, x, s = r[0].long(), r[1].long(), r[2].long()
        patch = flat[s * (4 * ny * nx) + (ny - y) * (2 * nx) + (nx - x) + offs]
        model = model + (r[4:] * r[3])[:, None, None] * patch[None]
    return model


class MSMFSStacks(typing.NamedTuple):
    """What MSMFS derives from the moment PSFs alone: the PSF peak, the
    scale stacks at image and PSF size, the compact moment canvas and
    the moment Hessian with its inverse. The fused cycle builds it once
    per run."""

    pmax: torch.Tensor
    scalestack: torch.Tensor
    pscalestack: torch.Tensor
    canvas: torch.Tensor
    hsmm: torch.Tensor
    ihsmm: torch.Tensor


def msmfs_psf_stacks(psf: torch.Tensor, ny: int, nx: int, scales) -> MSMFSStacks:
    """The PSF-only part of :func:`msmfsclean` for ``[nm, ny, nx]`` moment
    images and moment PSFs ``psf [2 nm (or 1), py, px]``, in the dtype and
    on the device of ``psf``."""
    dt, dev = psf.dtype, psf.device
    pmax = psf.max()
    scalestack = create_scalestack(ny, nx, scales, dtype=dt, device=dev)
    pscalestack = create_scalestack(
        psf.shape[-2], psf.shape[-1], scales, dtype=dt, device=dev
    )
    canvas = _moment_canvas(psf / pmax, pscalestack).to(dt).contiguous()
    py, px = psf.shape[-2:]
    s = torch.arange(len(scales), device=dev)
    nm = (canvas.shape[2] + 1) // 2
    j = torch.arange(nm, device=dev)
    hess = canvas[s, s][:, j[:, None] + j[None, :], py // 2, px // 2].contiguous()
    return MSMFSStacks(
        pmax, scalestack, pscalestack, canvas, hess, _hessian_inverse(hess)
    )


def msmfs_with_stacks(
    stacks: MSMFSStacks,
    dirty: torch.Tensor,
    window=None,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
    findpeak: str = "RASCIL",
):
    """MSMFS of the moment images ``dirty [nm, ny, nx]`` with the PSF's
    stacks already built, with an optional ``[ny, nx]`` window. Returns
    (moment model, moment residual), both ``[nm, ny, nx]``."""
    nm = dirty.shape[0]
    if stacks.ihsmm.shape[-1] != nm:
        raise ValueError(
            f"{nm} moment images for a {stacks.ihsmm.shape[-1]}-moment PSF"
        )
    dt = stacks.canvas.dtype
    smres = calculate_scale_moment_residual(
        dirty.to(dt) / stacks.pmax, stacks.scalestack
    ).to(dt)
    windowstack = None
    if window is not None:
        windowstack = (
            convolve_scalestack(stacks.scalestack, window.to(dt)) > 0.9
        ).to(dt)[None].contiguous()
    _, res, model = msmfs_lanes(
        smres[None].contiguous(),
        stacks.canvas,
        stacks.hsmm,
        stacks.ihsmm,
        stacks.pscalestack,
        windowstack,
        gain=gain,
        thresh=thresh,
        fracthresh=fracthresh,
        niter=niter,
        findpeak=findpeak,
    )
    return model[0], stacks.pmax * res[0, 0]


def msmfsclean(
    dirty,
    psf,
    window=None,
    sensitivity=None,
    gain: float = 0.1,
    thresh: float = 0.0,
    niter: int = 100,
    scales=(0, 3, 10, 30),
    fracthresh: float = 0.01,
    findpeak: str = "RASCIL",
    use_pallas=None,
):
    """Multi-scale multi-frequency CLEAN (Rau & Cornwell 2011, Algorithm 1,
    image plane) of moment images ``dirty [nm, ny, nx]`` with moment PSFs
    ``psf [2 nm (or 1), py, px]`` and an optional ``[ny, nx]`` window.
    ``findpeak`` is "RASCIL" (or "Algorithm1") or "CASA".

    The loop follows the JAX package's XLA loop (``_msmfs_loop``), which
    the TPU kernel K8 (``_msmfs_corner_kernel``) also computes;
    ``use_pallas`` is accepted and ignored. On the CPU the inputs keep
    their dtype; on CUDA the kernel runs in f32.

    A sensitivity image raises: the JAX package multiplies the
    ``[nscales, ny, nx]`` search by the ``[nmoment, ny, nx]`` sensitivity
    stack, which fails unless the two counts agree.

    Returns (moment model, moment residual), both ``[nm, ny, nx]``."""
    if sensitivity is not None:
        raise not_ported("a sensitivity image in MSMFS CLEAN", "S9")
    if dirty.device.type != "cpu":
        dirty, psf = dirty.to(torch.float32), psf.to(torch.float32)
    stacks = msmfs_psf_stacks(psf, dirty.shape[-2], dirty.shape[-1], scales)
    return msmfs_with_stacks(
        stacks,
        dirty,
        window,
        gain=gain,
        thresh=thresh,
        niter=niter,
        fracthresh=fracthresh,
        findpeak=findpeak,
    )
