"""Deconvolution: clean arguments, clean windows, PSF bounding,
``deconvolve_cube``, beam fitting and restore.

Counterpart of the same functions in
``ska_sdp_func_python_tpu/ops/deconvolution.py``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import not_ported
from ..models.image import Image
from .cleaners import hogbom_complex_lanes, hogbom_lanes, msclean, msmfsclean
from .taylor import (
    calculate_image_frequency_moments,
    calculate_image_from_frequency_taylor_terms,
)

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = [
    "common_arguments",
    "find_window",
    "bound_psf",
    "deconvolve_cube",
    "fit_psf",
    "restore_cube",
    "convert_clean_beam_to_degrees",
    "convert_clean_beam_to_pixels",
]

_TO_MM = np.sqrt(8.0 * np.log(2.0))  # sigma -> FWHM


def common_arguments(**kwargs):
    """(fracthresh, gain, niter, thresh, scales) with the JAX package's
    defaults and range checks."""
    gain = kwargs.get("gain", 0.1)
    if gain <= 0.0 or gain >= 2.0:
        raise ValueError("Loop gain must be between 0 and 2")
    thresh = kwargs.get("threshold", 0.0)
    if thresh < 0.0:
        raise ValueError("Threshold must be positive or zero")
    niter = kwargs.get("niter", 100)
    if niter < 0:
        raise ValueError("niter must be greater than zero")
    fracthresh = kwargs.get("fractional_threshold", 0.01)
    if fracthresh < 0.0 or fracthresh > 1.0:
        raise ValueError("Fractional threshold should be in range 0.0, 1.0")
    scales = kwargs.get("scales", [0, 3, 10, 30])
    return fracthresh, gain, niter, thresh, scales


def find_window(dirty: Image, window_shape=None, **kwargs):
    """The clean window (1 = the search may pick the pixel), on the device
    of ``dirty``: None; "quarter" (the central quarter); "no_edge" (all
    but ``window_edge`` pixels, default 16, at each edge); or an explicit
    ``mask`` (a tensor, an array or an Image), which takes precedence."""
    device = dirty.pixels.device
    mask = kwargs.get("mask", None)
    if mask is not None:
        return torch.as_tensor(getattr(mask, "pixels", mask), device=device)
    if window_shape is None:
        return None
    ny, nx = dirty.pixels.shape[-2:]
    window = torch.zeros(dirty.pixels.shape, dtype=dirty.pixels.dtype, device=device)
    if window_shape == "quarter":
        qx, qy = nx // 4, ny // 4
        window[..., qy + 1 : 3 * qy, qx + 1 : 3 * qx] = 1.0
    elif window_shape == "no_edge":
        edge = kwargs.get("window_edge", 16)
        window[..., edge + 1 : ny - edge, edge + 1 : nx - edge] = 1.0
    else:
        raise ValueError(f"Window shape {window_shape} is not recognized")
    return window


def bound_psf(dirty: Image, psf: Image, psf_support=None) -> Image:
    """Crop the PSF to +/- psf_support pixels about its centre."""
    ny, nx = dirty.pixels.shape[-2:]
    if psf_support is None:
        psf_support = max(ny // 2, nx // 2)
    py, px = psf.pixels.shape[-2:]
    if psf_support <= py // 2 and psf_support <= px // 2:
        cy, cx = py // 2, px // 2
        cropped = psf.pixels[
            ...,
            cy - psf_support : cy + psf_support,
            cx - psf_support : cx + psf_support,
        ]
        return psf.replace(pixels=cropped)
    return psf


def _lane_psfs(psf):
    """[lanes, py, px] PSFs with a unit delta in every empty lane, and the
    mask of the lanes whose PSF has a positive peak."""
    ok = psf.amax(dim=(-2, -1)) > 0.0
    delta = torch.zeros_like(psf)
    delta[:, psf.shape[-2] // 2, psf.shape[-1] // 2] = 1.0
    return torch.where(ok[:, None, None], psf, delta).contiguous(), ok


def deconvolve_cube(
    dirty: Image, psf: Image, sensitivity: Image = None, prefix: str = "", **kwargs
):
    """CLEAN a dirty image cube ``[nchan, npol, ny, nx]``.

    Algorithms: "hogbom", "hogbom-complex" (stokesIQUV: Hogbom for I and
    V, complex Hogbom for Q + iU), "msclean" (the default; with an
    optional ``sensitivity`` Image) and "mmclean" (also "msmfsclean",
    "mfsmsclean": MSMFS on the cube's frequency moments, see
    :func:`_mmclean_cube`). A (chan, pol) lane whose PSF has no
    positive peak is skipped: its components and residual stay zero
    (complex Hogbom runs for every channel, as in the JAX package). The
    PSF is bounded by :func:`bound_psf` (``psf_support``) and the window
    comes from :func:`find_window`.

    :return: (component Image, residual Image)
    """
    algorithm = kwargs.get("algorithm", "msclean")
    window = find_window(
        dirty,
        kwargs.get("window_shape", None),
        **{k: v for k, v in kwargs.items() if k != "window_shape"},
    )
    psf = bound_psf(dirty, psf, kwargs.get("psf_support", None))
    fracthresh, gain, niter, thresh, scales = common_arguments(**kwargs)
    clean = dict(gain=gain, thresh=thresh, niter=niter, fracthresh=fracthresh)
    nchan, npol, ny, nx = dirty.pixels.shape
    pix, ppix = dirty.pixels, psf.pixels
    comp = torch.zeros_like(pix)
    res = torch.zeros_like(pix)

    def win_for(chan, pol):
        if window is None:
            return None
        return window[min(chan, window.shape[0] - 1), pol]

    def lane_windows(lanes):
        if window is None:
            return None
        return torch.stack([win_for(c, p) for c, p in lanes])

    def hogbom_on(lanes):
        """Hogbom on the (chan, pol) ``lanes`` in one batch."""
        d = torch.stack([pix[c, p] for c, p in lanes]).to(torch.float32)
        p2, ok = _lane_psfs(
            torch.stack([ppix[c, p] for c, p in lanes]).to(torch.float32)
        )
        cb, rb = hogbom_lanes(d.contiguous(), p2, lane_windows(lanes), **clean)
        okm = ok[:, None, None]
        for i, (c, p) in enumerate(lanes):
            comp[c, p] = torch.where(okm[i], cb[i], 0.0).to(pix.dtype)
            res[c, p] = torch.where(okm[i], rb[i], 0.0).to(pix.dtype)

    if algorithm == "hogbom":
        hogbom_on([(c, p) for c in range(nchan) for p in range(npol)])
    elif algorithm == "hogbom-complex":
        if npol != 4:
            raise ValueError("hogbom-complex requires stokesIQUV images")
        hogbom_on([(c, p) for c in range(nchan) for p in (0, 3)])
        lanes = [(c, 1) for c in range(nchan)]
        f32 = torch.float32
        cq, cu, rq, ru = hogbom_complex_lanes(
            pix[:, 1].to(f32).contiguous(),
            pix[:, 2].to(f32).contiguous(),
            ppix[:, 1].to(f32).contiguous(),
            lane_windows(lanes),
            **clean,
        )
        comp[:, 1], comp[:, 2] = cq.to(pix.dtype), cu.to(pix.dtype)
        res[:, 1], res[:, 2] = rq.to(pix.dtype), ru.to(pix.dtype)
    elif algorithm == "msclean":
        sens = sensitivity.pixels if sensitivity is not None else None
        for c in range(nchan):
            for p in range(npol):
                if float(ppix[c, p].max()) <= 0.0:
                    continue
                cc, rr = msclean(
                    pix[c, p],
                    ppix[c, p],
                    win_for(c, p),
                    sens[c, p] if sens is not None else None,
                    gain=gain,
                    thresh=thresh,
                    niter=niter,
                    scales=tuple(scales),
                    fracthresh=fracthresh,
                )
                comp[c, p] = cc.to(pix.dtype)
                res[c, p] = rr.to(pix.dtype)
    elif algorithm in ("msmfsclean", "mfsmsclean", "mmclean"):
        return _mmclean_cube(dirty, psf, sensitivity, window, **kwargs)
    else:
        raise ValueError(f"deconvolve_cube: Unknown algorithm {algorithm}")
    return dirty.replace(pixels=comp), dirty.replace(pixels=res)


def _mmclean_cube(dirty: Image, psf: Image, sensitivity, window, **kwargs):
    """MSMFS on a channel cube through its frequency moments: the cube and
    the PSF become ``nmoment`` and ``2 nmoment`` moment images, each
    polarisation is cleaned by :func:`msmfsclean`, and the moment model and
    residual go back onto the cube's frequency grid. The loop gain defaults
    to 0.7. Needs ``nchan > 2 (nmoment - 1)``.

    As in the JAX package, the moment images are divided by the peak of
    the moment PSFs and the normalised moment components are taken back
    to the channels as they are (with unit-peak channel PSFs the peak is
    about nchan, so they are already in per-channel flux units). The
    window is the moment-0 image of the window cube over nchan.

    A sensitivity image raises: the JAX package multiplies the
    ``[nscales, ny, nx]`` search by the ``[nmoment, ny, nx]`` sensitivity
    stack, which fails unless the two counts agree."""
    fracthresh, gain, niter, thresh, scales = common_arguments(**kwargs)
    gain = kwargs.get("gain", 0.7)
    findpeak = kwargs.get("findpeak", "RASCIL")
    nmoment = kwargs.get("nmoment", 3)
    nchan = dirty.nchan
    if not nchan > 2 * (nmoment - 1):
        raise ValueError(
            f"Requires nchan > 2*(nmoment-1) ({nchan} > {2 * (nmoment - 1)})"
        )
    if sensitivity is not None:
        raise not_ported("a sensitivity image in MSMFS CLEAN", "S9")
    dirty_taylor = calculate_image_frequency_moments(dirty, nmoment=nmoment)
    nmoment_for_psf = 2 * nmoment if nmoment > 1 else 1
    psf_taylor = calculate_image_frequency_moments(psf, nmoment=nmoment_for_psf)
    psf_peak = psf_taylor.pixels.max()
    dpix = dirty_taylor.pixels / psf_peak
    ppix = psf_taylor.pixels / psf_peak
    w_taylor = None
    if window is not None:
        w_taylor = calculate_image_frequency_moments(
            dirty.replace(pixels=window.to(dirty.pixels.dtype)), nmoment=nmoment
        ).pixels / nchan
    comp_t = torch.zeros_like(dpix)
    res_t = torch.zeros_like(dpix)
    for pol in range(dirty.npol):
        if float(ppix[0, 0].max()) <= 0.0:
            continue
        c, r = msmfsclean(
            dpix[:, pol],
            ppix[:, 0],
            None if w_taylor is None else w_taylor[0, pol],
            gain=gain,
            thresh=thresh,
            niter=niter,
            scales=tuple(scales),
            fracthresh=fracthresh,
            findpeak=findpeak,
        )
        comp_t[:, pol] = c.to(dpix.dtype)
        res_t[:, pol] = r.to(dpix.dtype)
    comp = calculate_image_from_frequency_taylor_terms(
        dirty, dirty_taylor.replace(pixels=comp_t)
    )
    residual = calculate_image_from_frequency_taylor_terms(
        dirty, dirty_taylor.replace(pixels=res_t)
    )
    return comp, residual


def convert_clean_beam_to_degrees(im: Image, beam_pixels) -> dict:
    """(sigma_x_pix, sigma_y_pix, theta_rad) -> {bmaj, bmin, bpa} deg."""
    cellsize = im.cellsize
    b0, b1, b2 = (float(b) for b in beam_pixels)
    if b1 > b0:
        return {
            "bmaj": np.rad2deg(b1 * cellsize * _TO_MM),
            "bmin": np.rad2deg(b0 * cellsize * _TO_MM),
            "bpa": np.rad2deg(b2),
        }
    return {
        "bmaj": np.rad2deg(b0 * cellsize * _TO_MM),
        "bmin": np.rad2deg(b1 * cellsize * _TO_MM),
        "bpa": np.rad2deg(b2) + 90.0,
    }


def convert_clean_beam_to_pixels(model: Image, clean_beam: dict):
    """{bmaj, bmin, bpa} deg -> (sigma_x, sigma_y, theta) pixels/rad."""
    cellsize = model.cellsize
    return (
        np.deg2rad(clean_beam["bmin"]) / (cellsize * _TO_MM),
        np.deg2rad(clean_beam["bmaj"]) / (cellsize * _TO_MM),
        np.deg2rad(clean_beam["bpa"]),
    )


def fit_psf(psf: Image) -> dict:
    """Fit a 2-D Gaussian to the central 15x15 pixels of the PSF on the
    host (scipy least squares). Returns {bmaj, bmin, bpa} in degrees; where
    the fit fails or raises, a 1-pixel beam, as the JAX package does."""
    from scipy.optimize import least_squares

    npixel = psf.pixels.shape[3]
    sl = slice(npixel // 2 - 7, npixel // 2 + 8)
    z = psf.pixels[0, 0, sl, sl].detach().cpu().numpy()
    y, x = np.mgrid[sl, sl]

    def gauss2d(p, x, y):
        amp, x0, y0, sx, sy, th = p
        ct, st = np.cos(th), np.sin(th)
        a = ct**2 / (2 * sx**2) + st**2 / (2 * sy**2)
        b = st * ct * (1 / (2 * sx**2) - 1 / (2 * sy**2))
        c = st**2 / (2 * sx**2) + ct**2 / (2 * sy**2)
        return amp * np.exp(
            -(a * (x - x0) ** 2 + 2 * b * (x - x0) * (y - y0) + c * (y - y0) ** 2)
        )

    p0 = [float(z.max()), float(x.mean()), float(y.mean()), 1.5, 1.5, 0.0]
    try:
        sol = least_squares(
            lambda p: (gauss2d(p, x, y) - z).ravel(), p0, method="lm"
        )
        beam_pixels = (abs(sol.x[3]), abs(sol.x[4]), sol.x[5])
        fitted = sol.success and beam_pixels[0] > 0.0 and beam_pixels[1] > 0.0
    except Exception:  # e.g. non-finite pixels in the PSF core
        fitted = False
    if not fitted:
        log.warning("fit_psf: fit failed, using 1 pixel stddev")
        beam_pixels = (1.0, 1.0, 0.0)
    return convert_clean_beam_to_degrees(psf, beam_pixels)


def restore_cube(
    model: Image, psf: Image = None, residual: Image = None, clean_beam=None
) -> Image:
    """Convolve the model with the peak-normalised clean beam (FFT) and add
    the residual."""
    if clean_beam is None:
        if psf is None:
            raise ValueError(
                "restore_cube: either psf or clean_beam must be specified"
            )
        clean_beam = fit_psf(psf)
    sx, sy, th = convert_clean_beam_to_pixels(model, clean_beam)
    ny, nx = model.pixels.shape[-2:]
    dtype, device = model.pixels.dtype, model.pixels.device
    iy = torch.arange(ny, device=device).to(dtype) - ny // 2
    ix = torch.arange(nx, device=device).to(dtype) - nx // 2
    yy, xx = torch.meshgrid(iy, ix, indexing="ij")
    ct, st = np.cos(th), np.sin(th)
    a = ct**2 / (2 * sx**2) + st**2 / (2 * sy**2)
    b = st * ct * (1 / (2 * sx**2) - 1 / (2 * sy**2))
    c = st**2 / (2 * sx**2) + ct**2 / (2 * sy**2)
    gk = torch.exp(-(a * xx**2 + 2 * b * xx * yy + c * yy**2))
    kernel_f = torch.fft.fft2(torch.fft.ifftshift(gk))
    img_f = torch.fft.fft2(model.pixels, dim=(-2, -1))
    restored = torch.fft.ifft2(img_f * kernel_f, dim=(-2, -1)).real
    if residual is not None:
        restored = restored + residual.pixels
    return model.replace(
        pixels=restored.to(dtype),
        clean_beam=np.deg2rad(
            [clean_beam["bmaj"], clean_beam["bmin"], clean_beam["bpa"]]
        ),
    )
