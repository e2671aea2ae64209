"""Deconvolution helpers the fused cycle reaches: clean arguments, PSF
bounding, beam fitting and restore.

Counterpart of the same functions in
``ska_sdp_func_python_tpu/ops/deconvolution.py``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import not_ported
from ..models.image import Image

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = [
    "common_arguments",
    "find_window",
    "bound_psf",
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
    """The clean window: only the windowless case (None) is ported."""
    if window_shape is not None or kwargs.get("mask") is not None:
        raise not_ported("clean windows", "S7x")
    return None


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
    host (scipy least squares). Returns {bmaj, bmin, bpa} in degrees."""
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
    sol = least_squares(
        lambda p: (gauss2d(p, x, y) - z).ravel(), p0, method="lm"
    )
    sx, sy, th = abs(sol.x[3]), abs(sol.x[4]), sol.x[5]
    if sx <= 0.0 or sy <= 0.0 or not sol.success:
        log.warning("fit_psf: fit failed, using 1 pixel stddev")
        beam_pixels = (1.0, 1.0, 0.0)
    else:
        beam_pixels = (sx, sy, th)
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
