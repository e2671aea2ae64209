"""Parity of the port's ``find_window`` and ``deconvolve_cube`` with the
JAX package's, for the three ported algorithms, with clean windows.

Both sides get the same numpy cube through ``interop.to_image``.
``fit_psf``: on a PSF with a non-finite core pixel both packages fall
back to the same 1-pixel beam; on a noise-free elliptical Gaussian the
port's fit returns that beam to 5e-3 relative (bmaj, bmin) and 0.05 deg
(bpa, modulo 180), the accuracy of its fit from a circular start
(``BEAM_RTOL``). Tolerances: windows identical; Hogbom and complex Hogbom in f32 (their
kernels' type): identical component positions, components and residuals
to 1e-5 of the cube maximum (the JAX complex loop rounds its complex
division and modulus differently); msclean in f64 to 1e-8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.models.image import create_image as jax_create_image
from ska_sdp_func_python_tpu.ops.deconvolution import (
    deconvolve_cube as jax_deconvolve_cube,
    find_window as jax_find_window,
    fit_psf as jax_fit_psf,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models.image import create_image
from ska_sdp_func_python_torch.ops.deconvolution import (
    deconvolve_cube,
    find_window,
    fit_psf,
    restore_cube,
)

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))


def _image(pixels, frame):
    im = jax_create_image(
        pixels.shape[-1], 0.001, PC, frequency=np.linspace(1e8, 1.1e8, pixels.shape[0]),
        polarisation_frame=frame, nchan=pixels.shape[0],
    )
    return im.replace(pixels=jnp.asarray(pixels))


def _psf(n, sigma=2.5):
    yy, xx = np.mgrid[0:n, 0:n] - n // 2
    r = np.hypot(yy, xx)
    return np.exp(-(r / sigma) ** 2) + 0.05 * np.cos(r / 1.7) * (r > 3)


def _cube(nchan, npol, n, rng, pol=None):
    """A dirty cube of point sources convolved with the PSF; ``pol``
    (p, chi, v) gives Q, U and V as fractions of I."""
    psf = _psf(2 * n)
    pad = np.zeros((3 * n, 3 * n))
    for _ in range(4):
        y, x = rng.integers(0, n, 2)
        pad[y : y + 2 * n, x : x + 2 * n] += rng.uniform(0.5, 2.0) * psf
    d = pad[n : 2 * n, n : 2 * n] + rng.normal(0, 0.005, (n, n))
    planes = [d] * npol
    if pol is not None:
        p, chi, v = pol
        planes = [d, p * np.cos(2 * chi) * d, p * np.sin(2 * chi) * d, v * d]
    dirty = np.stack([np.stack(planes) * (1.0 + 0.1 * c) for c in range(nchan)])
    psf_n = psf[n // 2 : n // 2 + n, n // 2 : n // 2 + n]
    psf_cube = np.broadcast_to(psf_n, dirty.shape).copy()
    return dirty, psf_cube


@pytest.mark.parametrize(
    "shape,kw",
    [("quarter", {}), ("no_edge", {"window_edge": 5}), (None, {"mask": True})],
    ids=["quarter", "no_edge", "mask"],
)
def test_find_window_matches_jax(shape, kw):
    pix = np.zeros((1, 1, 40, 40))
    if kw.get("mask"):
        kw = {"mask": np.random.default_rng(3).uniform(size=(1, 1, 40, 40)) > 0.5}
    ref = np.asarray(jax_find_window(_image(pix, "stokesI"), shape, **kw))
    out = find_window(interop.to_image(_image(pix, "stokesI"), device=CPU), shape, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


def _compare(jim, pim, tol):
    a, b = pim.pixels.numpy(), np.asarray(jim.pixels)
    np.testing.assert_array_equal(a != 0.0, b != 0.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("window", [None, "quarter"])
def test_deconvolve_cube_hogbom_matches_jax(window):
    rng = np.random.default_rng(41)
    dirty, psf = _cube(2, 1, 64, rng)
    psf[1] = 0.0  # an empty PSF: that lane is skipped
    dirty, psf = dirty.astype(np.float32), psf.astype(np.float32)
    kw = dict(algorithm="hogbom", niter=100, gain=0.2, fractional_threshold=0.01,
              window_shape=window)
    jc, jr = jax_deconvolve_cube(_image(dirty, "stokesI"), _image(psf, "stokesI"), **kw)
    pc, pr = deconvolve_cube(
        interop.to_image(_image(dirty, "stokesI"), device=CPU),
        interop.to_image(_image(psf, "stokesI"), device=CPU), **kw,
    )
    _compare(jc, pc, 1e-5)
    _compare(jr, pr, 1e-5)
    assert float(pc.pixels[1].abs().max()) == 0.0


@pytest.mark.parametrize("window", [None, "quarter"])
def test_deconvolve_cube_hogbom_complex_matches_jax(window):
    rng = np.random.default_rng(42)
    dirty, psf = _cube(1, 4, 64, rng, pol=(0.2, np.deg2rad(30.0), 0.02))
    dirty, psf = dirty.astype(np.float32), psf.astype(np.float32)
    kw = dict(algorithm="hogbom-complex", niter=100, gain=0.2,
              fractional_threshold=0.01, window_shape=window)
    jc, jr = jax_deconvolve_cube(
        _image(dirty, "stokesIQUV"), _image(psf, "stokesIQUV"), **kw
    )
    pc, pr = deconvolve_cube(
        interop.to_image(_image(dirty, "stokesIQUV"), device=CPU),
        interop.to_image(_image(psf, "stokesIQUV"), device=CPU), **kw,
    )
    _compare(jc, pc, 1e-5)
    _compare(jr, pr, 1e-5)
    # the sky's one polarisation angle comes back from the components
    c = pc.pixels.numpy()[0]
    chi = 0.5 * np.degrees(np.arctan2(c[2].sum(), c[1].sum()))
    assert abs(chi - 30.0) < 0.1


@pytest.mark.parametrize("window", [None, "quarter"])
def test_deconvolve_cube_msclean_matches_jax(window):
    rng = np.random.default_rng(43)
    dirty, psf = _cube(1, 1, 64, rng)
    sens = rng.uniform(0.5, 1.5, dirty.shape)
    kw = dict(algorithm="msclean", niter=30, gain=0.2, fractional_threshold=0.01,
              scales=[0, 3, 10], window_shape=window)
    jc, jr = jax_deconvolve_cube(
        _image(dirty, "stokesI"), _image(psf, "stokesI"), _image(sens, "stokesI"), **kw
    )
    pc, pr = deconvolve_cube(
        interop.to_image(_image(dirty, "stokesI"), device=CPU),
        interop.to_image(_image(psf, "stokesI"), device=CPU),
        interop.to_image(_image(sens, "stokesI"), device=CPU), **kw,
    )
    assert pc.pixels.dtype == torch.float64
    _compare(jc, pc, 1e-8)
    _compare(jr, pr, 1e-8)


def test_stokesiquv_image_and_mmclean_raise():
    """A stokesIQUV image has four planes; mmclean on too few channels for
    its moments (nchan <= 2 (nmoment - 1)) raises as in the JAX package."""
    im = create_image(32, 0.001, PC, polarisation_frame="stokesIQUV", device=CPU)
    assert im.pixels.shape == (1, 4, 32, 32)
    with pytest.raises(ValueError, match="nchan > 2"):
        deconvolve_cube(im, im, algorithm="mmclean")
    with pytest.raises(ValueError, match="nchan > 2"):
        deconvolve_cube(im, im, algorithm="mmclean", nmoment=2)


def _spectral_cube(nchan, n, rng):
    """A stokesI cube over 100-160 MHz: channel PSFs that narrow with
    frequency, and point sources with spectral indices through them."""
    freq = np.linspace(1.0e8, 1.6e8, nchan)
    f0 = freq[nchan // 2]
    psf = np.stack([_psf(2 * n, 2.5 * f0 / f) for f in freq])
    dirty = np.zeros((nchan, 1, n, n))
    for c, f in enumerate(freq):
        pad = np.zeros((3 * n, 3 * n))
        for (y, x), flux, alpha in zip(
            rng.integers(n // 8, 7 * n // 8, (3, 2)), (2.0, 1.2, 0.7), (-0.7, 0.4, -1.2)
        ):
            pad[y : y + 2 * n, x : x + 2 * n] += flux * (f / f0) ** alpha * psf[c]
        dirty[c, 0] = pad[n : 2 * n, n : 2 * n]
    dirty += rng.normal(0, 0.003, dirty.shape)
    psf_n = psf[:, None, n // 2 : n // 2 + n, n // 2 : n // 2 + n]
    return freq, dirty, psf_n.copy()


@pytest.mark.parametrize("window", [None, "quarter"])
@pytest.mark.parametrize("nmoment", [2, 3])
def test_deconvolve_cube_mmclean_matches_jax(nmoment, window):
    """MSMFS through frequency moments on a 6-channel cube, in f64."""
    rng = np.random.default_rng(44)
    freq, dirty, psf = _spectral_cube(6, 64, rng)

    def image(pix):
        im = jax_create_image(64, 0.001, PC, frequency=freq, nchan=6)
        return im.replace(pixels=jnp.asarray(pix))

    kw = dict(algorithm="mmclean", nmoment=nmoment, niter=40,
              fractional_threshold=0.01, scales=[0, 3, 10], window_shape=window)
    jc, jr = jax_deconvolve_cube(image(dirty), image(psf), **kw)
    pc, pr = deconvolve_cube(
        interop.to_image(image(dirty), device=CPU),
        interop.to_image(image(psf), device=CPU), **kw,
    )
    assert pc.pixels.dtype == torch.float64 and pc.pixels.shape == (6, 1, 64, 64)
    _compare(jc, pc, 1e-8)
    _compare(jr, pr, 1e-8)
    with pytest.raises(NotImplementedError, match="no reference behaviour"):
        deconvolve_cube(
            interop.to_image(image(dirty), device=CPU),
            interop.to_image(image(psf), device=CPU),
            interop.to_image(image(psf), device=CPU), **kw,
        )


_FWHM = np.sqrt(8.0 * np.log(2.0))


def _beam_psf(n, beam, cellsize=0.001):
    """A peak-1 f32 PSF [1, 1, n, n] that is exactly the clean beam
    ``beam`` ({bmaj, bmin, bpa} deg): stddev bmin along x and bmaj along y
    rotated by bpa, the Gaussian ``restore_cube`` convolves with."""
    sx = np.deg2rad(beam["bmin"]) / (cellsize * _FWHM)
    sy = np.deg2rad(beam["bmaj"]) / (cellsize * _FWHM)
    th = np.deg2rad(beam["bpa"])
    yy, xx = np.mgrid[0:n, 0:n] - n // 2
    ct, st = np.cos(th), np.sin(th)
    a = ct**2 / (2 * sx**2) + st**2 / (2 * sy**2)
    b = st * ct * (1 / (2 * sx**2) - 1 / (2 * sy**2))
    c = st**2 / (2 * sx**2) + ct**2 / (2 * sy**2)
    psf = np.exp(-(a * xx**2 + 2 * b * xx * yy + c * yy**2))
    return psf[None, None].astype(np.float32)


def _nan_core_psf(n=64):
    psf = _beam_psf(n, {"bmaj": 0.4, "bmin": 0.25, "bpa": 20.0})
    psf[0, 0, n // 2 + 3, n // 2 - 5] = np.nan  # inside the central 15x15
    return psf


def test_fit_psf_non_finite_core_falls_back_as_jax():
    psf = _nan_core_psf()
    ref = jax_fit_psf(_image(psf, "stokesI"))
    out = fit_psf(interop.to_image(_image(psf, "stokesI"), device=CPU))
    one_pixel = np.rad2deg(0.001 * _FWHM)
    for k in ("bmaj", "bmin", "bpa"):
        assert out[k] == pytest.approx(float(ref[k]), rel=1e-12)
    assert out["bmaj"] == pytest.approx(one_pixel) and out["bmin"] == pytest.approx(one_pixel)


def test_restore_cube_with_non_finite_psf_core_completes():
    psf = interop.to_image(_image(_nan_core_psf(), "stokesI"), device=CPU)
    model = np.zeros((1, 1, 64, 64), np.float32)
    model[0, 0, 20, 40] = 1.5
    model = interop.to_image(_image(model, "stokesI"), device=CPU)
    out = restore_cube(model, psf, residual=model)
    assert torch.isfinite(out.pixels).all()
    # the 1-pixel beam restores the point to its own flux
    assert float(out.pixels[0, 0, 20, 40]) == pytest.approx(3.0, rel=1e-5)


# the fit starts from a circular beam, where its angle has no gradient; its
# first steps move the angle by ~1e6 rad and Levenberg-Marquardt then stops
# on its step tolerance short of the minimum: 1e-6 off on the first beam,
# up to 3.2e-3 (bmaj, bmin) and 0.02 deg (bpa) on the narrower ones
BEAM_RTOL, BPA_TOL = 5e-3, 0.05


@pytest.mark.parametrize(
    "beam",
    [
        {"bmaj": 0.40, "bmin": 0.25, "bpa": 30.0},
        {"bmaj": 0.55, "bmin": 0.30, "bpa": -65.0},
        {"bmaj": 0.45, "bmin": 0.20, "bpa": -65.0},
        {"bmaj": 0.45, "bmin": 0.20, "bpa": 40.0},
    ],
    ids=["bpa30", "bpa-65", "narrow-bpa-65", "narrow-bpa40"],
)
def test_fit_psf_recovers_elliptical_beam(beam):
    psf = interop.to_image(_image(_beam_psf(64, beam), "stokesI"), device=CPU)
    out = fit_psf(psf)
    assert out["bmaj"] == pytest.approx(beam["bmaj"], rel=BEAM_RTOL)
    assert out["bmin"] == pytest.approx(beam["bmin"], rel=BEAM_RTOL)
    dpa = (out["bpa"] - beam["bpa"] + 90.0) % 180.0 - 90.0
    assert abs(dpa) < BPA_TOL
