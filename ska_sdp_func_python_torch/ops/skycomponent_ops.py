"""Sky-component operations: beams on components, selection and matching,
source finding and fitting, insertion into and restoration onto images,
Voronoi partitions and Taylor terms.

Counterpart of ``ska_sdp_func_python_tpu/ops/skycomponent_ops.py``. Fluxes
stay tensors on their device; catalogue algebra (separations, matching,
the Voronoi labels, source finding with ``scipy.ndimage`` and Gaussian
fits with ``scipy.optimize.least_squares``) is host numpy and scipy, as in
the JAX package. Nearest-pixel insertion sums in int64 fixed point
(``gridding.FixedGrid``), so components on one pixel give the same bits on
every card run; the other insertion kernels add one component's window at
a time, one writer a cell.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.components import SkyComponents
from ..models.image import Image
from ..utils.arrays import (
    insert_array,
    insert_function_L,
    insert_function_pswf,
    insert_function_sinc,
)
from .deconvolution import convert_clean_beam_to_pixels
from .dft import flux_on_channels
from .gain_ops import apply_jones
from .gridding import FixedGrid

__all__ = [
    "apply_beam_to_skycomponent",
    "apply_voltage_pattern_to_skycomponent",
    "filter_skycomponents_by_flux",
    "find_nearest_skycomponent_index",
    "find_nearest_skycomponent",
    "find_separation_skycomponents",
    "find_skycomponent_matches",
    "select_components_by_separation",
    "remove_neighbouring_components",
    "find_skycomponents",
    "insert_skycomponent",
    "restore_skycomponent",
    "voronoi_decomposition",
    "image_voronoi_iter",
    "partition_skycomponent_neighbours",
    "fit_skycomponent",
    "fit_skycomponent_spectral_index",
    "calculate_skycomponent_taylor_terms",
    "find_skycomponent_matches_atomic",
    "select_neighbouring_components",
]

# components whose Gaussians are built in one [block, ny, nx] tensor: all
# of a sky model's components at once would take ncomp x ny x nx (4 GB for
# a thousand components on a 1024^2 f32 image)
_BLOCK = 32


def _component_pixels(sc: SkyComponents, im: Image):
    """Fractional pixel positions (ix, iy), each ``[ncomp]`` host f64, of
    the components in ``im``."""
    return im.radec_to_pixel(sc.direction[:, 0], sc.direction[:, 1])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _nearest_pixels(sc: SkyComponents, im: Image):
    """The rounded pixel (x, y) of each component, int64 on the image's
    device, and whether it lies in the image."""
    ix, iy = _component_pixels(sc, im)
    x = torch.as_tensor(np.round(ix).astype(np.int64), device=im.device)
    y = torch.as_tensor(np.round(iy).astype(np.int64), device=im.device)
    ny, nx = im.pixels.shape[-2:]
    ok = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    return x.clamp(0, nx - 1), y.clamp(0, ny - 1), ok


def apply_beam_to_skycomponent(
    sc: SkyComponents, beam: Image, inverse: bool = False
) -> SkyComponents:
    """Scale each component's flux by the beam's value at its nearest
    pixel (divide by it with ``inverse``, where no channel or polarisation
    of the beam there is zero); components outside the beam get zero
    flux."""
    x, y, ok = _nearest_pixels(sc, beam)
    bvals = beam.pixels[:, :, y, x].permute(2, 0, 1)  # [ncomp, nchan, npol]
    bvals = (bvals.real if bvals.is_complex() else bvals).to(sc.flux.device)
    if inverse:
        nonzero = (bvals != 0.0).all(dim=2).all(dim=1)[:, None, None]
        safe = torch.where(bvals != 0.0, bvals, torch.ones_like(bvals))
        scaled = torch.where(nonzero, sc.flux / safe, sc.flux * bvals)
    else:
        scaled = sc.flux * bvals
    flux = torch.where(ok.to(sc.flux.device)[:, None, None], scaled, 0.0)
    return sc.replace(flux=flux.to(sc.flux.dtype))


def apply_voltage_pattern_to_skycomponent(
    sc: SkyComponents, vp: Image, inverse: bool = False
) -> SkyComponents:
    """flux' = E flux E^H per component, E the voltage pattern's 2x2 Jones
    matrix (``vp`` complex ``[nchan, 4, ny, nx]``) at its nearest pixel
    (clamped to the image), or E^-1 flux E^-H with ``inverse``."""
    x, y, _ = _nearest_pixels(sc, vp)
    ej = vp.pixels[:, :, y, x].permute(2, 0, 1)  # [ncomp, nchan, 4]
    ncomp, nchan = ej.shape[0], ej.shape[1]
    ej22 = ej.reshape(ncomp, nchan, 2, 2).to(sc.flux.device)
    flux22 = sc.flux.reshape(ncomp, sc.nchan, 2, 2).to(ej22.dtype)
    out = apply_jones(ej22, flux22, inverse=inverse)
    return sc.replace(flux=out.reshape(sc.flux.shape).real.to(sc.flux.dtype))


def filter_skycomponents_by_flux(
    sc: SkyComponents, flux_min: float = -np.inf, flux_max: float = np.inf
) -> SkyComponents:
    """The components whose largest first-polarisation flux over the
    channels lies strictly between ``flux_min`` and ``flux_max``."""
    fmax = _host(sc.flux[:, :, 0].amax(dim=1))
    keep = np.where((fmax > flux_min) & (fmax < flux_max))[0]
    return sc.select(keep)


def _angular_separation(d1, d2):
    """Great-circle separation (rad) between ``[..., 2]`` (ra, dec)
    arrays, by the haversine formula."""
    ra1, dec1 = d1[..., 0], d1[..., 1]
    ra2, dec2 = d2[..., 0], d2[..., 1]
    sin_d = np.sin((dec2 - dec1) / 2) ** 2
    sin_r = np.sin((ra2 - ra1) / 2) ** 2
    h = sin_d + np.cos(dec1) * np.cos(dec2) * sin_r
    return 2 * np.arcsin(np.minimum(1.0, np.sqrt(h)))


def find_separation_skycomponents(
    comps_test: SkyComponents, comps_ref: SkyComponents = None
):
    """Separations (rad) ``[ntest, nref]`` of every pair (``comps_ref``
    None: ``comps_test`` with itself)."""
    if comps_ref is None:
        comps_ref = comps_test
    d1 = np.asarray(comps_test.direction)[:, None, :]
    d2 = np.asarray(comps_ref.direction)[None, :, :]
    return _angular_separation(d1, d2)


def find_nearest_skycomponent_index(home, comps: SkyComponents) -> int:
    """Index of the component nearest to the direction ``home``."""
    home = np.asarray(home)[None, :]
    return int(np.argmin(_angular_separation(home, np.asarray(comps.direction))))


def find_nearest_skycomponent(home, comps: SkyComponents):
    """(index, separation in rad) of the component nearest to ``home``."""
    idx = find_nearest_skycomponent_index(home, comps)
    sep = _angular_separation(np.asarray(home), np.asarray(comps.direction)[idx])
    return idx, float(sep)


def find_skycomponent_matches(
    comps_test: SkyComponents, comps_ref: SkyComponents, tol: float = 1e-7
):
    """(itest, iref, separation) for every test component whose nearest
    reference lies within ``tol`` rad."""
    seps = find_separation_skycomponents(comps_test, comps_ref)
    matches = []
    for itest in range(seps.shape[0]):
        iref = int(np.argmin(seps[itest]))
        if seps[itest, iref] < tol:
            matches.append((itest, iref, float(seps[itest, iref])))
    return matches


def select_components_by_separation(
    home, comps: SkyComponents, rmax: float = 2 * np.pi, rmin: float = 0.0
) -> SkyComponents:
    """The components between ``rmin`` and ``rmax`` rad of ``home``."""
    seps = _angular_separation(np.asarray(home)[None, :], np.asarray(comps.direction))
    return comps.select(np.where((seps >= rmin) & (seps <= rmax))[0])


def remove_neighbouring_components(comps: SkyComponents, distance: float):
    """Of every pair closer than ``distance`` rad keep the brighter (by
    first-polarisation flux summed over channels; the earlier on a tie).
    Returns (kept indices, kept components)."""
    ncomp = comps.ncomp
    seps = find_separation_skycomponents(comps)
    fluxes = _host(comps.flux[:, :, 0].sum(dim=1))
    keep = np.ones(ncomp, dtype=bool)
    for i in range(ncomp):
        if not keep[i]:
            continue
        for j in range(i + 1, ncomp):
            if keep[j] and seps[i, j] < distance:
                if fluxes[i] >= fluxes[j]:
                    keep[j] = False
                else:
                    keep[i] = False
                    break
    idx = np.where(keep)[0]
    return list(idx), comps.select(idx)


def _deblend_island(det, mask, npixels, nlevels, contrast):
    """Multi-threshold deblending of one island (photutils
    ``deblend_sources`` semantics): of ``nlevels`` exponentially spaced
    thresholds between the island's floor and peak, the one giving the
    most children of at least ``npixels`` pixels and ``contrast`` of the
    island's flux seeds a watershed over the inverted intensity, and
    every island pixel joins its basin (the brightest child's where the
    watershed leaves it). Returns the children's masks (the island's own
    where it does not split)."""
    from scipy import ndimage

    vals = det[mask]
    tot = float(vals.sum())
    tmin, tmax = float(vals.min()), float(vals.max())
    if tot <= 0 or tmax <= tmin:
        return [mask]
    f = (np.exp(np.linspace(0.0, 1.0, nlevels + 2)[1:-1]) - 1.0) / (np.e - 1.0)
    best = None
    for lev in tmin + (tmax - tmin) * f:
        lab, n = ndimage.label(mask & (det > lev))
        if n < 2:
            continue
        idx = np.arange(1, n + 1)
        sizes = ndimage.sum_labels(np.ones(det.shape, np.float64), lab, idx)
        flux = ndimage.sum_labels(det, lab, idx)
        ok = (sizes >= npixels) & (flux / tot >= contrast)
        if int(ok.sum()) >= 2 and (best is None or int(ok.sum()) > best[1]):
            best = (np.where(np.isin(lab, idx[ok]), lab, 0), int(ok.sum()))
    if best is None:
        return [mask]
    markers = best[0].astype(np.int32)
    inv = np.full(det.shape, 255, np.uint8)
    inv[mask] = np.clip((tmax - det[mask]) * (254.0 / (tmax - tmin)), 0, 254).astype(np.uint8)
    seeds = markers.copy()
    seeds[~mask] = -1
    ws = ndimage.watershed_ift(inv, seeds, structure=np.ones((3, 3), int))
    out = []
    assigned = np.zeros(det.shape, bool)
    for g in np.unique(markers[markers > 0]):
        m = mask & (ws == g)
        assigned |= m
        out.append(m)
    rest = mask & ~assigned
    if rest.any() and out:
        peak = int(np.argmax([float(det[m].max()) if m.any() else -np.inf for m in out]))
        out[peak] = out[peak] | rest
    return [m for m in out if m.sum() >= npixels] or [mask]


def _components_like(im: Image, directions, fluxes) -> SkyComponents:
    """Components on the image's device, in its real dtype and frame."""
    real = im.pixels.real if im.pixels.is_complex() else im.pixels
    return SkyComponents.from_lists(
        np.asarray(directions, np.float64).reshape(-1, 2),
        np.asarray(fluxes, np.float64).reshape(-1, im.nchan, im.npol),
        np.asarray(im.frequency),
        polarisation_frame=im.polarisation_frame,
        dtype=real.dtype,
        device=im.device,
    )


def find_skycomponents(
    im: Image,
    fwhm: float = 1.0,
    threshold: float = 1.0,
    npixels: int = 5,
    deblend: bool = False,
    nlevels: int = 32,
    contrast: float = 0.001,
) -> SkyComponents:
    """Segmentation source finding on the host (``scipy.ndimage``): the
    image's mean over channels and polarisations, smoothed by a Gaussian
    of ``fwhm`` pixels, is labelled above ``threshold``; every island of
    at least ``npixels`` pixels (with ``deblend``, every child of its
    multi-threshold watershed) becomes one component at its
    detection-weighted centroid with the island's summed flux per channel
    and polarisation."""
    from scipy import ndimage

    pixels = _host(im.pixels)
    det = pixels.mean(axis=(0, 1))
    if fwhm > 0:
        det = ndimage.gaussian_filter(det, fwhm / np.sqrt(8 * np.log(2)))
    labels, nlab = ndimage.label(det > threshold)
    island_masks = []
    for lab in range(1, nlab + 1):
        mask = labels == lab
        if mask.sum() < npixels:
            continue
        if deblend:
            island_masks.extend(_deblend_island(det, mask, npixels, nlevels, contrast))
        else:
            island_masks.append(mask)
    dirs, fluxes = [], []
    for mask in island_masks:
        yy, xx = np.nonzero(mask)
        wts = det[yy, xx]
        cy = float(np.sum(yy * wts) / np.sum(wts))
        cx = float(np.sum(xx * wts) / np.sum(wts))
        ra, dec = im.pixel_to_radec(cx, cy)
        dirs.append([float(ra), float(dec)])
        fluxes.append(pixels[:, :, yy, xx].sum(axis=-1))
    if not dirs:
        return _components_like(im, np.zeros((0, 2)), np.zeros((0, im.nchan, im.npol)))
    return _components_like(im, dirs, np.stack(fluxes))


def insert_skycomponent(
    im: Image,
    sc: SkyComponents,
    insert_method: str = "Nearest",
    bandwidth: float = 1.0,
    support: int = 8,
) -> Image:
    """Add the components into the image: at the nearest pixel
    ("Nearest", components outside the image dropped), or through an
    anti-aliasing window of 2 ``support / bandwidth`` pixels a side
    ("Lanczos", "Sinc", "PSWF"; ``utils.arrays.insert_array``). Fluxes of
    other channels than the image's are interpolated linearly in
    frequency. Nearest sums every component's flux in int64 fixed point
    before it meets the pixels, so the result repeats bit for bit."""
    support = int(support / bandwidth)
    ix, iy = _component_pixels(sc, im)
    dtype, device = im.pixels.dtype, im.device
    flux = flux_on_channels(sc.flux, sc.frequency, torch.tensor(np.asarray(im.frequency)),
                            im.nchan)
    flux = flux.to(device=device)
    pixels = im.pixels
    if insert_method == "Nearest":
        x, y, ok = _nearest_pixels(sc, im)
        nchan, npol, ny, nx = pixels.shape
        fl = torch.where(ok[:, None, None], flux, 0.0).to(dtype)  # [ncomp, c, p]
        plane = torch.arange(nchan * npol, device=device).reshape(nchan, npol)
        idx = (plane[None] * ny + y[:, None, None]) * nx + x[:, None, None]
        fixed = FixedGrid(pixels.numel(), fl.abs().sum(), dtype, device)
        fixed.add(idx, fl)
        pixels = pixels + fixed.value().reshape(pixels.shape)
    else:
        fn = {
            "Lanczos": insert_function_L,
            "Sinc": insert_function_sinc,
            "PSWF": insert_function_pswf,
        }[insert_method]
        for i in range(sc.ncomp):
            pixels = insert_array(
                pixels, float(ix[i]), float(iy[i]), flux[i], bandwidth, support, fn
            )
    return im.replace(pixels=pixels)


def restore_skycomponent(
    im: Image, sc: SkyComponents, clean_beam: dict = None
) -> Image:
    """Add a clean-beam Gaussian of each component's flux at its position.

    Components of one channel serve every image channel; components of
    several channels restored onto a one-channel image add their mean
    flux (the continuum image is the channel mean); onto an image of
    other channels, their flux interpolated linearly in frequency (as
    :func:`insert_skycomponent` takes it; the JAX package fails on the
    shapes there)."""
    if clean_beam is None:
        clean_beam = {"bmaj": 1e-2, "bmin": 1e-2, "bpa": 0.0}
    sx, sy, th = convert_clean_beam_to_pixels(im, clean_beam)
    ix, iy = _component_pixels(sc, im)
    ny, nx = im.pixels.shape[-2:]
    dtype, device = im.pixels.dtype, im.pixels.device
    ct, st = np.cos(th), np.sin(th)
    a = ct**2 / (2 * sx**2) + st**2 / (2 * sy**2)
    b = st * ct * (1 / (2 * sx**2) - 1 / (2 * sy**2))
    c = st**2 / (2 * sx**2) + ct**2 / (2 * sy**2)
    flux = sc.flux.to(device=device, dtype=dtype)
    if flux.shape[1] > 1 and im.nchan == 1:
        flux = flux.mean(dim=1, keepdim=True)
    else:
        flux = flux_on_channels(flux, sc.frequency, torch.tensor(np.asarray(im.frequency)),
                                im.nchan)
    xx = torch.arange(nx, device=device, dtype=dtype)[None, None, :]
    yy = torch.arange(ny, device=device, dtype=dtype)[None, :, None]
    cx = torch.as_tensor(ix, device=device).to(dtype)[:, None, None]
    cy = torch.as_tensor(iy, device=device).to(dtype)[:, None, None]
    pixels = im.pixels.clone()
    for k in range(0, sc.ncomp, _BLOCK):
        dx = xx - cx[k : k + _BLOCK]
        dy = yy - cy[k : k + _BLOCK]
        g = torch.exp(-(a * dx**2 + 2 * b * dx * dy + c * dy**2))
        pixels += torch.einsum("kfp,kyx->fpyx", flux[k : k + _BLOCK], g)
    return im.replace(
        pixels=pixels,
        clean_beam=np.deg2rad(
            [clean_beam["bmaj"], clean_beam["bmin"], clean_beam["bpa"]]
        ),
    )


def voronoi_decomposition(im: Image, comps: SkyComponents):
    """The Voronoi cells of the components on the image's pixels, on the
    host. Returns (the components' pixel positions ``[ncomp, 2]`` (x, y),
    the label image ``[ny, nx]`` of each pixel's nearest component)."""
    ix, iy = (np.asarray(a, np.float64) for a in _component_pixels(comps, im))
    ny, nx = im.pixels.shape[-2:]
    yy, xx = np.mgrid[0:ny, 0:nx]
    d2 = (xx[None] - ix[:, None, None]) ** 2 + (yy[None] - iy[:, None, None]) ** 2
    return np.stack([ix, iy], axis=-1), np.argmin(d2, axis=0)


def image_voronoi_iter(im: Image, comps: SkyComponents):
    """Yield the image masked to each component's Voronoi cell, in
    component order."""
    _, labels = voronoi_decomposition(im, comps)
    for i in range(comps.ncomp):
        mask = torch.as_tensor(labels == i, device=im.device).to(im.pixels.dtype)
        yield im.replace(pixels=im.pixels * mask[None, None])


def partition_skycomponent_neighbours(comps: SkyComponents, targets):
    """The components split by their nearest target direction (``targets``
    ``[ntarget, 2]`` (ra, dec) rad): one SkyComponents a target."""
    targets = np.asarray(targets).reshape(-1, 2)
    seps = _angular_separation(np.asarray(comps.direction)[:, None, :], targets[None])
    owner = np.argmin(seps, axis=1)
    return [comps.select(np.where(owner == k)[0]) for k in range(len(targets))]


def fit_skycomponent(im: Image, sc_guess, **kwargs) -> SkyComponents:
    """Fit an elliptical-axis 2-D Gaussian (amplitude, centre, two widths)
    to the first channel and polarisation of the image in a 15 x 15 window
    at the guessed direction (a SkyComponents' first, or an (ra, dec)
    pair), on the host with ``scipy.optimize.least_squares``. Returns one
    component at the fitted centre whose flux is the amplitude on every
    channel and polarisation."""
    from scipy.optimize import least_squares

    pixels = _host(im.pixels[0, 0])
    if isinstance(sc_guess, SkyComponents):
        direction = np.asarray(sc_guess.direction[0])
    else:
        direction = np.asarray(sc_guess)
    ix, iy = im.radec_to_pixel(direction[0], direction[1])
    x0, y0 = float(ix), float(iy)
    ny, nx = pixels.shape
    half = 7
    xlo = int(np.clip(round(x0) - half, 0, nx - 2 * half))
    ylo = int(np.clip(round(y0) - half, 0, ny - 2 * half))
    z = pixels[ylo : ylo + 2 * half + 1, xlo : xlo + 2 * half + 1]
    yy, xx = np.mgrid[ylo : ylo + 2 * half + 1, xlo : xlo + 2 * half + 1]

    def gauss(p):
        amp, cx, cy, sx, sy = p
        return amp * np.exp(-((xx - cx) ** 2 / (2 * sx**2) + (yy - cy) ** 2 / (2 * sy**2)))

    sol = least_squares(lambda p: (gauss(p) - z).ravel(), [float(z.max()), x0, y0, 2.0, 2.0])
    amp, cx, cy = sol.x[0], sol.x[1], sol.x[2]
    ra, dec = im.pixel_to_radec(cx, cy)
    return _components_like(im, [[float(ra), float(dec)]], np.full((1, im.nchan, im.npol), amp))


def fit_skycomponent_spectral_index(sc: SkyComponents):
    """The power-law index of each component's first-polarisation flux
    against frequency (a line in log-log over its positive channels; 0
    with fewer than two). Returns ``[ncomp]`` host f64."""
    freq = _host(sc.frequency).astype(np.float64)
    flux = _host(sc.flux[:, :, 0]).astype(np.float64)
    out = np.zeros(sc.ncomp)
    if len(freq) < 2:
        return out
    for i in range(sc.ncomp):
        good = flux[i] > 0
        if good.sum() >= 2:
            out[i] = np.polyfit(np.log(freq[good]), np.log(flux[i][good]), 1)[0]
    return out


def calculate_skycomponent_taylor_terms(
    sc: SkyComponents, nmoment: int = 1, reference_frequency=None
):
    """The frequency Taylor terms of each component's flux: the
    pseudo-inverse of the channel-moment weights applied over the
    channels. Returns ``[ncomp, nmoment, npol]`` on the flux's device."""
    from .taylor import moment_weights

    w = moment_weights(sc.frequency.to(torch.float64), reference_frequency, nmoment)
    pinv = torch.linalg.pinv(w, rtol=1e-7)
    return torch.einsum("mc,ncp->nmp", pinv.to(sc.flux.dtype), sc.flux)


def find_skycomponent_matches_atomic(comps_test, comps_ref, tol=1e-7):
    """(test index, ref index, separation) of every test component whose
    nearest reference lies within ``tol`` rad (many to one allowed)."""
    return find_skycomponent_matches(comps_test, comps_ref, tol)


def select_neighbouring_components(comps, target_comps):
    """Each component's nearest target. Returns (indices into
    ``target_comps`` ``[ncomp]``, separations ``[ncomp]`` rad), host."""
    seps = find_separation_skycomponents(comps, target_comps)
    return np.argmin(seps, axis=1), np.min(seps, axis=1)
