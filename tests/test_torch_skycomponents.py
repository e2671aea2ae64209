"""The sky-component periphery of the port against the JAX package, on the
same seeded numpy inputs (x64 on the CPU): the DFT of components whose
fluxes are given on other channels than the visibility's, and every
function of ``ops.skycomponent_ops`` and ``ops.skycomponent_taylor``.

Tolerances: f64 values to 1e-10 of their maximum (absolute where it is
below one); component lists, indices and labels, where the JAX output is
discrete, identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu import ops as jops
from ska_sdp_func_python_tpu.models import SkyComponents as JaxComponents
from ska_sdp_func_python_tpu.models import create_image as jax_create_image
from ska_sdp_func_python_torch import interop, ops
from ska_sdp_func_python_torch.ops.dft import flux_on_channels, interp

from simul import make_visibility

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
NPIX = 96
FREQ = np.array([0.95e8, 1.0e8, 1.07e8])  # the components' channels
IMFREQ = np.array([0.9e8, 0.98e8, 1.02e8, 1.1e8])  # the image's (two outside)
TOL = 1e-10


def _image(npol=1, frame="stokesI", freq=IMFREQ, seed=0, complex_=False):
    """A JAX image of random pixels (complex for a voltage pattern) and
    its port copy on the CPU."""
    rng = np.random.default_rng(seed)
    im = jax_create_image(NPIX, 2e-4, np.asarray(PC), frequency=freq,
                          polarisation_frame=frame)
    shape = im.pixels.shape
    px = rng.uniform(0.5, 1.5, shape)
    if complex_:
        px = px * np.exp(1j * rng.uniform(-0.5, 0.5, shape))
    im = im.with_pixels(jnp.asarray(px))
    return im, interop.to_image(im, device=CPU)


def _components(im, pix, fluxes, freq=FREQ, frame="stokesI"):
    """Components at the image pixels ``pix`` [(x, y)] with fluxes
    ``[ncomp, nchan, npol]``, as JAX and port SkyComponents."""
    dirs = [[float(a) for a in im.pixel_to_radec(x, y)] for x, y in pix]
    jc = JaxComponents.from_lists(dirs, np.asarray(fluxes, float), freq,
                                  polarisation_frame=frame)
    return jc, interop.to_skycomponents(jc, device=CPU)


@pytest.fixture(scope="module")
def sky():
    im, pim = _image()
    rng = np.random.default_rng(3)
    pix = [(40.3, 52.6), (40.7, 52.2), (70.1, 20.9), (10.5, 80.4), (48.0, 48.0),
           (120.0, 30.0)]  # the last outside the image
    flux = rng.uniform(0.2, 3.0, (len(pix), len(FREQ), 1))
    return im, pim, *_components(im, pix, flux)


def _close(out, ref, tol=TOL):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(5)
    xp = np.sort(rng.uniform(0, 10, 7))
    fp = rng.normal(size=(3, 2, 7))
    x = np.concatenate([rng.uniform(-2, 12, 20), xp])
    ref = np.stack([[np.interp(x, xp, f) for f in row] for row in fp])
    _close(interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)), ref, 1e-14)


def test_dft_of_spectral_components_matches_jax():
    """Components of three channels predicted onto four visibility
    channels (two outside their band: held at the end values)."""
    vis = make_visibility(nants=6, ntimes=2, nchan=4, frequency0=0.9e8,
                          channel_bandwidth=0.6e7, phasecentre=PC)
    im, _ = _image()
    rng = np.random.default_rng(7)
    jc, pc = _components(im, [(30.2, 60.7), (55.5, 41.1)], rng.uniform(0.5, 2, (2, 3, 1)))
    ref = jops.dft_skycomponent_visibility(vis, jc)
    out = ops.dft_skycomponent_visibility(interop.to_visibility(vis, device=CPU), pc)
    ref = np.asarray(ref.vis)
    assert np.max(np.abs(out.vis.numpy() - ref)) <= TOL * np.max(np.abs(ref))
    lmn, vflux = ops.extract_direction_and_flux(pc, interop.to_visibility(vis, device=CPU))
    _, jflux = jops.extract_direction_and_flux(jc, vis)
    _close(vflux, jflux)
    args = (lmn, vflux, interop.to_visibility(vis, device=CPU).uvw_lambda)
    for fn in (ops.dft_cpu_looped, ops.dft_gpu_raw_kernel):
        assert torch.equal(fn(*args), ops.dft_kernel(*args))


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_beam_matches_jax(sky, inverse):
    _, _, jc, pc = sky
    beam, _ = _image(freq=FREQ, seed=8)  # the components' channels
    beam_px = np.asarray(beam.pixels).copy()
    beam_px[1, 0, 53, 40] = 0.0  # one zero channel at the first component
    beam = beam.with_pixels(jnp.asarray(beam_px))
    ref = jops.apply_beam_to_skycomponent(jc, beam, inverse=inverse)
    out = ops.apply_beam_to_skycomponent(pc, interop.to_image(beam, device=CPU),
                                         inverse=inverse)
    _close(out.flux, ref.flux)


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_voltage_pattern_matches_jax(inverse):
    im, _ = _image(frame="linear", freq=FREQ, seed=2, complex_=True)
    rng = np.random.default_rng(9)
    jc, pc = _components(im, [(20.2, 30.9), (60.4, 70.6)], rng.uniform(0.5, 2, (2, 3, 4)),
                         frame="linear")
    ref = jops.apply_voltage_pattern_to_skycomponent(jc, im, inverse=inverse)
    out = ops.apply_voltage_pattern_to_skycomponent(pc, interop.to_image(im, device=CPU),
                                                    inverse=inverse)
    _close(out.flux, ref.flux)


def test_selection_and_matching_match_jax(sky):
    im, _, jc, pc = sky
    home = jc.direction[2] + np.array([1e-4, -2e-4])
    ref = jops.filter_skycomponents_by_flux(jc, 0.5, 2.5)
    out = ops.filter_skycomponents_by_flux(pc, 0.5, 2.5)
    _close(out.direction, ref.direction, 0.0)
    _close(out.flux, ref.flux, 0.0)
    _close(ops.find_separation_skycomponents(pc), jops.find_separation_skycomponents(jc))
    assert ops.find_nearest_skycomponent_index(home, pc) == \
        jops.find_nearest_skycomponent_index(home, jc)
    i, sep = ops.find_nearest_skycomponent(home, pc)
    ri, rsep = jops.find_nearest_skycomponent(home, jc)
    assert i == ri and abs(sep - rsep) <= TOL
    shifted = pc.replace(direction=pc.direction + 1e-9)
    jshifted = jc.replace(direction=jc.direction + 1e-9)
    assert ops.find_skycomponent_matches(shifted, pc, 1e-8) == \
        jops.find_skycomponent_matches(jshifted, jc, 1e-8)
    assert ops.find_skycomponent_matches_atomic(shifted, pc, 1e-8) == \
        jops.find_skycomponent_matches_atomic(jshifted, jc, 1e-8)
    ref = jops.select_components_by_separation(home, jc, rmax=5e-3, rmin=1e-4)
    out = ops.select_components_by_separation(home, pc, rmax=5e-3, rmin=1e-4)
    _close(out.direction, ref.direction, 0.0)
    kept, comps = ops.remove_neighbouring_components(pc, 3e-4)
    rkept, rcomps = jops.remove_neighbouring_components(jc, 3e-4)
    assert list(kept) == list(rkept) and comps.ncomp == rcomps.ncomp < pc.ncomp
    idx, seps = ops.select_neighbouring_components(pc, pc.select([0, 3]))
    ridx, rseps = jops.select_neighbouring_components(jc, jc.select(np.asarray([0, 3])))
    assert list(idx) == list(np.asarray(ridx))
    _close(seps, rseps)
    parts = ops.partition_skycomponent_neighbours(pc, pc.direction[[1, 3]])
    rparts = jops.partition_skycomponent_neighbours(jc, jc.direction[[1, 3]])
    assert [p.ncomp for p in parts] == [p.ncomp for p in rparts]
    for p, r in zip(parts, rparts):
        _close(p.direction, r.direction, 0.0)


def _sources_image(deblend_pair=False):
    """A restored image of a few sources (two blended ones with
    ``deblend_pair``), JAX and port."""
    im, _ = _image(freq=FREQ[:2], seed=4)
    im = im.with_pixels(jnp.zeros_like(im.pixels))
    pix = [(30.3, 40.6), (70.2, 65.7), (20.8, 75.1)]
    if deblend_pair:
        pix += [(36.0, 40.9)]
    flux = np.tile(np.array([3.0, 2.0, 1.5, 2.5])[: len(pix), None, None], (1, 2, 1))
    jc, pc = _components(im, pix, flux, freq=FREQ[:2])
    beam = {"bmaj": 0.05, "bmin": 0.04, "bpa": 20.0}
    ref = jops.restore_skycomponent(im, jc, beam)
    return ref, interop.to_image(ref, device=CPU)


@pytest.mark.parametrize("deblend", [False, True])
def test_find_skycomponents_matches_jax(deblend):
    im, pim = _sources_image(deblend_pair=deblend)
    kw = dict(fwhm=1.0, threshold=0.3, npixels=5, deblend=deblend)
    ref = jops.find_skycomponents(im, **kw)
    out = ops.find_skycomponents(pim, **kw)
    assert out.ncomp == ref.ncomp >= 3
    _close(out.direction, ref.direction)
    _close(out.flux, ref.flux)


def test_fit_skycomponents_matches_jax():
    im, pim = _sources_image()
    found = jops.find_skycomponents(im, threshold=0.3)
    pfound = interop.to_skycomponents(found, device=CPU)
    for k in range(found.ncomp):
        ref = jops.fit_skycomponent(im, found.select(np.asarray([k])))
        out = ops.fit_skycomponent(pim, pfound.select([k]))
        _close(out.direction, ref.direction)
        _close(out.flux, ref.flux)
    direction = pfound.direction[0]
    _close(ops.fit_skycomponent(pim, direction).flux,
           jops.fit_skycomponent(im, direction).flux)


@pytest.mark.parametrize("method", ["Nearest", "Lanczos", "Sinc", "PSWF"])
def test_insert_skycomponent_matches_jax(sky, method):
    """Components on the image's channels by interpolation, two on one
    nearest pixel, one outside the image, one near its edge."""
    im, pim, jc, pc = sky
    edge_j, edge_p = _components(im, [(2.2, 93.4)], np.ones((1, 3, 1)))
    cat = jc.replace(direction=np.concatenate([jc.direction[:5], edge_j.direction]),
                     flux=jnp.concatenate([jc.flux[:5], edge_j.flux]),
                     shape_params=jnp.concatenate([jc.shape_params[:5], edge_j.shape_params]))
    pcat = interop.to_skycomponents(cat, device=CPU)
    if method == "Nearest":
        cat, pcat = jc, pc
    ref = jops.insert_skycomponent(im, cat, insert_method=method, support=4)
    out = ops.insert_skycomponent(pim, pcat, insert_method=method, support=4)
    _close(out.pixels, ref.pixels)


def test_voronoi_matches_jax(sky):
    im, pim, jc, pc = sky
    points, labels = ops.voronoi_decomposition(pim, pc.select([0, 2, 3, 4]))
    rpoints, rlabels = jops.voronoi_decomposition(im, jc.select(np.asarray([0, 2, 3, 4])))
    _close(points, rpoints)
    assert np.array_equal(labels, np.asarray(rlabels))
    for a, b in zip(ops.image_voronoi_iter(pim, pc.select([0, 2, 3])),
                    jops.image_voronoi_iter(im, jc.select(np.asarray([0, 2, 3])))):
        _close(a.pixels, b.pixels, 0.0)


def test_spectral_index_and_taylor_terms_match_jax(sky):
    _, _, jc, pc = sky
    _close(ops.fit_skycomponent_spectral_index(pc), jops.fit_skycomponent_spectral_index(jc))
    for nmoment in (1, 2, 3):
        _close(ops.calculate_skycomponent_taylor_terms(pc, nmoment),
               jops.calculate_skycomponent_taylor_terms(jc, nmoment))
        ref = jops.calculate_skycomponent_list_taylor_terms(jc, nmoment)
        out = ops.calculate_skycomponent_list_taylor_terms(pc, nmoment)
        _close(out.flux, ref.flux)
        _close(out.frequency, ref.frequency, 0.0)
        ref = jops.interpolate_skycomponents_frequency(jc, nmoment, 1.01e8)
        out = ops.interpolate_skycomponents_frequency(pc, nmoment, 1.01e8)
        _close(out.flux, ref.flux)


def test_channel_lists_match_jax(sky):
    _, _, jc, pc = sky
    chans = ops.transpose_skycomponents_to_channels(pc)
    rchans = jops.transpose_skycomponents_to_channels(jc)
    assert len(chans) == len(rchans) == 3
    for a, b in zip(chans, rchans):
        _close(a.flux, b.flux, 0.0)
        _close(a.frequency, b.frequency, 0.0)
    back = ops.gather_skycomponents_from_channels(chans)
    assert torch.equal(back.flux, pc.flux) and torch.equal(back.frequency, pc.frequency)


def test_find_skycomponents_frequency_taylor_terms_matches_jax():
    """Sources found on the moment-0 image of three one-channel images,
    fitted per channel and smoothed by a line in frequency. Directions to
    1e-10; fluxes to 1e-8 of their maximum: the two moment-0 images differ
    in their last bits, so the fits start a last bit apart, and
    ``least_squares`` stops within its default tolerance (1e-8) of the
    optimum."""
    ims, pims = [], []
    for c, f in enumerate(FREQ):
        im, _ = _image(freq=[f], seed=6)
        im = im.with_pixels(jnp.zeros_like(im.pixels))
        jc, _ = _components(im, [(30.3, 40.6), (66.2, 61.7)],
                            np.array([[[2.0 + 0.3 * c]], [[1.2 - 0.1 * c]]]), freq=[f])
        ref = jops.restore_skycomponent(im, jc, {"bmaj": 0.05, "bmin": 0.04, "bpa": 20.0})
        ims.append(ref)
        pims.append(interop.to_image(ref, device=CPU))
    kw = dict(nmoment=2, component_threshold=0.3)
    ref = jops.find_skycomponents_frequency_taylor_terms(ims, **kw)
    out = ops.find_skycomponents_frequency_taylor_terms(pims, **kw)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.ncomp == b.ncomp == 2
        _close(a.direction, b.direction)
        _close(a.flux, b.flux, 1e-8)
    assert ops.find_skycomponents_frequency_taylor_terms(pims, nmoment=2) == []


def test_restore_of_spectral_components_interpolates(sky):
    """Components of other channels than the image's restore with their
    flux interpolated onto its channels (the JAX package fails on the
    shapes there); those of the image's channels, and of one, as the JAX
    package restores them."""
    im, pim, jc, pc = sky
    beam = {"bmaj": 0.05, "bmin": 0.04, "bpa": 20.0}
    on_channels = pc.replace(
        flux=flux_on_channels(pc.flux, pc.frequency, torch.as_tensor(IMFREQ), len(IMFREQ)),
        frequency=torch.as_tensor(IMFREQ),
    )
    out = ops.restore_skycomponent(pim, pc, beam)
    _close(out.pixels, ops.restore_skycomponent(pim, on_channels, beam).pixels, 0.0)
    jon = jc.replace(flux=jnp.asarray(on_channels.flux.numpy()), frequency=jnp.asarray(IMFREQ))
    _close(out.pixels, jops.restore_skycomponent(im, jon, beam).pixels)
    one = jc.replace(flux=jc.flux[:, :1], frequency=jc.frequency[:1])
    _close(ops.restore_skycomponent(pim, interop.to_skycomponents(one, device=CPU), beam).pixels,
           jops.restore_skycomponent(im, one, beam).pixels)
