"""Parity of the port's polarisation frames with the JAX package's, in f64
on the same seeded inputs: ``convert_pol_frame`` for every (source,
destination) pair of the frame table, the visibility conversions,
component polarisation in the DFT and its inverse, and the frame
conversion of the imaging cycles.

Tolerances: 1e-12 absolute for the conversions (the same 4x4 matrices,
summed in another order); 1e-10 for the DFT and its inverse (the
calibration tests' bound for the same f64 sums); flags and frames
exactly; images within 1e-5 of their maximum (f32 gridding).
"""

import itertools

import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.models import SkyComponents as JaxSkyComponents
from ska_sdp_func_python_tpu.models import polarisation as jax_pol
from ska_sdp_func_python_tpu.ops import (
    dft_skycomponent_visibility as jax_dft,
    idft_visibility_skycomponent as jax_idft,
)
from ska_sdp_func_python_tpu.ops import visibility_ops as jax_vops
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models import create_visibility_from_arrays, polarisation
from ska_sdp_func_python_torch.ops import (
    dft_skycomponent_visibility,
    idft_visibility_skycomponent,
)
from ska_sdp_func_python_torch.ops import visibility_ops

from simul import make_visibility

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
FRAMES = [
    "circular", "circularnp", "linear", "linearnp",
    "stokesIQUV", "stokesIV", "stokesIQ", "stokesI",
]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, ref, atol=1e-12):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


def _data(frame, seed, shape=(3, 5, 2)):
    """Complex f64 data [..., npol] of ``frame``."""
    rng = np.random.default_rng(seed)
    n = jax_pol.npol(frame)
    return rng.normal(size=shape + (n,)) + 1j * rng.normal(size=shape + (n,))


@pytest.mark.parametrize("src,dst", list(itertools.product(FRAMES, FRAMES)))
def test_convert_pol_frame_matches_jax(src, dst):
    """Every pair: the same values, or the same refusal (ValueError)."""
    data = _data(src, 3)
    try:
        ref = np.asarray(jax_pol.convert_pol_frame(data, src, dst, polaxis=-1))
    except ValueError:
        with pytest.raises(ValueError):
            polarisation.convert_pol_frame(torch.as_tensor(data), src, dst)
        return
    out = polarisation.convert_pol_frame(torch.as_tensor(data), src, dst)
    assert out.shape == ref.shape
    _close(out, ref)
    # along another axis
    moved = np.moveaxis(data, -1, 1)
    ref1 = np.asarray(jax_pol.convert_pol_frame(moved, src, dst, polaxis=1))
    _close(polarisation.convert_pol_frame(torch.as_tensor(moved), src, dst, polaxis=1), ref1)


def test_frame_helpers_match_jax():
    for f in FRAMES:
        assert polarisation.pol_names(f) == jax_pol.pol_names(f)
        assert polarisation.npol(f) == jax_pol.npol(f)
    for f in ("stokesI", "stokesIQUV", "stokesIQ", "stokesIV"):
        assert polarisation.correlate_polarisation(f) == jax_pol.correlate_polarisation(f).name
    for a, b in itertools.product(FRAMES, FRAMES):
        assert polarisation.congruent_polarisation(a, b) == jax_pol.congruent_polarisation(a, b)
    with pytest.raises(ValueError):
        polarisation.npol("stokesQ")
    # real data (image pixels) converts to the complex dtype of its precision
    real = np.random.default_rng(4).normal(size=(2, 4, 3, 3))
    ref = np.asarray(jax_pol.convert_pol_frame(real, "stokesIQUV", "linear", polaxis=1))
    out = polarisation.convert_pol_frame(torch.as_tensor(real), "stokesIQUV", "linear", polaxis=1)
    assert out.dtype == torch.complex128
    _close(out, ref)


def _vis(frame, seed=8):
    """A small Visibility of ``frame`` with seeded values, weights and
    flags, for both packages."""
    rng = np.random.default_rng(seed)
    vis = make_visibility(nants=5, ntimes=2, nchan=3, polarisation_frame=frame)
    shape = vis.vis.shape
    vis = vis.replace(
        vis=rng.normal(size=shape) + 1j * rng.normal(size=shape),
        weight=rng.uniform(0.5, 2.0, shape),
        imaging_weight=rng.uniform(0.5, 2.0, shape),
        flags=(rng.uniform(size=shape) < 0.15).astype(np.int32),
    )
    return vis, interop.to_visibility(vis, device=CPU)


def _same_vis(out, ref):
    assert out.polarisation_frame == ref.polarisation_frame
    for name in ("vis", "weight", "imaging_weight"):
        _close(getattr(out, name), getattr(ref, name))
    np.testing.assert_array_equal(_np(out.flags), _np(ref.flags))


@pytest.mark.parametrize("frame", ["linear", "circular", "linearnp", "stokesI"])
def test_convert_visibility_to_stokes_matches_jax(frame):
    vis, pvis = _vis(frame)
    _same_vis(
        visibility_ops.convert_visibility_to_stokes(pvis),
        jax_vops.convert_visibility_to_stokes(vis),
    )


@pytest.mark.parametrize("frame", ["linear", "circular", "linearnp", "circularnp"])
def test_convert_visibility_to_stokesI_matches_jax(frame):
    vis, pvis = _vis(frame)
    _same_vis(
        visibility_ops.convert_visibility_to_stokesI(pvis),
        jax_vops.convert_visibility_to_stokesI(vis),
    )


@pytest.mark.parametrize("frame", ["linear", "circular", "linearnp", "stokesIQUV"])
def test_convert_visibility_stokesI_to_polframe_matches_jax(frame):
    vis, pvis = _vis("stokesI")
    _same_vis(
        visibility_ops.convert_visibility_stokesI_to_polframe(pvis, frame),
        jax_vops.convert_visibility_stokesI_to_polframe(vis, frame),
    )


@pytest.mark.parametrize("npol", [1, 2, 4])
def test_expand_polarizations_matches_jax(npol):
    data = _data({1: "stokesI", 2: "linearnp", 4: "linear"}[npol], 9)
    ref = np.asarray(jax_vops.expand_polarizations(data))
    _close(visibility_ops.expand_polarizations(torch.as_tensor(data)), ref, atol=0.0)


@pytest.mark.parametrize(
    "vis_frame,comp_frame",
    [("linear", "stokesIQUV"), ("circular", "stokesIQUV"), ("linearnp", "stokesIQUV"),
     ("linear", "stokesI"), ("circularnp", "stokesIV")],
)
def test_component_polarisation_matches_jax(vis_frame, comp_frame):
    """Fluxes go from the components' frame to the visibilities' in the
    DFT and back in its inverse."""
    vis = make_visibility(nants=6, ntimes=2, nchan=2, rmax=300.0, phasecentre=PC,
                          polarisation_frame=vis_frame)
    rng = np.random.default_rng(12)
    n = jax_pol.npol(comp_frame)
    flux = np.abs(rng.normal(1.0, 0.3, (2, 2, n)))
    dirs = [[PC[0] + 0.01, PC[1] - 0.02], [PC[0] - 0.015, PC[1] + 0.01]]
    comps = JaxSkyComponents.from_lists(dirs, flux, vis.frequency, polarisation_frame=comp_frame)
    ref = jax_dft(vis, comps)
    pcomps = interop.to_skycomponents(comps, device=CPU)
    out = dft_skycomponent_visibility(interop.to_visibility(vis, device=CPU), pcomps)
    _close(out.vis, ref.vis, atol=1e-10)
    rflux, rw = jax_idft(ref, comps)
    oflux, ow = idft_visibility_skycomponent(interop.to_visibility(ref, device=CPU), pcomps)
    assert oflux.polarisation_frame == comp_frame
    _close(oflux.flux, rflux.flux, atol=1e-10)
    _close(ow, rw, atol=0.0)


def test_constructors_take_polarised_frames():
    """The constructors size the polarisation axis from the frame; an
    image from polarised visibilities takes their frame, as in the JAX
    package."""
    from ska_sdp_func_python_tpu.ops import create_image_from_visibility as jax_image
    from ska_sdp_func_python_torch.ops import create_image_from_visibility

    for frame in FRAMES:
        vis = make_visibility(nants=4, ntimes=2, nchan=1, polarisation_frame=frame)
        pvis = create_visibility_from_arrays(
            uvw=np.asarray(vis.uvw), time=np.asarray(vis.time),
            frequency=np.asarray(vis.frequency), antenna1=np.asarray(vis.antenna1),
            antenna2=np.asarray(vis.antenna2), phasecentre=PC,
            polarisation_frame=frame, device=CPU,
        )
        assert pvis.vis.shape == vis.vis.shape
        im = create_image_from_visibility(pvis, npixel=16)
        ref = jax_image(vis, npixel=16)
        assert im.polarisation_frame == ref.polarisation_frame == frame
        assert im.pixels.shape == ref.pixels.shape


@pytest.mark.parametrize("model_frame", ["stokesIQUV", "stokesI"])
def test_continuum_imaging_converts_frames_as_jax(model_frame):
    """Linear visibilities imaged to a Stokes model: the fused workspace
    converts the visibilities and the components' to the model's frame
    (and, to stokesI, takes the first polarisation's weights), as the JAX
    package's fused cycle does; the composed cycle converts in
    ``invert_visibility`` and ``predict_visibility``."""
    from ska_sdp_func_python_tpu.ops import create_image_from_visibility as jax_image
    from ska_sdp_func_python_tpu.pipeline import continuum_imaging as jax_continuum
    from ska_sdp_func_python_torch.pipeline import continuum_imaging

    vis = make_visibility(nants=8, ntimes=2, nchan=1, rmax=300.0, phasecentre=PC,
                          polarisation_frame="linear")
    model = jax_image(vis, npixel=64, oversampling=4.0, nchan=1,
                      polarisation_frame=model_frame)
    ra, dec = model.pixel_to_radec(32 + 6, 32 - 4)
    comps = JaxSkyComponents.from_lists([[float(ra), float(dec)]], [[[1.5, 0.2, 0.1, 0.05]]],
                                        vis.frequency, polarisation_frame="stokesIQUV")
    vis = jax_dft(vis, comps)
    kw = dict(nmajor=1, context="ng", algorithm="hogbom", niter=100, gain=0.2,
              fractional_threshold=0.01)
    ref = jax_continuum(vis, model, use_plan=True, fused=True, **kw)
    pvis, pmodel = interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU)
    for fused in (True, False):
        out = continuum_imaging(pvis, pmodel, fused=fused, **kw)
        assert out[1].polarisation_frame == model_frame
        for o, r in zip(out[:2], ref[:2]):
            r = np.asarray(r.pixels)
            assert o.pixels.shape == r.shape
            assert np.max(np.abs(_np(o.pixels) - r)) <= 1e-5 * np.abs(r).max()
