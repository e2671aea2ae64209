"""The sky model carried across, the beamformer utilities and the
parsets of the port against the JAX package, on the same seeded numpy
inputs (x64 on the CPU). The sky model's predict and invert are in
tests/test_torch_skymodel_imaging.py and the parset-driven gain
calibration in tests/test_torch_gaincal_engine.py: files of few tests,
which ``pytest -n 6 --dist loadfile`` starts last.

Tolerances: f64 to 1e-10 of the maximum (visibilities, images, gains);
parsets, shapes, Jones types and frequencies identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu import ops as jops
from ska_sdp_func_python_tpu.models import (
    SkyComponents as JaxComponents,
    SkyModel as JaxSkyModel,
    create_gaintable_from_visibility as jax_create_gaintable,
)
from ska_sdp_func_python_torch import interop, ops
from ska_sdp_func_python_torch.models import SkyModel

from simul import make_visibility

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
TOL = 1e-10


def _close(out, ref, tol=TOL):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(1.0, float(np.max(np.abs(ref))))


@pytest.fixture(scope="module")
def obs():
    """A small observation (two channels), a 64^2 model with a few
    pixels and two components with a flux on each channel, a mask, a "T" gaintable of
    random phases, as JAX and port objects."""
    rng = np.random.default_rng(11)
    vis = make_visibility(nants=6, ntimes=3, nchan=2, rmax=300.0, phasecentre=PC)
    model = jops.create_image_from_visibility(vis, npixel=64, oversampling=4.0)
    px = np.zeros(model.pixels.shape)
    px[:, 0, 30, 36] = [1.5, 1.2]
    px[:, 0, 40, 22] = [0.7, 0.9]
    model = model.with_pixels(jnp.asarray(px))
    dirs = [[float(a) for a in model.pixel_to_radec(x, y)] for x, y in ((20.3, 25.6), (44.1, 37.9))]
    comps = JaxComponents.from_lists(dirs, rng.uniform(0.5, 2.0, (2, 2, 1)), vis.frequency)
    mask = np.ones((64, 64))
    mask[:, :21] = 0.0  # masks the second pixel and the first component
    gt = jax_create_gaintable(vis, jones_type="T")
    gt = gt.replace(gain=jnp.asarray(np.exp(1j * rng.normal(0, 0.3, gt.gain.shape[:3])))[..., None, None])
    sm = JaxSkyModel(image=model, components=comps, gaintable=gt, mask=jnp.asarray(mask))
    return vis, sm, interop.to_visibility(vis, device=CPU), interop.to_skymodel(sm, device=CPU)


def _pb_pair():
    """The same per-integration primary beam for both packages: a Gaussian
    whose width follows the integration's time."""
    def beam(t, shape):
        ny, nx = shape[-2:]
        yy, xx = np.mgrid[0:ny, 0:nx]
        sigma = 20.0 + 1e-3 * abs(t)
        g = np.exp(-((xx - nx // 2) ** 2 + (yy - ny // 2) ** 2) / (2 * sigma**2))
        return np.broadcast_to(g, shape).copy()

    def jax_pb(vslice, image):
        return image.with_pixels(jnp.asarray(beam(float(vslice.time[0]), image.pixels.shape)))

    def port_pb(vslice, image):
        return image.replace(pixels=torch.as_tensor(beam(float(vslice.time[0]), image.pixels.shape)))

    return jax_pb, port_pb


def test_skymodel_carried_both_ways(obs):
    _, sm, _, psm = obs
    assert isinstance(psm, SkyModel) and psm.fixed is False
    _close(psm.image.pixels, sm.image.pixels, 0.0)
    _close(psm.components.flux, sm.components.flux, 0.0)
    _close(psm.components.frequency, sm.components.frequency, 0.0)
    _close(psm.gaintable.gain, sm.gaintable.gain, 0.0)
    _close(psm.mask, sm.mask, 0.0)
    fields = interop.to_numpy(psm)
    back = JaxComponents(**fields["components"])
    _close(back.flux, sm.components.flux, 0.0)
    assert back.polarisation_frame == sm.components.polarisation_frame
    assert fields["image"]["cellsize"] == sm.image.cellsize


def _bandpass(nchan=16, nants=4, seed=0):
    rng = np.random.default_rng(seed)
    vis = make_visibility(nants=nants, ntimes=2, nchan=nchan)
    gt = jax_create_gaintable(vis, jones_type="B")
    f = np.asarray(gt.frequency)
    x = (f - f.mean()) / max(f.max() - f.min(), 1.0)
    spec = 1.0 + 0.3 * x + 0.2 * x**2 + 1j * (0.1 * x - 0.05 * x**2)
    noise = 0.01 * (rng.normal(size=gt.gain.shape) + 1j * rng.normal(size=gt.gain.shape))
    gt = gt.replace(gain=jnp.asarray(np.asarray(gt.gain) * spec[None, None, :, None, None] + noise))
    return gt, interop.to_gaintable(gt, device=CPU)


def test_beamformer_frequencies_and_jones_match_jax():
    gt, pgt = _bandpass()
    for array in ("LOW", "MID", "other"):
        np.testing.assert_array_equal(ops.set_beamformer_frequencies(pgt, array),
                                      jops.set_beamformer_frequencies(gt, array))
    one, pone = _bandpass(nchan=1, seed=1)
    for elementwise in (False, True):
        for a, b, pa, pb in ((gt, gt, pgt, pgt), (gt, one, pgt, pone), (one, gt, pone, pgt)):
            ref = jops.multiply_gaintable_jones(a, b, elementwise=elementwise)
            out = ops.multiply_gaintable_jones(pa, pb, elementwise=elementwise)
            _close(out.gain, ref.gain)
            _close(out.weight, ref.weight, 0.0)
            _close(out.frequency, ref.frequency, 0.0)
            assert out.jones_type == ref.jones_type
    with pytest.raises(ValueError, match="delays"):
        ops.multiply_gaintable_jones(pgt.replace(jones_type="K"), pgt)


@pytest.mark.parametrize("centre", [False, True])
def test_expand_delay_phase_matches_jax(centre):
    vis = make_visibility(nants=4, ntimes=2, nchan=1)
    gt = jax_create_gaintable(vis, jones_type="T").replace(jones_type="K")
    rng = np.random.default_rng(4)
    gt = gt.replace(gain=jnp.asarray(np.exp(1j * rng.uniform(-1, 1, gt.gain.shape))))
    freqs = np.linspace(0.9e8, 1.2e8, 5)
    ref = jops.expand_delay_phase(gt, freqs, reference_to_centre=centre)
    out = ops.expand_delay_phase(interop.to_gaintable(gt, device=CPU), freqs,
                                 reference_to_centre=centre)
    _close(out.gain, ref.gain)
    _close(out.residual, ref.residual, 0.0)
    assert out.jones_type == ref.jones_type == "B"


@pytest.mark.parametrize("alg,edges,polydeg", [
    ("polyfit", None, None), ("polyfit", [6, 11], 2), ("interp", None, None),
    ("cubicspl", None, None),
])
def test_resample_bandpass_matches_jax(alg, edges, polydeg):
    gt, pgt = _bandpass(seed=2)
    freqs = jops.set_beamformer_frequencies(gt, "LOW")
    ref = jops.resample_bandpass(freqs, gt, alg=alg, edges=edges, polydeg=polydeg)
    out = ops.resample_bandpass(freqs, pgt, alg=alg, edges=edges, polydeg=polydeg)
    _close(out.gain, ref.gain)
    _close(out.frequency, ref.frequency, 0.0)
    with pytest.raises(ValueError, match="unknown resampler"):
        ops.resample_bandpass(freqs, pgt, alg="nearest")


def test_interpolator_classes_match_jax():
    rng = np.random.default_rng(8)
    f_in = np.linspace(1.0, 2.0, 9)
    vals = rng.normal(size=9) + 1j * rng.normal(size=9)
    f_out = np.linspace(0.9, 2.1, 14)
    for name in ("NumpyLinearInterpolator", "ScipySplineInterpolator"):
        _close(getattr(ops, name)().interp(f_in, vals, f_out),
               getattr(jops, name)().interp(f_in, vals, f_out))
    out, ref = ops.PolynomialInterpolator(), jops.PolynomialInterpolator()
    for p in (out, ref):
        p.set_edges([4], 9)
        p.set_polydeg(2)
    _close(out.interp(f_in, vals, f_out), ref.interp(f_in, vals, f_out))


def test_parsets_match_jax(obs):
    vis, _, pvis, _ = obs
    for context, glob in (("TG", True), ("TGB", False), ("B", True)):
        ref = jops.create_parset_from_context(vis, context, global_solution=glob)
        out = ops.create_parset_from_context(pvis, context, global_solution=glob)
        assert [p.entries for p in out] == [p.entries for p in ref]
    p = ops.Parset()
    p.add("gaincal.solint", "2")
    assert p.get("gaincal.solint") == "2" and p.get("missing", "x") == "x"
