"""The port's ``streamed_ical`` against the JAX package's on the same
store, for three configurations: npol 1 "T" Hogbom (the JAX package's
tests/test_io.py streamed observation) and npol 4 diagonal "T" with
in-stream components that seed 0.8 of the sky, here, and a "TB" cube of
3 channels (``tests/test_torch_streaming_cycle.py``, which keeps each
file's JAX compiles within its time). Each JAX run is made once, in a
module-scope fixture.

The port runs in f32 on the CPU (its plain versions), the JAX package in
f64. Bounds: phase-referenced gains 1e-4; residual and restored peaks
1e-3 relative; the CLEAN components at the same pixels.
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.io import write_visibility as jax_write_visibility
from ska_sdp_func_python_tpu.models import (
    SkyComponents,
    create_gaintable_from_visibility,
)
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable,
    create_image_from_visibility,
    dft_skycomponent_visibility,
)
from ska_sdp_func_python_tpu.streaming import streamed_ical as jax_streamed_ical
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.streaming import streamed_ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
GAIN_TOL, PEAK_RTOL = 1e-4, 1e-3
HOGBOM = dict(algorithm="hogbom", gain=0.2, fractional_threshold=0.01)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _npol1(rng):
    """JAX tests/test_io.py TestStreamedICAL: 10 stations, 8 integrations,
    a 1.5 Jy source at (+9, -6) pixels of 128^2, "T" phases N(0, 0.3)."""
    vis = make_visibility(nants=10, ntimes=8, nchan=1, rmax=300.0, phasecentre=PC)
    model = create_image_from_visibility(vis, npixel=128, oversampling=4.0, nchan=1)
    ra, dec = model.pixel_to_radec(64 + 9, 64 - 6)
    vis = dft_skycomponent_visibility(
        vis, SkyComponents.from_lists([[float(ra), float(dec)]], [[[1.5]]], vis.frequency)
    )
    gt = _simulate_gaintable(create_gaintable_from_visibility(vis, "T"), rng, phase_error=0.3)
    return apply_gaintable(vis, gt), model, None, dict(nmajor=3, niter=200, **HOGBOM)


def _npol4(rng):
    """JAX tests/test_streaming_wide.py's npol-4 diagonal observation (8
    stations, 4 integrations, linear, 64^2), a 2.0 Jy Stokes-I source of
    which components give 1.6 Jy, so CLEAN finds the rest."""
    vis = make_visibility(
        nants=8, ntimes=4, nchan=1, rmax=300.0, phasecentre=PC,
        polarisation_frame="linear",
    )
    model = create_image_from_visibility(
        vis, npixel=64, oversampling=4.0, nchan=1, polarisation_frame="linear"
    )
    ra, dec = model.pixel_to_radec(37, 28)

    def source(flux):
        return SkyComponents.from_lists(
            [[float(ra), float(dec)]], np.asarray([[[flux, 0.0, 0.0, 0.0]]]),
            vis.frequency, polarisation_frame="stokesIQUV",
        )

    vis = dft_skycomponent_visibility(vis, source(2.0))
    gt = _simulate_gaintable(create_gaintable_from_visibility(vis, "T"), rng, phase_error=0.25)
    return apply_gaintable(vis, gt), model, source(1.6), dict(nmajor=2, niter=100, **HOGBOM)


def _tb_cube(rng):
    """A 3-channel cube (8 stations, 4 integrations, 64^2, a 1.5 Jy
    source) corrupted by "T" phases per integration and a "B" table."""
    vis = make_visibility(nants=8, ntimes=4, nchan=3, rmax=300.0, phasecentre=PC)
    model = create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=3)
    ra, dec = model.pixel_to_radec(32 + 5, 32 - 4)
    vis = dft_skycomponent_visibility(
        vis, SkyComponents.from_lists([[float(ra), float(dec)]], [[[1.5]] * 3], vis.frequency)
    )
    gt_t = _simulate_gaintable(create_gaintable_from_visibility(vis, "T"), rng, phase_error=0.2)
    gt_b = _simulate_gaintable(
        create_gaintable_from_visibility(vis, "B"), rng, phase_error=0.2, amplitude_error=0.05
    )
    corrupted = apply_gaintable(apply_gaintable(vis, gt_b), gt_t)
    return corrupted, model, None, dict(calibration_context="TB", nmajor=3, niter=150, **HOGBOM)


CASES = {"npol1_T": _npol1, "npol4_components": _npol4, "cube_TB": _tb_cube}


def run_case(name, root):
    """One configuration's store under ``root``, and the JAX and port runs
    on it: (ref, out)."""
    rng = np.random.default_rng(20260412)
    corrupted, model, comps, kw = CASES[name](rng)
    path = str(root / "obs.svis")
    jax_write_visibility(corrupted, path, chunk_times=2)
    ref = jax_streamed_ical(path, model, PC, chunk_times=2, components=comps, **kw)
    out = streamed_ical(
        path, interop.to_image(model, device=CPU), PC, chunk_times=2,
        components=None if comps is None else interop.to_skycomponents(comps, device=CPU),
        **kw,
    )
    return ref, out


def _referenced(g):
    """The diagonal gains [t, ant, chan, rec] with station 0's phase out."""
    d = np.diagonal(_np(g), axis1=-2, axis2=-1)
    return d * np.exp(-1j * np.angle(d[:, :1]))


def check_gains(ref, out):
    rt = ref.gaintable if isinstance(ref.gaintable, dict) else {"T": ref.gaintable}
    ot = out.gaintable if isinstance(out.gaintable, dict) else {"T": out.gaintable}
    assert sorted(rt) == sorted(ot)
    for term in rt:
        a, b = _referenced(rt[term].gain), _referenced(ot[term].gain)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < GAIN_TOL, (term, np.max(np.abs(a - b)))
        np.testing.assert_array_equal(_np(ot[term].time), np.asarray(rt[term].time))
        np.testing.assert_array_equal(_np(ot[term].interval), np.asarray(rt[term].interval))


def check_peaks(ref, out):
    for field, op in (("residual", np.abs), ("restored", lambda x: x)):
        a = float(np.max(op(_np(getattr(ref, field).pixels))))
        b = float(np.max(op(_np(getattr(out, field).pixels))))
        assert abs(a - b) <= PEAK_RTOL * abs(a), (field, a, b)
    assert float(np.max(np.abs(_np(ref.residual.pixels)))) < 0.3


def check_components(ref, out):
    a, b = _np(ref.model.pixels), _np(out.model.pixels)
    assert a.shape == b.shape
    assert np.count_nonzero(a) > 0
    np.testing.assert_array_equal(np.nonzero(a), np.nonzero(b))


@pytest.fixture(scope="module", params=["npol1_T", "npol4_components"])
def runs(request, tmp_path_factory):
    return run_case(request.param, tmp_path_factory.mktemp("streamed"))


def test_gains_match_jax(runs):
    check_gains(*runs)


def test_peaks_match_jax(runs):
    check_peaks(*runs)


def test_components_match_jax(runs):
    check_components(*runs)
