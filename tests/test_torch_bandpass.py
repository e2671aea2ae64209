"""Parity of the port's fused self-cal with a bandpass ("B") term, on the
JAX package's fused-bandpass test cube (tests/test_bandpass.py: 10
stations, 3 integrations, 4 channels, 64^2, a flat 2.0 Jy source
corrupted by a per-channel "B" table of phase N(0, 0.25) and amplitude
lognormal(0, 0.1)), against the JAX package's fused cycle and against
the port's composed cycle.

Tolerances: the slice bounds (phase-referenced gains 1e-4, peak residual
1e-3 relative, restored peak 0.05), and the JAX package's own
fused-vs-composed bandpass bounds: B phases (referenced to antenna 0,
mean amplitude 1) within 2e-2 per channel, residual peaks within 2e-2.
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.models import (
    SkyComponents,
    create_gaintable_from_visibility,
)
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable as jax_apply_gaintable,
    create_image_from_visibility as jax_create_image_from_visibility,
    dft_skycomponent_visibility as jax_dft,
)
from ska_sdp_func_python_tpu.pipeline import ical as jax_ical
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.pipeline import ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
NCHAN = 4
KW = dict(
    nmajor=4, context="ng", algorithm="hogbom", niter=300, gain=0.2,
    fractional_threshold=0.01,
)


@pytest.fixture(scope="module")
def cube():
    rng = np.random.default_rng(1805550721)
    vis = make_visibility(nants=10, ntimes=3, nchan=NCHAN, rmax=300.0, phasecentre=PC)
    model = jax_create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=NCHAN)
    ra, dec = model.pixel_to_radec(32 + 7, 32 - 5)
    comps = SkyComponents.from_lists(
        [[float(ra), float(dec)]], 2.0 * np.ones((1, NCHAN, 1)), vis.frequency
    )
    vis = jax_dft(vis, comps)
    gt_true = _simulate_gaintable(
        create_gaintable_from_visibility(vis, jones_type="B", timeslice=1e5),
        rng, phase_error=0.25, amplitude_error=0.1,
    )
    corrupted = jax_apply_gaintable(vis, gt_true)
    return (
        corrupted, model, gt_true,
        interop.to_visibility(corrupted, device=CPU), interop.to_image(model, device=CPU),
    )


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _ref_phase(g):
    """Phase-referenced to antenna 0, mean amplitude 1 (the solver's gauge
    freedoms)."""
    g = _np(g)
    g = g * np.exp(-1j * np.angle(g[:, :1]))
    return g / np.mean(np.abs(g))


def _b_apart(ga, gb):
    return max(
        float(np.max(np.abs(_ref_phase(ga[..., c, 0, 0]) - _ref_phase(gb[..., c, 0, 0]))))
        for c in range(NCHAN)
    )


def _peak(im):
    return float(np.abs(_np(im.pixels)).max())


@pytest.fixture(scope="module")
def port_fused(cube):
    """The port's fused "B" and "TB" ical."""
    _, _, _, pvis, pmodel = cube
    return {c: ical(pvis, pmodel, calibration_context=c, **KW) for c in ("B", "TB")}


def test_fused_tb_matches_jax_fused(cube, port_fused):
    corrupted, model, gt_true, _, _ = cube
    ref = jax_ical(corrupted, model, calibration_context="TB", use_plan=True,
                   fused=True, **KW)
    out = port_fused["TB"]
    assert out[3]["B"].gain.shape[2] == NCHAN
    np.testing.assert_array_equal(_np(out[3]["B"].frequency), _np(ref[3]["B"].frequency))
    for t in "TB":
        a, b = _np(ref[3][t].gain)[..., 0, 0], _np(out[3][t].gain)[..., 0, 0]
        pa = a * np.exp(-1j * np.angle(a[:, :1]))
        pb = b * np.exp(-1j * np.angle(b[:, :1]))
        assert np.max(np.abs(pa - pb)) < 1e-4, t
    assert _b_apart(ref[3]["B"].gain, out[3]["B"].gain) < 2e-2
    r0, r1 = _peak(ref[1]), _peak(out[1])
    assert abs(r0 - r1) < 1e-3 * r0
    assert abs(float(_np(ref[2].pixels).max()) - float(out[2].pixels.max())) < 0.05
    assert _b_apart(gt_true.gain, out[3]["B"].gain) < 0.5


@pytest.mark.parametrize("context", ["B", "TB"])
def test_fused_bandpass_matches_composed(cube, port_fused, context):
    """The factor leg of a "B" chain (one payload row per channel) against
    the composed cycle's apply_gaintable."""
    _, _, _, pvis, pmodel = cube
    ref = ical(pvis, pmodel, calibration_context=context, fused=False, **KW)
    out = port_fused[context]
    assert _b_apart(ref[3]["B"].gain, out[3]["B"].gain) < 2e-2
    assert abs(_peak(ref[1]) - _peak(out[1])) < 2e-2
    assert _peak(out[1]) < 0.25
