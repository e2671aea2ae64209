"""Parity of the port's fused ICAL slice with the JAX package's fused
``ical``, and of the thin modules the slice simulates with (DFT, gain
apply, uniform weighting), on the same seeded small observation.

Tolerances, the JAX package's own fused-vs-composed bounds
(tests/test_composite.py): phase-referenced gains 1e-4, peak residual 1e-3
relative, restored peak 0.05. The DFT, gain apply and uniform weighting
run in f64 on both sides and agree to 1e-10.
"""

import numpy as np
import jax.numpy as jnp
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
    weight_visibility as jax_weight_visibility,
)
from ska_sdp_func_python_tpu.pipeline import ical as jax_ical
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.dft import dft_skycomponent_visibility
from ska_sdp_func_python_torch.ops.gain_ops import apply_gaintable
from ska_sdp_func_python_torch.ops.imaging import create_image_from_visibility
from ska_sdp_func_python_torch.ops.weighting import weight_visibility
from ska_sdp_func_python_torch.pipeline import ical

from simul import make_visibility

PC = (0.0, np.deg2rad(-35.0))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def obs():
    rng = np.random.default_rng(1805550721)
    vis = make_visibility(nants=10, ntimes=3, nchan=1, rmax=300.0, phasecentre=PC)
    model = jax_create_image_from_visibility(
        vis, npixel=128, oversampling=4.0, nchan=1
    )
    ra, dec = model.pixel_to_radec(64 + 8, 64 - 5)
    comps = SkyComponents.from_lists(
        [[float(ra), float(dec)]], [[[2.0]]], vis.frequency
    )
    gt = create_gaintable_from_visibility(vis, jones_type="T")
    phases = rng.normal(0, 0.3, gt.gain.shape[:3])
    gt = gt.replace(gain=jnp.asarray(np.exp(1j * phases))[..., None, None])
    return vis, model, comps, gt


def test_dft_and_gain_apply_match_jax(obs):
    vis, _, comps, gt = obs
    jvis = jax_dft(vis, comps)
    pvis = dft_skycomponent_visibility(
        interop.to_visibility(vis, device=CPU), interop.to_skycomponents(comps, device=CPU)
    )
    np.testing.assert_allclose(
        pvis.vis.numpy(), np.asarray(jvis.vis), rtol=0, atol=1e-10
    )
    jcor = jax_apply_gaintable(jvis, gt)
    pcor = apply_gaintable(pvis, interop.to_gaintable(gt, device=CPU))
    np.testing.assert_allclose(
        pcor.vis.numpy(), np.asarray(jcor.vis), rtol=0, atol=1e-10
    )


def test_weight_visibility_matches_jax(obs):
    vis, model, _, _ = obs
    ref = jax_weight_visibility(vis, model, weighting="uniform")
    out = weight_visibility(
        interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU), weighting="uniform"
    )
    np.testing.assert_allclose(
        out.imaging_weight.numpy(), np.asarray(ref.imaging_weight),
        rtol=0, atol=1e-10,
    )


def test_create_image_from_visibility_matches_jax(obs):
    vis, model, _, _ = obs
    pmodel = create_image_from_visibility(
        interop.to_visibility(vis, device=CPU), npixel=128, oversampling=4.0, nchan=1
    )
    assert pmodel.cellsize == pytest.approx(model.cellsize, rel=1e-12)
    assert pmodel.pixels.shape == tuple(model.pixels.shape)


def _ical_both(obs, **kw):
    """The JAX fused ical and the port's on the same corrupted
    observation; returns both results."""
    vis, model, comps, gt = obs
    corrupted = jax_apply_gaintable(jax_dft(vis, comps), gt)
    kw = dict(
        nmajor=3,
        calibration_context="T",
        context="ng",
        niter=200,
        gain=0.2,
        fractional_threshold=0.01,
        **kw,
    )
    ref = jax_ical(corrupted, model, use_plan=True, fused=True, **kw)
    out = ical(
        interop.to_visibility(corrupted, device=CPU),
        interop.to_image(model, device=CPU),
        **kw,
    )
    return ref, out


def _assert_slice_bounds(ref, out):
    """The slice bounds: the JAX package's fused-vs-composed ones."""
    (d0, r0, s0, g0), (d1, r1, s1, g1) = ref, out
    ga = np.asarray(g0["T"].gain)[..., 0, 0]
    gb = g1["T"].gain.numpy()[..., 0, 0]
    pa = ga * np.exp(-1j * np.angle(ga[:, :1]))
    pb = gb * np.exp(-1j * np.angle(gb[:, :1]))
    assert np.max(np.abs(pa - pb)) < 1e-4
    r0p = float(jnp.max(jnp.abs(r0.pixels)))
    r1p = float(r1.pixels.abs().max())
    assert abs(r0p - r1p) < 1e-3 * max(r0p, 1e-6)
    peak0 = float(jnp.max(s0.pixels))
    peak1 = float(s1.pixels.max())
    assert abs(peak0 - peak1) < 0.05
    assert abs(peak1 - 2.0) < 0.2


def test_ical_fused_matches_jax(obs):
    _assert_slice_bounds(*_ical_both(obs, algorithm="hogbom"))


def test_ical_fused_msclean_default_matches_jax(obs):
    """With no algorithm= both run msclean, the default deconvolver."""
    _assert_slice_bounds(*_ical_both(obs, scales=[0, 3, 10]))


@pytest.mark.parametrize("algorithm", ["hogbom", "msclean"])
def test_ical_fused_windowed_matches_jax(obs, algorithm):
    """window_shape="quarter" in the fused cycle: the component peaks stay
    in the window (msclean's scale blobs may spill past its edge, as in
    the JAX package) and the result matches the JAX fused cycle."""
    ref, out = _ical_both(obs, algorithm=algorithm, window_shape="quarter")
    _assert_slice_bounds(ref, out)
    cpix = out[0].pixels.numpy()[0, 0]
    n = cpix.shape[0]
    outside = cpix.copy()
    outside[n // 4 + 1 : 3 * (n // 4), n // 4 + 1 : 3 * (n // 4)] = 0
    assert np.max(np.abs(outside)) < np.max(np.abs(cpix))
    if algorithm == "hogbom":
        assert np.max(np.abs(outside)) == 0.0
    np.testing.assert_allclose(
        cpix, np.asarray(ref[0].pixels)[0, 0], rtol=0, atol=1e-3 * np.abs(cpix).max()
    )
