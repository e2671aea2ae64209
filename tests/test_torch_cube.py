"""Parity of the port's image cubes with the JAX package's: multi-channel
images and plans, per-channel invert and predict, and the fused cube
cycle of ``continuum_imaging`` and ``ical`` (Hogbom and MSMFS).

Tolerances: plan geometry and permutations identical; invert and predict
1e-5 of the image or visibility maximum (f32 gridding, see
``test_torch_gridding.py``); the fused cube cycles at the JAX package's
own fused-cube geometries (``tests/test_composite.py``): the same
component positions, the residual within 1e-4 of its maximum, and
phase-referenced gains within 1e-4.
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
)
from ska_sdp_func_python_tpu.ops.imaging import (
    invert_visibility as jax_invert_visibility,
    make_visibility_plan as jax_make_visibility_plan,
    predict_visibility as jax_predict_visibility,
)
from ska_sdp_func_python_tpu.pipeline import (
    continuum_imaging as jax_continuum_imaging,
    ical as jax_ical,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.imaging import (
    create_image_from_visibility,
    invert_visibility,
    make_visibility_plan,
    predict_visibility,
)
from ska_sdp_func_python_torch.pipeline import continuum_imaging, ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))


def _spectral_obs(nchan, nants, npixel, offset, alpha=-0.7, bandwidth=4e6):
    """A point source with a spectral index about the middle channel, the
    JAX package's fused-cube geometry (tests/test_composite.py)."""
    vis = make_visibility(
        nants=nants, ntimes=3, nchan=nchan, frequency0=1.0e8,
        channel_bandwidth=bandwidth, rmax=300.0, phasecentre=PC,
    )
    model = jax_create_image_from_visibility(
        vis, npixel=npixel, oversampling=4.0, nchan=nchan
    )
    ra, dec = model.pixel_to_radec(npixel // 2 + offset[0], npixel // 2 + offset[1])
    f0 = np.asarray(vis.frequency)
    flux = (2.0 * (f0 / f0[nchan // 2]) ** alpha)[None, :, None]
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], flux, vis.frequency)
    return jax_dft(vis, comps), model


@pytest.fixture(scope="module")
def cube():
    vis, model = _spectral_obs(4, 10, 64, (5, -3))
    jplan = jax_make_visibility_plan(vis, model, context="ng")
    pvis = interop.to_visibility(vis, device=CPU)
    pmodel = interop.to_image(model, device=CPU)
    return vis, model, jplan, pvis, pmodel, make_visibility_plan(pvis, pmodel)


def test_cube_image_matches_jax(cube):
    vis, model, _, pvis, _, _ = cube
    for nchan in (4, 2, 1):
        ref = jax_create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=nchan)
        out = create_image_from_visibility(pvis, npixel=64, oversampling=4.0, nchan=nchan)
        assert out.pixels.shape == tuple(ref.pixels.shape)
        assert out.cellsize == pytest.approx(ref.cellsize, rel=1e-12)
        np.testing.assert_allclose(out.frequency, np.asarray(ref.frequency), rtol=1e-15)
        np.testing.assert_allclose(
            out.channel_bandwidth, np.asarray(ref.channel_bandwidth), rtol=1e-15
        )


def test_cube_plans_match_jax(cube):
    _, _, jplan, pvis, pmodel, pplan = cube
    assert pplan.nchan == jplan.nchan == 4 and not pplan.mfs
    for jp, pp in zip(jplan.plans, pplan.plans):
        assert (pp.npad, pp.nw, pp.gp.tile, pp.gp.n) == (jp.npad, jp.nw, jp.gp.tile, jp.gp.n)
        perm = interop.permutation_from_backsort_keys(jp.gp.geo[3, : jp.gp.n])
        np.testing.assert_array_equal(pp.gp.perm.numpy(), perm)
    # channels differ in frequency, so their plans order differently
    assert not torch.equal(pplan.plans[0].gp.perm, pplan.plans[3].gp.perm)
    # an image of one channel: one MFS plan over all four channels
    vis, model = cube[0], cube[1]
    jmodel = jax_create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=1)
    jmfs = jax_make_visibility_plan(vis, jmodel, context="ng")
    pmfs = make_visibility_plan(pvis, interop.to_image(jmodel, device=CPU))
    assert pmfs.mfs and jmfs.mfs and pmfs.nchan == 1 and pmfs.stack.perm.shape == (1, 4 * 3 * 45)
    perm = interop.permutation_from_backsort_keys(jmfs.plans[0].gp.geo[3, : jmfs.plans[0].gp.n])
    np.testing.assert_array_equal(pmfs.plans[0].gp.perm.numpy(), perm)


def test_cube_invert_and_predict_match_jax(cube):
    vis, model, jplan, pvis, pmodel, pplan = cube
    for dopsf in (False, True):
        ref, rsw = jax_invert_visibility(vis, model, dopsf=dopsf, plan=jplan)
        out, sw = invert_visibility(pvis, pmodel, dopsf=dopsf, plan=pplan)
        ref = np.asarray(ref.pixels)
        assert out.pixels.shape == ref.shape == (4, 1, 64, 64)
        assert np.max(np.abs(out.pixels.numpy() - ref)) <= 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(sw.numpy(), np.asarray(rsw), rtol=1e-12)
    rng = np.random.default_rng(6)
    pix = np.zeros((4, 1, 64, 64))
    iy, ix = rng.integers(12, 52, (2, 5))
    pix[:, 0, iy, ix] = rng.uniform(0.5, 2.0, (4, 5))
    jim = model.replace(pixels=jnp.asarray(pix))
    ref = np.asarray(jax_predict_visibility(vis, jim, plan=jplan).vis)
    out = predict_visibility(pvis, interop.to_image(jim, device=CPU), plan=pplan).vis.numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.abs(ref).max()


def _components_match(ref, out, rel=1e-4):
    """The same component positions, and the residual within ``rel`` of
    its maximum."""
    (d0, r0), (d1, r1) = ref, out
    np.testing.assert_array_equal(d1.pixels.numpy() != 0.0, np.asarray(d0.pixels) != 0.0)
    rp = np.asarray(r0.pixels)
    np.testing.assert_allclose(r1.pixels.numpy(), rp, rtol=0, atol=rel * np.abs(rp).max())


@pytest.mark.parametrize("window", [None, "quarter"])
def test_continuum_fused_cube_mmclean_matches_jax(window):
    """MSMFS continuum imaging of a 6-channel cube, at the geometry of the
    JAX package's fused-cube tests (96^2 unwindowed, 64^2 windowed)."""
    if window is None:
        vis, model = _spectral_obs(6, 14, 96, (7, -4))
        kw = dict(niter=100)
    else:
        vis, model = _spectral_obs(6, 12, 64, (5, -3))
        kw = dict(niter=80, window_shape=window)
    kw = dict(nmajor=2, context="ng", algorithm="mmclean", nmoment=2,
              fractional_threshold=0.01, **kw)
    jd, jr, js = jax_continuum_imaging(vis, model, use_plan=True, fused=True, **kw)
    pd, pr, ps = continuum_imaging(
        interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU), **kw
    )
    assert pd.pixels.shape == tuple(jd.pixels.shape)
    _components_match((jd, jr), (pd, pr))
    # (the restored images are not compared: the clean-beam fit to this
    # small array's PSF is ill-conditioned, see PERF.md)
    assert torch.isfinite(ps.pixels).all()


def _ical_cube_both(nchan, nants, npixel, offset, alpha, bandwidth, **clean):
    vis, model = _spectral_obs(nchan, nants, npixel, offset, alpha=alpha,
                               bandwidth=bandwidth)
    gt = create_gaintable_from_visibility(vis, jones_type="T")
    gt = _simulate_gaintable(gt, np.random.default_rng(1805550721), phase_error=0.3)
    corrupted = jax_apply_gaintable(vis, gt)
    kw = dict(nmajor=3, calibration_context="T", context="ng",
              fractional_threshold=0.01, **clean)
    ref = jax_ical(corrupted, model, use_plan=True, fused=True, **kw)
    out = ical(
        interop.to_visibility(corrupted, device=CPU), interop.to_image(model, device=CPU), **kw
    )
    ga = np.asarray(ref[3]["T"].gain)[..., 0, 0]
    gb = out[3]["T"].gain.numpy()[..., 0, 0]
    pa = ga * np.exp(-1j * np.angle(ga[:, :1]))
    pb = gb * np.exp(-1j * np.angle(gb[:, :1]))
    assert np.max(np.abs(pa - pb)) < 1e-4
    _components_match(ref[:2], out[:2])
    return out


def test_ical_fused_cube_hogbom_matches_jax():
    """The JAX package's fused-cube ical geometry: 3 channels, 12
    stations, 96^2, Hogbom."""
    _, r, _, _ = _ical_cube_both(3, 12, 96, (7, -4), 0.0, 1e6, algorithm="hogbom",
                                 niter=150, gain=0.2)
    assert float(r.pixels.abs().max()) < 0.2


def test_ical_fused_cube_mmclean_matches_jax():
    """Self-calibration with MSMFS on a 6-channel cube."""
    _ical_cube_both(6, 14, 96, (7, -4), -0.7, 4e6, algorithm="mmclean", nmoment=2,
                    niter=100)


def test_fused_mmclean_needs_channels():
    vis, model = _spectral_obs(4, 8, 32, (2, 2))
    pvis = interop.to_visibility(vis, device=CPU)
    pmodel = interop.to_image(model, device=CPU)
    for fn in (continuum_imaging, ical):
        with pytest.raises(ValueError, match="nchan > 2"):
            fn(pvis, pmodel, nmajor=1, algorithm="mmclean", nmoment=3)
