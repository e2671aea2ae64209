"""Parity of the port's multi-frequency synthesis (one image channel from
every visibility channel) with the JAX package's: the MFS plan and its
stream order, ``invert_visibility`` and ``predict_visibility`` on the
plan and without one, ``continuum_imaging`` and a "TB" ``ical`` through
the fused cycle on the MFS plan, on the same seeded observation (10
stations, 3 integrations, 4 channels of 4 MHz, a 64^2 image).

Tolerances: plan permutations identical; images and visibilities within
1e-5 of their maximum (f32 gridding, as ``test_torch_gridding.py``);
the pipelines at the JAX package's fused-vs-composed bounds
(``tests/test_composite.py``): residual peaks 1e-3 relative, restored
peaks 0.05, phase-referenced gains 1e-4, "B" gains 2e-2 (the bandpass
tests' bound); the continuum residual and model images within 1e-5 of
their maximum (2.1e-6 measured).
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.models import SkyComponents, create_gaintable_from_visibility
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
    invert_visibility,
    invert_with_plan,
    make_imaging_plan,
    make_visibility_plan,
    predict_visibility,
)
from ska_sdp_func_python_torch.pipeline import _SortedWorkspace, continuum_imaging, ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
NCHAN = 4
KW = dict(nmajor=2, context="ng", algorithm="hogbom", niter=100, gain=0.2,
          fractional_threshold=0.01)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _peak(im):
    return float(np.abs(_np(im.pixels)).max())


@pytest.fixture(scope="module")
def obs():
    """A 2.0 Jy source with spectral index -0.7 seen in 4 channels, an
    MFS image of one channel, and the observation corrupted by "T" phases
    and a per-channel "B" table."""
    rng = np.random.default_rng(1805550721)
    vis = make_visibility(nants=10, ntimes=3, nchan=NCHAN, channel_bandwidth=4e6,
                          rmax=300.0, phasecentre=PC)
    model = jax_create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=1)
    ra, dec = model.pixel_to_radec(32 + 7, 32 - 5)
    f = np.asarray(vis.frequency)
    flux = (2.0 * (f / f[NCHAN // 2]) ** -0.7)[None, :, None]
    vis = jax_dft(vis, SkyComponents.from_lists([[float(ra), float(dec)]], flux, vis.frequency))
    gt_t = _simulate_gaintable(create_gaintable_from_visibility(vis, "T"), rng, 0.3)
    gt_b = _simulate_gaintable(
        create_gaintable_from_visibility(vis, "B", timeslice=1e5), rng, 0.1, 0.05
    )
    corrupted = jax_apply_gaintable(jax_apply_gaintable(vis, gt_t), gt_b)
    jplan = jax_make_visibility_plan(vis, model, context="ng")
    pvis = interop.to_visibility(vis, device=CPU)
    pmodel = interop.to_image(model, device=CPU)
    return dict(
        vis=vis, model=model, corrupted=corrupted, jplan=jplan, pvis=pvis,
        pmodel=pmodel, pcorrupted=interop.to_visibility(corrupted, device=CPU),
        pplan=make_visibility_plan(pvis, pmodel),
    )


def test_mfs_plan_matches_jax(obs):
    """One plan over all channels, its stream in (time, baseline,
    channel) order with each entry at its channel's frequency, the JAX
    plan's permutation."""
    jplan, pplan, pvis = obs["jplan"], obs["pplan"], obs["pvis"]
    assert pplan.mfs and jplan.mfs and pplan.nchan == 1 and len(jplan.plans) == 1
    jgp, pgp = jplan.plans[0].gp, pplan.plans[0].gp
    n = pvis.ntimes * pvis.nbaselines * NCHAN
    assert pgp.n == jgp.n == n and pplan.stack.perm.shape == (1, n)
    perm = interop.permutation_from_backsort_keys(jgp.geo[3, : jgp.n])
    np.testing.assert_array_equal(pgp.perm.numpy(), perm)
    # the stream is uvw_lambda [t, b, f] flattened, f fastest
    uvw = pvis.uvw_lambda
    one = make_imaging_plan(
        uvw[..., 0].reshape(-1), uvw[..., 1].reshape(-1), uvw[..., 2].reshape(-1),
        npixel=64, cellsize=obs["pmodel"].cellsize, nw=pplan.nw, padding=1.25,
    )
    assert torch.equal(one.gp.perm, pgp.perm)
    # the workspace's rows: one row per payload in the same order
    ws = _SortedWorkspace(pvis, obs["pmodel"], pplan)
    x = torch.arange(n, dtype=torch.float64).reshape(pvis.ntimes, pvis.nbaselines, NCHAN)
    assert torch.equal(ws.rows(x), x.reshape(1, -1))
    assert torch.equal(ws.natural(ws.rows(x), pvis.ntimes, pvis.nbaselines), x)


@pytest.mark.parametrize("with_plan", [True, False], ids=["plan", "core path"])
@pytest.mark.parametrize("dopsf", [False, True], ids=["dirty", "psf"])
def test_mfs_invert_matches_jax(obs, with_plan, dopsf):
    jkw = {"plan": obs["jplan"]} if with_plan else {}
    pkw = {"plan": obs["pplan"]} if with_plan else {}
    ref, rsw = jax_invert_visibility(obs["vis"], obs["model"], dopsf=dopsf, **jkw)
    out, sw = invert_visibility(obs["pvis"], obs["pmodel"], dopsf=dopsf, **pkw)
    ref = np.asarray(ref.pixels)
    assert out.pixels.shape == ref.shape == (1, 1, 64, 64)
    assert np.max(np.abs(out.pixels.numpy() - ref)) <= 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(sw.numpy(), np.asarray(rsw), rtol=1e-12)


def test_mfs_invert_is_the_sum_of_the_channels(obs):
    """The MFS plan's unnormalised dirty image is the sum of each
    channel's on a plan of the same geometry (the MFS plan's w planes)."""
    pvis, pplan = obs["pvis"], obs["pplan"]
    uvw = pvis.uvw_lambda
    w = uvw[..., 2]
    vals = pvis.vis[..., 0]
    mfs, _ = invert_with_plan(pplan.plans[0], vals.reshape(-1))
    total = torch.zeros_like(mfs)
    for c in range(NCHAN):
        ip = make_imaging_plan(
            uvw[:, :, c, 0].reshape(-1), uvw[:, :, c, 1].reshape(-1), w[:, :, c].reshape(-1),
            npixel=64, cellsize=obs["pmodel"].cellsize, nw=pplan.nw, padding=1.25,
            w_range=(float(w.min()), float(w.max())),
        )
        total += invert_with_plan(ip, vals[:, :, c].reshape(-1))[0]
    assert float((mfs - total).abs().max()) <= 1e-5 * float(total.abs().max())


@pytest.mark.parametrize("with_plan", [True, False], ids=["plan", "core path"])
def test_mfs_predict_matches_jax(obs, with_plan):
    model = obs["model"]
    pix = np.zeros(model.pixels.shape)
    pix[0, 0, 32 - 5, 32 + 7] = 1.5
    pix[0, 0, 20, 41] = -0.4
    jmodel = model.replace(pixels=pix)
    jkw = {"plan": obs["jplan"]} if with_plan else {}
    pkw = {"plan": obs["pplan"]} if with_plan else {}
    ref = np.asarray(jax_predict_visibility(obs["vis"], jmodel, **jkw).vis)
    out = predict_visibility(obs["pvis"], interop.to_image(jmodel, device=CPU), **pkw).vis
    assert out.shape == ref.shape
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5 * np.abs(ref).max()


def _close_images(out, ref, rel=1e-5):
    ref = _np(ref.pixels)
    assert np.max(np.abs(_np(out.pixels) - ref)) <= rel * np.abs(ref).max()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_mfs_continuum_imaging_matches_jax(obs, fused):
    """The port's fused cycle on the MFS plan and its composed cycle on
    the sorted workspace, against the JAX package's same cycle."""
    ref = jax_continuum_imaging(obs["vis"], obs["model"], use_plan=True, fused=fused, **KW)
    out = continuum_imaging(obs["pvis"], obs["pmodel"], fused=fused, **KW)
    _close_images(out[1], ref[1])
    _close_images(out[0], ref[0])
    assert abs(float(out[2].pixels.max()) - float(_np(ref[2].pixels).max())) < 0.05


def _referenced(g):
    g = _np(g)
    g = g * np.exp(-1j * np.angle(g[:, :1]))
    return g / np.mean(np.abs(g))


def test_mfs_tb_ical_matches_jax(obs):
    """"TB" self-cal through the fused cycle on the MFS plan: one "B"
    factor payload over the plan's (time, baseline, channel) stream, each
    channel's factors where its entries are; the JAX package's fused
    cycle and the port's composed cycle agree."""
    kw = dict(KW, calibration_context="TB")
    ref = jax_ical(obs["corrupted"], obs["model"], use_plan=True, fused=True, **kw)
    out = ical(obs["pcorrupted"], obs["pmodel"], **kw)
    comp = ical(obs["pcorrupted"], obs["pmodel"], fused=False, **kw)
    assert out[3]["B"].gain.shape[2] == NCHAN
    for other in (ref, comp):
        r0, r1 = _peak(other[1]), _peak(out[1])
        assert abs(r0 - r1) < 1e-3 * r0, (r0, r1)
        assert np.max(np.abs(_referenced(other[3]["T"].gain) - _referenced(out[3]["T"].gain))) < 1e-4
        for c in range(NCHAN):
            b0 = _referenced(_np(other[3]["B"].gain)[:, :, c])
            b1 = _referenced(_np(out[3]["B"].gain)[:, :, c])
            assert np.max(np.abs(b0 - b1)) < 2e-2
    assert _peak(out[1]) < 0.25
