"""The port's public imaging API without a plan and under the epsilon
contract, against the JAX package (run under x64 on the CPU) and against
the exact DFT.

On the CPU both packages run the core path (``auto_plan`` is off there):
the tiled gridder in f64, which is the port's K9 plain version. Outputs
agree to 1e-10 relative (only summation orders differ) and deliver the
requested epsilon against the exact DFT. Plans are held to the JAX
package's plans at the plan path's f32 tolerance, 1e-5 of the maximum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.models import SkyComponents
from ska_sdp_func_python_tpu.ops import (
    create_image_from_visibility as jax_create_image,
    invert_visibility as jax_invert_visibility,
    predict_visibility as jax_predict_visibility,
)
from ska_sdp_func_python_tpu.ops.dft import dft_skycomponent_visibility
from ska_sdp_func_python_tpu.ops.imaging import (
    invert_with_plan as jax_invert_with_plan,
    make_visibility_plan as jax_make_visibility_plan,
    predict_with_plan as jax_predict_with_plan,
)
from ska_sdp_func_python_torch import config, interop
from ska_sdp_func_python_torch.ops import imaging
from ska_sdp_func_python_torch.ops.imaging import (
    invert_ng,
    invert_visibility,
    invert_wg,
    invert_with_plan,
    make_visibility_plan,
    predict_ng,
    predict_visibility,
    predict_wg,
    predict_with_plan,
)

from simul import make_visibility

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))


def _scene(nants, ntimes, rmax, npix, oversampling, offset, times=None,
           f32_uvw=False):
    """(JAX vis, JAX vis with the exact DFT of a 1 Jy source at pixel
    ``offset`` from the centre, JAX model image holding that source).
    ``f32_uvw``: uvw rounded to f32 first, so that an f32 Visibility holds
    the same coordinates as the DFT."""
    vis = make_visibility(nants=nants, ntimes=ntimes, nchan=1, rmax=rmax,
                          phasecentre=PC, times=times)
    if f32_uvw:
        vis = vis.replace(uvw=np.asarray(vis.uvw).astype(np.float32).astype(np.float64))
    model = jax_create_image(vis, npixel=npix, oversampling=oversampling, nchan=1)
    dx, dy = offset
    ra, dec = model.pixel_to_radec(npix // 2 + dx, npix // 2 + dy)
    comps = SkyComponents.from_lists(
        [[float(ra), float(dec)]], np.ones((1, 1, 1)), model.frequency
    )
    vis_dft = dft_skycomponent_visibility(vis, comps)
    px = jnp.zeros_like(model.pixels).at[0, 0, npix // 2 + dy, npix // 2 + dx].set(1.0)
    return vis, vis_dft, model.with_pixels(px)


@pytest.fixture(scope="module")
def benign():
    # tests/test_accuracy_api.py TestEndToEnd: 10 stations, 128^2
    return _scene(10, 3, 300.0, 128, 4.0, (12, 9))


@pytest.fixture(scope="module")
def adversarial():
    # tests/test_accuracy_api.py TestAdversarialEpsilon: the source at 70%
    # of the half-field of a wide 256^2 field with large w
    return _scene(16, 5, 2000.0, 256, 2.0, (90, 70),
                  times=np.linspace(-np.pi / 4, np.pi / 4, 5))


def _port(vis, model):
    return interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU)


def _predict_check(scene, eps):
    vis, vis_dft, model = scene
    ref = np.asarray(jax_predict_visibility(vis, model, context="ng", epsilon=eps).vis)
    out = predict_visibility(*_port(vis, model), context="ng", epsilon=eps).vis.numpy()
    assert np.max(np.abs(out - ref)) <= 1e-10 * np.max(np.abs(ref))
    err = np.max(np.abs(out - np.asarray(vis_dft.vis)))
    assert err < eps, (eps, err)


@pytest.mark.parametrize("eps", [5e-5, 1e-6, 5e-8, 1e-11])
def test_predict_epsilon_matches_jax_and_dft(benign, eps):
    _predict_check(benign, eps)


@pytest.mark.parametrize("eps", [1e-5, 1e-7, 1e-9, 1e-11])
def test_predict_epsilon_edge_source_matches_jax_and_dft(adversarial, eps):
    _predict_check(adversarial, eps)


@pytest.mark.parametrize("scene,eps,offset", [
    ("benign", 1e-6, (12, 9)), ("adversarial", 1e-7, (90, 70)),
])
def test_invert_epsilon_matches_jax_and_recovers(request, scene, eps, offset):
    vis, vis_dft, model = request.getfixturevalue(scene)
    ref, rsw = jax_invert_visibility(vis_dft, model, context="ng", epsilon=eps)
    out, sw = invert_visibility(*_port(vis_dft, model), context="ng", epsilon=eps)
    ref, img = np.asarray(ref.pixels), out.pixels.numpy()
    np.testing.assert_allclose(sw.numpy(), np.asarray(rsw), rtol=1e-14)
    assert np.max(np.abs(img - ref)) <= 1e-10 * np.max(np.abs(ref))
    n = img.shape[-1]
    iy, ix = np.unravel_index(np.argmax(img[0, 0]), img.shape[-2:])
    assert (ix, iy) == (n // 2 + offset[0], n // 2 + offset[1])
    assert abs(img[0, 0, iy, ix] - 1.0) < 1e-3


@pytest.mark.parametrize("context", ["2d", "ng"])
def test_planless_invert_and_predict_match_jax(benign, context):
    """Without a plan and without epsilon (auto_plan off on the CPU on
    both sides): the core path with the tiled gridder."""
    vis, vis_dft, model = benign
    kw = dict(context=context, nw=4)
    ref, _ = jax_invert_visibility(vis_dft, model, **kw)
    out, _ = invert_visibility(*_port(vis_dft, model), **kw)
    ref = np.asarray(ref.pixels)
    assert np.max(np.abs(out.pixels.numpy() - ref)) <= 1e-10 * np.max(np.abs(ref))
    pref = np.asarray(jax_predict_visibility(vis, model, **kw).vis)
    pout = predict_visibility(*_port(vis, model), **kw).vis.numpy()
    assert np.max(np.abs(pout - pref)) <= 1e-10 * np.max(np.abs(pref))


def test_reference_named_wrappers(benign):
    vis, vis_dft, model = benign
    pvis, pmodel = _port(vis_dft, model)
    a = predict_visibility(pvis, pmodel, context="ng", nw=4).vis
    assert torch.equal(predict_ng(pvis, pmodel, nw=4).vis, a)
    assert torch.equal(
        predict_wg(pvis, pmodel, nw=4).vis,
        predict_visibility(pvis, pmodel, context="wg", nw=4).vis,
    )
    d, _ = invert_visibility(pvis, pmodel, context="ng", nw=4, dopsf=True)
    assert torch.equal(invert_ng(pvis, pmodel, nw=4, dopsf=True)[0].pixels, d.pixels)
    assert torch.equal(invert_wg(pvis, pmodel, nw=4, dopsf=True)[0].pixels, d.pixels)


def test_f32_visibility_refuses_deep_epsilon(benign):
    vis, _, model = benign
    pvis, pmodel = _port(vis, model)
    f32 = pvis.replace(vis=pvis.vis.to(torch.complex64), uvw=pvis.uvw.float(),
                       frequency=pvis.frequency.float())
    with pytest.raises(ValueError, match="below the f32 device floor"):
        predict_visibility(f32, pmodel, epsilon=1e-7)
    with pytest.raises(ValueError, match="below the f32 device floor"):
        invert_visibility(f32, pmodel, epsilon=5e-7)


@pytest.mark.parametrize("eps", [1e-3, 1e-4, 1e-5])
def test_f32_visibility_meets_epsilon_without_a_plan(eps):
    """An f32 Visibility on the CPU (no plan): the fast row runs the tiled
    path in f32 from device coordinates, the compensated and precise rows
    from host-f64 (hi, lo) coordinates; each delivers its epsilon at the
    edge source against the exact DFT."""
    vis, vis_dft, model = _scene(16, 5, 2000.0, 256, 2.0, (90, 70),
                                 times=np.linspace(-np.pi / 4, np.pi / 4, 5),
                                 f32_uvw=True)
    pvis, pmodel = _port(vis, model)
    pvis = pvis.replace(vis=pvis.vis.to(torch.complex64), uvw=pvis.uvw.float(),
                        frequency=pvis.frequency.float(),
                        weight=pvis.weight.float(),
                        imaging_weight=pvis.imaging_weight.float())
    pmodel = pmodel.replace(pixels=pmodel.pixels.float())
    got = predict_visibility(pvis, pmodel, epsilon=eps).vis
    assert got.dtype == torch.complex64
    err = np.max(np.abs(got.numpy().astype(np.complex128) - np.asarray(vis_dft.vis)))
    assert err < eps, (eps, err)


def test_f32_eskernel_plan_meets_epsilon():
    """epsilon=1e-5 on an f32 Visibility with a plan (the card's route,
    forced here with auto_plan=True): an eskernel plan of 4 entry copies
    from host-f64 coordinates split into (hi, lo) f32 pairs, through the
    plan kernels' plain versions; it delivers 1e-5 at the edge source."""
    vis, vis_dft, model = _scene(16, 5, 2000.0, 256, 2.0, (90, 70),
                                 times=np.linspace(-np.pi / 4, np.pi / 4, 5),
                                 f32_uvw=True)
    pvis, pmodel = _port(vis, model)
    pvis = pvis.replace(vis=pvis.vis.to(torch.complex64), uvw=pvis.uvw.float(),
                        frequency=pvis.frequency.float())
    imaging._PLAN_CACHE.clear()
    got = predict_visibility(pvis, pmodel, epsilon=1e-5, auto_plan=True).vis
    ((_, _, plan),) = imaging._PLAN_CACHE.values()
    imaging._PLAN_CACHE.clear()
    assert plan.plans[0].ncopies == 4 and plan.plans[0].npad == 512
    err = np.max(np.abs(got.numpy().astype(np.complex128) - np.asarray(vis_dft.vis)))
    assert err < 1e-5, err


def _images(n, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n))
    iy, ix = rng.integers(n // 4, 3 * n // 4, (2, 5))
    img[iy, ix] = rng.uniform(0.5, 2.0, 5)
    return img


def _plan_pair(vis, model, **kw):
    jp = jax_make_visibility_plan(vis, model, context="ng", **kw).plans[0]
    pp = make_visibility_plan(*_port(vis, model), context="ng", **kw).plans[0]
    return jp, pp


def _check_plan_pair(jp, pp, seed):
    assert (pp.npad, pp.nw, pp.gp.tile, pp.ncopies) == (jp.npad, jp.nw, jp.gp.tile, jp.ncopies)
    assert pp.gp.n == jp.gp.n
    n = pp.gp.n // pp.ncopies
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    wgt = rng.uniform(0.5, 1.5, n)
    ref, _ = jax_invert_with_plan(jp, jnp.asarray(vals), jnp.asarray(wgt))
    out, _ = invert_with_plan(pp, torch.as_tensor(vals), torch.as_tensor(wgt))
    ref = np.asarray(ref)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    img = _images(pp.npixel, seed + 1)
    pref = np.asarray(jax_predict_with_plan(jp, jnp.asarray(img)))
    pout = predict_with_plan(pp, torch.as_tensor(img)).numpy()
    assert np.max(np.abs(pout - pref)) <= 1e-5 * np.max(np.abs(pref))


def test_eskernel_host64_plan_matches_jax(adversarial):
    """The eskernel plan of the f32 epsilon rows (support 8, 4 entry
    copies, the pair weights in the u taps, the w-kernel correction in
    corr_c), from host-f64 coordinates; with an f64 Visibility the
    coordinates stay f64, as under x64."""
    vis, _, model = adversarial
    nw = imaging._nw_wkernel_for(*_port(vis, model), 8)
    jp, pp = _plan_pair(vis, model, nw=nw, w_interp="eskernel", coords="host64", padding=2)
    assert pp.ncopies == 4
    _check_plan_pair(jp, pp, 21)


def test_compensated_plan_matches_jax(adversarial):
    """The compensated plan (host-f64 coordinates split into (hi, lo) f32
    pairs for an f32 Visibility), against the JAX package's with x64
    switched off; uvw rounded to f32 first, so both split the same f64
    positions."""
    vis, _, model = adversarial
    vis = vis.replace(uvw=np.asarray(vis.uvw).astype(np.float32).astype(np.float64))
    pvis, pmodel = _port(vis, model)
    pvis = pvis.replace(uvw=pvis.uvw.float(), frequency=pvis.frequency.float(),
                        vis=pvis.vis.to(torch.complex64))
    try:
        jax.config.update("jax_enable_x64", False)
        jp = jax_make_visibility_plan(vis, model, context="ng", nw=6, coords="host64")
        jp = jp.plans[0]
        pp = make_visibility_plan(pvis, pmodel, context="ng", nw=6, coords="host64").plans[0]
        assert pp.gp.iu0.dtype == torch.int32 and pp.gp.frac.dtype == torch.float32
        _check_plan_pair(jp, pp, 31)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_plan_cache_hit_and_padding_2(benign):
    """A cache miss builds the plan at padding 2; a hit returns the same
    plan; a cached predict equals a predict on that explicit plan bit for
    bit; a cache of size 0 keeps nothing."""
    vis, vis_dft, model = benign
    pvis, pmodel = _port(vis, model)
    pvis = pvis.replace(vis=_port(vis_dft, model)[0].vis)
    imaging._PLAN_CACHE.clear()
    a = predict_visibility(pvis, pmodel, nw=4, auto_plan=True)
    assert len(imaging._PLAN_CACHE) == 1
    (plan,) = [p for _, _, p in imaging._PLAN_CACHE.values()]
    b = predict_visibility(pvis, pmodel, nw=4, auto_plan=True)
    assert len(imaging._PLAN_CACHE) == 1
    (again,) = [p for _, _, p in imaging._PLAN_CACHE.values()]
    assert again is plan
    explicit = make_visibility_plan(pvis, pmodel, nw=4, padding=2)
    assert explicit.plans[0].npad == plan.plans[0].npad
    c = predict_visibility(pvis, pmodel, plan=explicit)
    assert torch.equal(a.vis, b.vis) and torch.equal(a.vis, c.vis)
    d, _ = invert_visibility(pvis, pmodel, nw=4, auto_plan=True)
    e, _ = invert_visibility(pvis, pmodel, plan=explicit)
    assert len(imaging._PLAN_CACHE) == 1
    assert torch.equal(d.pixels, e.pixels)
    # another Visibility object with the same uvw tensor shares the plan
    predict_visibility(pvis.replace(vis=pvis.vis * 2), pmodel, nw=4, auto_plan=True)
    assert len(imaging._PLAN_CACHE) == 1
    try:
        config.set_plan_cache_size(0)
        assert len(imaging._PLAN_CACHE) == 0
        predict_visibility(pvis, pmodel, nw=4, auto_plan=True)
        assert len(imaging._PLAN_CACHE) == 0
    finally:
        config.set_plan_cache_size(2)


def test_plan_cache_evicts_least_recent(benign):
    vis, _, model = benign
    pvis, pmodel = _port(vis, model)
    imaging._PLAN_CACHE.clear()
    for nw in (2, 3, 4):
        predict_visibility(pvis, pmodel, nw=nw, auto_plan=True)
    assert len(imaging._PLAN_CACHE) == 2
    assert sorted(k[8] for k in imaging._PLAN_CACHE) == [3, 4]
    imaging._PLAN_CACHE.clear()


@pytest.mark.parametrize("kw", [{"use_plan": False}, {"epsilon": 1e-5}],
                         ids=["use_plan=False", "epsilon"])
def test_pipelines_refuse_planless_and_epsilon(benign, kw):
    """Without a plan the pipelines run the composed cycle on the imaging
    API's own routes (the core path on the CPU), as the JAX pipelines do;
    they refuse epsilon, which the JAX pipelines accept and ignore (no
    reference behaviour)."""
    from ska_sdp_func_python_torch.pipeline import continuum_imaging, ical

    vis, vis_dft, model = benign
    pvis, pmodel = _port(vis_dft, model)
    for entry in (ical, continuum_imaging):
        if "epsilon" in kw:
            with pytest.raises(NotImplementedError, match="no reference behaviour"):
                entry(pvis, pmodel, nmajor=1, **kw)
            continue
        out = entry(pvis, pmodel, nmajor=1, algorithm="hogbom", niter=50, **kw)
        for im in out[:3]:
            assert bool(torch.isfinite(im.pixels).all())
        assert float(out[1].pixels.abs().max()) < float(out[2].pixels.max())
