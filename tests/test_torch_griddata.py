"""The port's GridData API, convolution functions, AW-projection and the
direct "scatter"/"gather" core gridders against the JAX package.

The JAX side runs on the CPU under x64 (``tests/conftest.py``); the port
with ``device="cpu"``, from the same seeded numpy inputs. Tolerances: f64
results agree to 1e-10 of their maximum (the JAX tests hold tiled against
scatter at 1e-10); an f32 Visibility's grids, images and visibilities to
1e-5 of their maximum. The port's scatters sum in int64 fixed point: the
same bits whatever the order of the entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ska_sdp_func_python_tpu.ops as J
from ska_sdp_func_python_tpu.ops.gridding import (
    convolutional_degrid as jax_convolutional_degrid,
    convolutional_grid as jax_convolutional_grid,
    pswf_kernel_weights as jax_pswf_kernel_weights,
)
from ska_sdp_func_python_tpu.ops.imaging import (
    invert_core as jax_invert_core,
    predict_core as jax_predict_core,
)
import ska_sdp_func_python_torch.ops as P
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models import GridData, SkyComponents
from ska_sdp_func_python_torch.ops.gridding import FixedGrid
from ska_sdp_func_python_torch.ops.imaging import invert_core, predict_core

from simul import make_visibility

CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(port, ref, tol=1e-10):
    """``port`` within ``tol`` of the maximum of ``ref``."""
    a, b = _np(port), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert np.max(np.abs(a - b)) <= tol * scale, (np.max(np.abs(a - b)), scale)


def _to32(pvis):
    return pvis.replace(
        vis=pvis.vis.to(torch.complex64), weight=pvis.weight.float(),
        imaging_weight=pvis.imaging_weight.float(), uvw=pvis.uvw.float(),
        frequency=pvis.frequency.float(), channel_bandwidth=pvis.channel_bandwidth.float(),
    )


@pytest.fixture(scope="module")
def scene():
    """(JAX vis with random visibilities and weights, port vis, JAX model
    image of 128^2 with two sources, port model): 8 stations, 3 times, 2
    channels, w as simulated."""
    vis = make_visibility(nants=8, ntimes=3, nchan=2, rmax=300.0)
    rng = np.random.default_rng(11)
    shape = vis.vis.shape
    vis = vis.replace(
        vis=jnp.asarray(rng.normal(size=shape) + 1j * rng.normal(size=shape)),
        weight=jnp.asarray(rng.uniform(0.5, 1.5, shape)),
        imaging_weight=jnp.asarray(rng.uniform(0.5, 1.5, shape)),
    )
    model = J.create_image_from_visibility(vis, npixel=128, oversampling=4.0, nchan=1)
    px = np.zeros(model.pixels.shape)
    px[0, 0, 70, 60], px[0, 0, 30, 95] = 1.0, 0.5
    model = model.with_pixels(jnp.asarray(px))
    return vis, interop.to_visibility(vis, CPU), model, interop.to_image(model, CPU)


# ---------------------------------------------------------------------------
# GridData and convolution functions


def test_griddata_from_image(scene):
    _, _, model, pmodel = scene
    gd = P.create_griddata_from_image(pmodel)
    ref = J.create_griddata_from_image(model)
    assert isinstance(gd, GridData)
    assert gd.pixels.shape == ref.pixels.shape and gd.pixels.dtype == torch.complex128
    assert not gd.pixels.abs().max() > 0 and gd.device == CPU
    assert gd.npixel == ref.npixel and gd.uv_cell == pytest.approx(ref.uv_cell, rel=1e-15)
    assert gd.polarisation_frame == ref.polarisation_frame == "stokesI"
    assert P.create_griddata_from_image(pmodel, "linear").polarisation_frame == "linear"


@pytest.mark.parametrize("support,oversampling,nw", [(8, 16, 1), (6, 8, 3), (4, 4, 2)])
def test_pswf_convolutionfunction_matches_jax(support, oversampling, nw):
    cf = P.create_pswf_convolutionfunction(support, oversampling, nw, device=CPU)
    assert cf.dtype == torch.float64 and cf.shape == (nw, oversampling, oversampling, support, support)
    _close(cf, J.create_pswf_convolutionfunction(support, oversampling, nw))


@pytest.mark.parametrize("use_aaf", [True, False])
def test_awterm_convolutionfunction_matches_jax(scene, use_aaf):
    """The w-kernels (the FFT of the zero-padded w-beam, cut into sub-cell
    kernels, with and without the anti-aliasing PSWF), built with
    ``torch.fft`` in f64, and the correction."""
    _, _, model, pmodel = scene
    kw = dict(nw=5, wstep=40.0, oversampling=4, support=8, use_aaf=use_aaf)
    gcf, cf = P.create_awterm_convolutionfunction(pmodel, **kw)
    jgcf, jcf = J.create_awterm_convolutionfunction(model, **kw)
    assert cf.dtype == torch.complex128 and cf.shape == (5, 4, 4, 8, 8)
    _close(cf, jcf)
    _close(gcf, jgcf)


# ---------------------------------------------------------------------------
# gridding onto and degridding from a GridData


def _awcf(pmodel, model, nw=5, wstep=40.0, oversampling=4):
    kw = dict(nw=nw, wstep=wstep, oversampling=oversampling, support=8)
    return P.create_awterm_convolutionfunction(pmodel, **kw), J.create_awterm_convolutionfunction(model, **kw)


@pytest.mark.parametrize("cf_kind", ["pswf", "awterm"])
@pytest.mark.parametrize("nchan", [1, 2], ids=["mfs", "cube"])
def test_grid_and_degrid_griddata_match_jax(scene, cf_kind, nchan):
    """``grid_visibility_to_griddata`` (grid and sum of weights) and
    ``degrid_visibility_from_griddata`` with the default PSWF CF and with
    an awterm CF over 5 w-planes, onto a one-channel (MFS) and a
    two-channel grid."""
    vis, pvis, model, pmodel = scene
    jim = J.create_image_from_visibility(vis, npixel=128, oversampling=4.0, nchan=nchan)
    pim = interop.to_image(jim, CPU)
    kw = {}
    if cf_kind == "awterm":
        (_, cf), (_, jcf) = _awcf(pim, jim)
        kw = dict(oversampling=4, nw=5, wstep=40.0)
    else:
        cf = jcf = None
    gd, swt = P.grid_visibility_to_griddata(pvis, P.create_griddata_from_image(pim), cf=cf, **kw)
    jgd, jswt = J.grid_visibility_to_griddata(vis, J.create_griddata_from_image(jim), cf=jcf, **kw)
    _close(gd.pixels, jgd.pixels)
    _close(swt, jswt)
    out = P.degrid_visibility_from_griddata(pvis, gd, cf=cf, **kw)
    ref = J.degrid_visibility_from_griddata(vis, jgd, cf=jcf, **kw)
    _close(out.vis, ref.vis)


def test_grid_griddata_f32_matches_jax(scene):
    """An f32 Visibility: grid and degrid to 1e-5 of the maximum."""
    vis, pvis, model, pmodel = scene
    pvis = _to32(pvis)
    gd, _ = P.grid_visibility_to_griddata(pvis, P.create_griddata_from_image(pmodel))
    jgd, _ = J.grid_visibility_to_griddata(vis, J.create_griddata_from_image(model))
    assert gd.pixels.dtype == torch.complex128  # the template's precision
    _close(gd.pixels, jgd.pixels, 1e-5)
    out = P.degrid_visibility_from_griddata(pvis, gd)
    _close(out.vis, J.degrid_visibility_from_griddata(vis, jgd).vis, 1e-5)


def test_grid_griddata_is_order_free(scene):
    """The fixed-point scatter gives the same bits for the visibilities in
    another order (times reversed)."""
    _, pvis, _, pmodel = scene
    gd0 = P.create_griddata_from_image(pmodel)
    a, _ = P.grid_visibility_to_griddata(pvis, gd0)
    flip = pvis.replace(**{f: getattr(pvis, f).flip(0) for f in
                           ("vis", "weight", "imaging_weight", "flags", "uvw", "time")})
    b, _ = P.grid_visibility_to_griddata(flip, gd0)
    assert torch.equal(a.pixels, b.pixels)


@pytest.mark.parametrize("weighting", ["uniform", "robust", "natural"])
def test_weight_grids_and_reweight_match_jax(scene, weighting):
    """``grid_visibility_weight_to_griddata``, ``griddata_merge_weights``
    of two halves and ``griddata_visibility_reweight`` against the JAX
    package; uniform weights equal ``weight_visibility``'s."""
    vis, pvis, model, pmodel = scene
    gd, swt = P.grid_visibility_weight_to_griddata(pvis, P.create_griddata_from_image(pmodel))
    jgd, jswt = J.grid_visibility_weight_to_griddata(vis, J.create_griddata_from_image(model))
    _close(gd.pixels, jgd.pixels)
    _close(swt, jswt)
    merged, total = P.griddata_merge_weights([(gd, swt), (gd, swt)])
    jmerged, jtotal = J.griddata_merge_weights([(jgd, jswt), (jgd, jswt)])
    _close(merged.pixels, jmerged.pixels)
    _close(total, jtotal)
    for sumwt in (None, swt):
        out = P.griddata_visibility_reweight(pvis, gd, weighting=weighting, robustness=0.5,
                                             sumwt=sumwt)
        ref = J.griddata_visibility_reweight(vis, jgd, weighting=weighting, robustness=0.5,
                                             sumwt=None if sumwt is None else jswt)
        _close(out.imaging_weight, ref.imaging_weight)
    if weighting == "uniform":
        _close(P.griddata_visibility_reweight(pvis, gd).imaging_weight,
               P.weight_visibility(pvis, pmodel, weighting="uniform").imaging_weight)


def test_fft_griddata_round_trip_matches_jax(scene):
    vis, pvis, model, pmodel = scene
    gcf = 1.0 / P.grid_correction(128, 8, device=CPU)
    jgcf = 1.0 / J.grid_correction(128, 8)
    gd = P.fft_image_to_griddata(pmodel, P.create_griddata_from_image(pmodel), gcf=gcf)
    jgd = J.fft_image_to_griddata(model, J.create_griddata_from_image(model), gcf=jgcf)
    _close(gd.pixels, jgd.pixels)
    for g, jg in ((None, None), (gcf, jgcf)):
        _close(P.fft_griddata_to_image(gd, pmodel, gcf=g).pixels,
               J.fft_griddata_to_image(jgd, model, gcf=jg).pixels)


# ---------------------------------------------------------------------------
# AW-projection


@pytest.mark.parametrize("gcfcf", ["default", "awterm"])
def test_awprojection_matches_jax(scene, gcfcf):
    """``invert_awprojection``/``predict_awprojection`` and the
    "awprojection" context of ``invert_visibility``/``predict_visibility``,
    with the default PSWF pair and with an awterm pair."""
    vis, pvis, model, pmodel = scene
    if gcfcf == "awterm":
        pair, jpair = _awcf(pmodel, model)
        kw = dict(oversampling=4, wstep=40.0)
    else:
        pair = jpair = None
        kw = {}
    out, swt = P.invert_awprojection(pvis, pmodel, gcfcf=pair, **kw)
    ref, jswt = J.invert_awprojection(vis, model, gcfcf=jpair, **kw)
    _close(out.pixels, ref.pixels)
    _close(swt, jswt)
    ctx, _ = P.invert_visibility(pvis, pmodel, context="awprojection", gcfcf=pair, **kw)
    assert torch.equal(ctx.pixels, out.pixels)
    pv = P.predict_awprojection(pvis, pmodel, gcfcf=pair, **kw)
    _close(pv.vis, J.predict_awprojection(vis, model, gcfcf=jpair, **kw).vis)
    assert torch.equal(
        P.predict_visibility(pvis, pmodel, context="awprojection", gcfcf=pair, **kw).vis, pv.vis
    )
    with pytest.raises(ValueError, match="awprojection"):
        P.make_visibility_plan(pvis, pmodel, context="awprojection")


def test_awprojection_point_source_meets_the_jax_bounds():
    """The JAX package's own checks (tests/test_periphery.py): with w = 0
    the default pair predicts a point source within 0.05 of the exact DFT,
    and the invert peaks on the source pixel within 0.05 of its flux."""
    vis = make_visibility(nants=8, ntimes=2, nchan=1, rmax=200.0)
    vis = vis.replace(uvw=vis.uvw.at[..., 2].set(0.0))
    model = J.create_image_from_visibility(vis, npixel=256, oversampling=6.0, nchan=1)
    pvis, pmodel = interop.to_visibility(vis, CPU), interop.to_image(model, CPU)
    ra, dec = pmodel.pixel_to_radec(138, 122)
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], [[[1.0]]],
                                     pvis.frequency.numpy(), device=CPU)
    exact = P.dft_skycomponent_visibility(pvis, comps)
    px = torch.zeros_like(pmodel.pixels)
    px[0, 0, 122, 138] = 1.0
    pred = P.predict_visibility(pvis, pmodel.replace(pixels=px), context="awprojection")
    assert float((pred.vis - exact.vis).abs().max()) < 0.05
    dirty, _ = P.invert_visibility(exact, pmodel, context="awprojection")
    img = dirty.pixels[0, 0].numpy()
    iy, ix = np.unravel_index(np.argmax(img), img.shape)
    assert (ix, iy) == (138, 122) and abs(img[iy, ix] - 1.0) < 0.05


def test_spatial_mapping_matches_jax(scene):
    vis, pvis, model, pmodel = scene
    gd, jgd = P.create_griddata_from_image(pmodel), J.create_griddata_from_image(model)
    (_, cf), (_, jcf) = _awcf(pmodel, model)
    uvw = np.array(vis.uvw_lambda)[..., 0, :].reshape(-1, 3)
    for c, jc, kw in ((None, None, {}), (cf, jcf, dict(wstep=40.0))):
        out = P.spatial_mapping(gd, *(torch.as_tensor(uvw[:, k]) for k in range(3)), cf=c, **kw)
        ref = J.spatial_mapping(jgd, *(uvw[:, k] for k in range(3)), cf=jc, **kw)
        for a, b in zip(out, ref):
            _close(a, b)
        out = P.convolution_mapping_visibility(pvis, gd, 1, cf=c, **kw)
        ref = J.convolution_mapping_visibility(vis, jgd, 1, cf=jc, **kw)
        for a, b in zip(out, ref):
            _close(a, b)


# ---------------------------------------------------------------------------
# the direct gridders and the "scatter"/"gather" core routes


def test_convolutional_grid_and_degrid_match_jax():
    rng = np.random.default_rng(13)
    n, npix = 3000, 64
    u = rng.uniform(-5, npix + 5, n)
    v = rng.uniform(-5, npix + 5, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    i0, k = P.pswf_kernel_weights(torch.as_tensor(u), 8)
    ji0, jk = jax_pswf_kernel_weights(jnp.asarray(u), 8)
    np.testing.assert_array_equal(_np(i0), np.asarray(ji0))
    _close(k, jk)
    g, ok = P.convolutional_grid(torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(vals), npix, 8)
    jg, jok = jax_convolutional_grid(jnp.asarray(u), jnp.asarray(v), jnp.asarray(vals), npix, 8)
    np.testing.assert_array_equal(_np(ok), np.asarray(jok))
    _close(g, jg)
    d, _ = P.convolutional_degrid(torch.as_tensor(u), torch.as_tensor(v), g, 8)
    jd, _ = jax_convolutional_degrid(jnp.asarray(u), jnp.asarray(v), jg, 8)
    _close(d, jd)
    # the same bits for the entries in another order; NaN for a NaN value
    perm = torch.as_tensor(rng.permutation(n))
    g2, _ = P.convolutional_grid(torch.as_tensor(u)[perm], torch.as_tensor(v)[perm],
                                 torch.as_tensor(vals)[perm], npix, 8)
    assert torch.equal(g, g2)
    bad = torch.as_tensor(vals).clone()
    bad[int(torch.nonzero(ok)[0])] = complex("nan")
    assert torch.isnan(P.convolutional_grid(torch.as_tensor(u), torch.as_tensor(v), bad, npix, 8)[0]).all()


def test_fixed_grid_sums_exactly():
    """FixedGrid: sums to 2^-60 of its bound whatever the order; a cell of
    2^-40 of the bound keeps 20 bits."""
    g = FixedGrid(4, torch.tensor(8.0, dtype=torch.float64), torch.complex128, CPU)
    idx = torch.tensor([0, 1, 1, 3])
    g.add(idx, torch.tensor([1.0 + 2j, 3.0, -3.0, 2.0**-37], dtype=torch.complex128))
    out = g.value()
    assert out[0] == 1.0 + 2j and out[1] == 0 and out[2] == 0
    assert abs(out[3] - 2.0**-37) <= 2.0**-57


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nw", [1, 5])
def test_scatter_and_gather_core_match_jax(dtype, nw):
    """``invert_core(gridder="scatter")`` and ``predict_core(gridder=
    "gather")``: one grid (the sigma-2 kernel) and five linear w-planes,
    in f64 to 1e-10 and in f32 to 1e-5 of the maximum; the scatter gives
    the same bits for the visibilities in another order."""
    rng = np.random.default_rng(17)
    n, npix, cell = 4000, 64, 0.004
    uvw = rng.uniform(-1.0 / (3 * cell), 1.0 / (3 * cell), (n, 3))
    uvw[:, 2] *= 0.3
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    wgt = rng.uniform(0.5, 1.5, n)
    kw = dict(npixel=npix, cellsize=cell, nw=nw, do_wstacking=nw > 1)
    ref, ref_w = jax_invert_core(*(jnp.asarray(uvw[:, k]) for k in range(3)), jnp.asarray(vals),
                                 jnp.asarray(wgt), gridder="scatter", **kw)
    cd = torch.complex128 if dtype == torch.float64 else torch.complex64
    t = [torch.as_tensor(uvw[:, k]).to(dtype) for k in range(3)]
    out, out_w = invert_core(*t, torch.as_tensor(vals).to(cd), torch.as_tensor(wgt).to(dtype),
                             gridder="scatter", **kw)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    _close(out, ref, tol)
    _close(out_w, ref_w, tol)
    perm = torch.as_tensor(rng.permutation(n))
    again, _ = invert_core(*(x[perm] for x in t), torch.as_tensor(vals).to(cd)[perm],
                           torch.as_tensor(wgt).to(dtype)[perm], gridder="scatter", **kw)
    assert torch.equal(again, out)
    img = rng.normal(size=(npix, npix))
    kw.pop("npixel")
    pref = jax_predict_core(*(jnp.asarray(uvw[:, k]) for k in range(3)), jnp.asarray(img),
                            gridder="gather", **kw)
    pout = predict_core(*t, torch.as_tensor(img).to(dtype), gridder="gather", **kw)
    _close(pout, pref, tol)


@pytest.mark.parametrize("context", ["2d", "ng"])
def test_scatter_and_gather_routes_of_the_imaging_api_match_jax(scene, context):
    """``invert_visibility(gridder="scatter")`` and
    ``predict_visibility(gridder="gather")`` (the CPU takes the core path)
    against the JAX package's, on a two-channel MFS image; "gather" and
    "scatter" name the same direct route in both."""
    vis, pvis, model, pmodel = scene
    kw = dict(context=context, nw=4 if context == "ng" else None)
    d, s = P.invert_visibility(pvis, pmodel, gridder="scatter", **kw)
    jd, js = J.invert_visibility(vis, model, gridder="scatter", **kw)
    _close(d.pixels, jd.pixels)
    _close(s, js)
    d2, _ = P.invert_visibility(pvis, pmodel, gridder="gather", **kw)
    assert torch.equal(d2.pixels, d.pixels)
    pv = P.predict_visibility(pvis, pmodel, gridder="gather", **kw)
    _close(pv.vis, J.predict_visibility(vis, model, gridder="gather", **kw).vis)
