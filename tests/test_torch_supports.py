"""The port's plans at supports other than 8 and on nearest-plane plans:
gridding and degridding and the imaging API against the JAX package (x64
on the CPU, its Pallas kernels in interpret mode) and against a direct
f64 ES scatter; streamed_ical at support 6 against the in-memory ical.

Tolerances: grids and values against JAX's plan path to 1e-5 of their
maximum (the JAX kernels evaluate the taps of a support other than 8 in
f32 inside the kernel, 1.4e-6 to 2.4e-6 from the exact scatter); the
port's plan against the direct f64 scatter to 1e-6 (its taps are taken at
the f64 positions and stored in f32); dirty images and predicted
visibilities to 1e-5 of their maximum; the streamed cycle to
tests/test_torch_streaming_cycle.py's (the ICAL slice at support 6 runs
in tests/test_torch_pipeline.py, beside the support-8 slice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.ops.gridding_plan import (
    degrid_with_plan as jax_degrid_with_plan,
    grid_with_plan as jax_grid_with_plan,
    make_grid_plan as jax_make_grid_plan,
)
from ska_sdp_func_python_tpu.ops.imaging import (
    invert_visibility as jax_invert_visibility,
    make_visibility_plan as jax_make_visibility_plan,
    predict_visibility as jax_predict_visibility,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.io import write_visibility
from ska_sdp_func_python_torch.models import SkyComponents, create_gaintable_from_visibility
from ska_sdp_func_python_torch.ops import apply_gaintable, dft_skycomponent_visibility
from ska_sdp_func_python_torch.ops.gridding import _es_beta
from ska_sdp_func_python_torch.ops.gridding_plan import (
    degrid_with_plan,
    grid_with_plan,
    make_grid_plan,
)
from ska_sdp_func_python_torch.ops.imaging import (
    create_image_from_visibility,
    invert_visibility,
    make_visibility_plan,
    predict_visibility,
)
from ska_sdp_func_python_torch.pipeline import ical
from ska_sdp_func_python_torch.streaming import streamed_ical

from test_torch_imaging_api import _scene
from simul import make_visibility
from test_torch_streaming_cycle import CLEAN_KW, _assert_match

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
NPIX, TILE, NW = 64, 16, 4


def _coords(n=400, seed=0):
    """Pixel coordinates over and past a 64^2 grid, plane indices and
    fractions, and values."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-4, NPIX + 4, n)
    v = rng.uniform(-4, NPIX + 4, n)
    u[:40] = rng.uniform(NPIX - 17, NPIX, 40)  # the last columns
    v[40:80] = rng.uniform(NPIX - 17, NPIX, 40)  # the last rows
    p0 = rng.integers(0, NW, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    return u, v, p0, frac, vals


def _planes(mode, p0, frac, wrap):
    if mode == "single":
        return None, None, 1
    return wrap(p0), (wrap(frac) if mode == "linear" else None), NW


@pytest.fixture(scope="module")
def scene():
    # tests/test_accuracy_api.py TestEndToEnd's observation: 10 stations, 128^2
    return _scene(10, 3, 300.0, 128, 4.0, (12, 9))


def test_imaging_api_on_plans_matches_jax(scene):
    """invert_visibility and predict_visibility on an explicit
    nearest-plane plan at support 6 against the JAX package's, to 1e-5 of
    the image and visibility maxima (the linear plan at support 6 runs in
    tests/test_torch_pipeline.py::test_ical_fused_at_support_6_matches_jax)."""
    vis, vis_dft, model = scene
    kw = {"support": 6, "w_interp": "nearest", "nw": 6}
    jplan = jax_make_visibility_plan(vis, model, context="ng", **kw)
    pvis = interop.to_visibility(vis_dft, device=CPU)
    pmodel = interop.to_image(model, device=CPU)
    plan = make_visibility_plan(pvis, pmodel, context="ng", **kw)
    assert plan.plans[0].gp.nearest and plan.plans[0].gp.support == 6
    ref, rsw = jax_invert_visibility(vis_dft, model, context="ng", plan=jplan)
    out, sw = invert_visibility(pvis, pmodel, context="ng", plan=plan)
    ref = np.asarray(ref.pixels)
    np.testing.assert_allclose(sw.numpy(), np.asarray(rsw), rtol=1e-12)
    assert np.max(np.abs(out.pixels.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    vref = np.asarray(jax_predict_visibility(vis, model, context="ng", plan=jplan).vis)
    vout = predict_visibility(pvis, pmodel, context="ng", plan=plan).vis.numpy()
    assert np.max(np.abs(vout - vref)) <= 1e-5 * np.max(np.abs(vref))


@pytest.mark.parametrize("support,mode", [
    (4, "single"), (6, "linear"), (7, "nearest"), (12, "linear"), (16, "nearest"),
])
def test_plan_grid_and_degrid_match_jax(support, mode):
    """grid_with_plan/degrid_with_plan at the support against the JAX
    plan path: the same grids and values to 1e-5 of the maximum, on
    single-plane, linear and nearest-plane plans (odd supports included:
    the cell before the window counts where it lies in the tile, as the
    JAX kernels' dense evaluation counts it)."""
    u, v, p0, frac, vals = _coords(seed=support)
    jp0, jfrac, nplanes = _planes(mode, p0, frac, jnp.asarray)
    jp = jax_make_grid_plan(jnp.asarray(u), jnp.asarray(v), jp0, jfrac,
                            npixel=NPIX, support=support, nplanes=nplanes, tile=TILE)
    ref = np.asarray(jax_grid_with_plan(jp, jnp.asarray(vals)))
    pp0, pfrac, _ = _planes(mode, p0, frac, torch.as_tensor)
    pp = make_grid_plan(torch.as_tensor(u), torch.as_tensor(v), pp0, pfrac,
                        npixel=NPIX, support=support, nplanes=nplanes, tile=TILE)
    assert pp.nearest == (mode == "nearest") and pp.wstacked == (mode == "linear")
    out = grid_with_plan(pp, torch.as_tensor(vals)).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))
    rng = np.random.default_rng(support + 1)
    grids = rng.normal(size=ref.shape) + 1j * rng.normal(size=ref.shape)
    dref = np.asarray(jax_degrid_with_plan(jp, jnp.asarray(grids)))
    dout = degrid_with_plan(pp, torch.as_tensor(grids)).numpy()
    assert np.max(np.abs(dout - dref)) <= 1e-5 * np.max(np.abs(dref))


def _direct_scatter(u, v, vals, p0, frac, support, nplanes, beta):
    """The ES-kernel scatter in numpy f64, written from the JAX kernels'
    rule: every cell within support/2 of the position weighs es(cell -
    pix), among the cells of the entry's tile buffer (from the tile of its
    clipped window corner to the grid's edge); entries whose window leaves
    the grid are dropped; plane weights (1 - frac, frac), or 1."""
    half = support / 2.0
    grids = np.zeros((nplanes, NPIX, NPIX), complex)

    def taps(pix):
        i0 = int(np.floor(pix)) - (support // 2 - 1)
        if i0 < 0 or i0 + support > NPIX:
            return None
        origin = (i0 // TILE) * TILE
        cells = np.arange(max(origin, i0 - 1), min(NPIX, i0 + support + 1))
        nu = (cells - pix) / half
        k = np.where(np.abs(nu) < 1, np.exp(beta * (np.sqrt(np.clip(1 - nu * nu, 0, 1)) - 1)), 0)
        return cells, k

    for e in range(u.size):
        tu, tv = taps(u[e]), taps(v[e])
        if tu is None or tv is None:
            continue
        patch = vals[e] * np.outer(tv[1], tu[1])
        rows, cols = tv[0][:, None], tu[0][None, :]
        if frac is not None:
            grids[p0[e], rows, cols] += (1 - frac[e]) * patch
            grids[p0[e] + 1, rows, cols] += frac[e] * patch
        else:
            grids[0 if p0 is None else p0[e], rows, cols] += patch
    return grids


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support", [4, 5, 6, 7, 9, 10, 12, 15, 16])
def test_plan_grid_matches_direct_f64_scatter(support, mode):
    """The port's plan at every support against the direct f64 scatter,
    to 1e-6 of the grid maximum (the f32 rounding of its taps)."""
    u, v, p0, frac, vals = _coords(n=300, seed=100 + support)
    p0 = np.minimum(p0, NW - 2) if mode == "linear" else p0
    beta = _es_beta(support, 2.0)
    pp = make_grid_plan(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(p0),
        torch.as_tensor(frac) if mode == "linear" else None,
        npixel=NPIX, support=support, nplanes=NW, tile=TILE, beta=beta,
    )
    out = grid_with_plan(pp, torch.as_tensor(vals)).numpy()
    ref = _direct_scatter(u, v, vals, p0, frac if mode == "linear" else None,
                          support, NW, beta)
    assert np.max(np.abs(out - ref)) <= 1e-6 * np.max(np.abs(ref))


def test_plan_refuses_supports_past_16():
    u = torch.linspace(10.0, 50.0, 20, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="S11"):
        make_grid_plan(u, u, npixel=NPIX, support=17, tile=TILE)
    with pytest.raises(ValueError, match="supports 1 to 16"):
        make_grid_plan(u, u, npixel=NPIX, support=0, tile=TILE)
    with pytest.raises(ValueError, match="divides the odd support"):
        make_grid_plan(u, u, npixel=NPIX, support=5, tile=1)


def _port_source_vis(rng, flux=1.5, npixel=64):
    """test_torch_streaming_cycle._source_vis built with the port's DFT and
    gains, so that no JAX function compiles: 8 stations, 6 times, a 1.5 Jy
    source at (+5, -4) px of a 64^2 model, "T" phases from N(0, 0.3)."""
    vis = interop.to_visibility(
        make_visibility(nants=8, ntimes=6, nchan=1, rmax=300.0, phasecentre=PC), device=CPU)
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=4.0, nchan=1)
    ra, dec = model.pixel_to_radec(npixel // 2 + 5, npixel // 2 - 4)
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], [[[flux]]], vis.frequency,
                                     dtype=torch.float64, device=CPU)
    vis = dft_skycomponent_visibility(vis, comps)
    gt = create_gaintable_from_visibility(vis, "T")
    gain = torch.zeros_like(gt.gain)
    gain[..., 0, 0] = torch.as_tensor(np.exp(1j * rng.normal(0, 0.3, gt.gain.shape[:3])))
    return apply_gaintable(vis, gt.replace(gain=gain)), model


def test_streamed_ical_at_support_6_matches_in_memory(tmp_path):
    """streamed_ical(support=6) over a store against the in-memory fused
    ical at support 6 on the same visibilities."""
    corrupted, model = _port_source_vis(np.random.default_rng(20260415))
    path = str(tmp_path / "small.svis")
    write_visibility(corrupted, path, chunk_times=2)
    res = streamed_ical(path, model, PC, chunk_times=2, calibration_context="T",
                        support=6, **CLEAN_KW)
    mem = ical(corrupted, model, calibration_context="T", context="ng", support=6,
               **CLEAN_KW)
    _, _, peak = _assert_match(res, mem)
    assert abs(peak - 1.5) < 0.2, peak
