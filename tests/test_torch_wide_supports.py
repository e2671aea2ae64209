"""The port's plans at supports past 16 (up to the tile) against a
direct f64 ES scatter, the refusal past the tile, and the pipelines'
``padding=``.

Tolerances: the port's plan against the direct f64 scatter to 1e-6 of
the grid maximum (its taps are taken at the f64 positions and stored in
f32). The same plans against the JAX plan path are in
tests/test_torch_wide_plan_jax.py, the imaging API at wide and odd
supports in tests/test_torch_wide_imaging.py and the ICAL slice at
support 20 in tests/test_torch_wide_ical.py: the JAX reference compiles
once for each support, and files of few tests are the ones that
``pytest -n 6 --dist loadfile`` starts last, beside the suite's longest
few-test file.
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_torch import pipeline
from ska_sdp_func_python_torch.ops.gridding import _es_beta
from ska_sdp_func_python_torch.ops.gridding_plan import grid_with_plan, make_grid_plan
from ska_sdp_func_python_torch.ops.imaging import _npad_for, invert_visibility

from test_torch_imaging_api import _port, _scene

NPIX, TILE, NW = 128, 64, 4
SUPPORTS = [17, 24, 31, 32, 33, 48, 64]


def _coords(n, seed):
    """``n`` pixel coordinates over and past a 128^2 grid (a tenth on its
    last columns, a tenth on its last rows), lower planes, fractions and
    values."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-10, NPIX + 10, n)
    v = rng.uniform(-10, NPIX + 10, n)
    u[: n // 10] = rng.uniform(NPIX - 40, NPIX, n // 10)
    v[n // 10 : n // 5] = rng.uniform(NPIX - 40, NPIX, n // 10)
    p0 = rng.integers(0, NW - 1, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    return u, v, p0, frac, vals


def _direct_scatter(u, v, vals, p0, frac, support, beta):
    """The ES-kernel scatter in numpy f64, written from the JAX kernels'
    rule: every cell within support/2 of the position weighs es(cell -
    pix), among the cells of the entry's tile buffer (from the tile of its
    window corner to the grid's edge); entries whose window leaves the
    grid are dropped; plane weights (1 - frac, frac), or one plane."""
    half = support / 2.0
    grids = np.zeros((NW, NPIX, NPIX), complex)

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
            grids[p0[e], rows, cols] += patch
    return grids


def _port_plan(u, v, p0, frac, support, mode, beta=None):
    return make_grid_plan(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(p0),
        torch.as_tensor(frac) if mode == "linear" else None,
        npixel=NPIX, support=support, nplanes=NW, tile=TILE, beta=beta,
    )


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support", SUPPORTS)
def test_wide_plan_matches_direct_f64_scatter(support, mode):
    """Every support from 17 to the tile against the direct f64 scatter,
    to 1e-6 of the grid maximum."""
    u, v, p0, frac, vals = _coords(100, 300 + support)
    beta = _es_beta(support, 2.0)
    pp = _port_plan(u, v, p0, frac, support, mode, beta)
    assert pp.ku.shape[1] == (32 if support + support % 2 <= 32 else 64)
    out = grid_with_plan(pp, torch.as_tensor(vals)).numpy()
    ref = _direct_scatter(u, v, vals, p0, frac if mode == "linear" else None, support, beta)
    assert np.max(np.abs(out - ref)) <= 1e-6 * np.max(np.abs(ref))


def test_plan_refuses_a_support_past_the_tile():
    u = torch.linspace(10.0, 100.0, 20, dtype=torch.float64)
    with pytest.raises(ValueError, match="wider than the tile 16"):
        make_grid_plan(u, u, npixel=NPIX, support=17, tile=16)
    with pytest.raises(ValueError, match="wider than the tile 64"):
        make_grid_plan(u, u, npixel=NPIX, support=66, tile=TILE)
    assert make_grid_plan(u, u, npixel=NPIX, support=64, tile=TILE).span == 64


@pytest.fixture(scope="module")
def scene():
    # the imaging API's benign scene: 10 stations, a 1 Jy source at
    # (+12, +9) pixels of 128^2, padded to 256^2 (tile 64)
    return _scene(10, 3, 300.0, 128, 4.0, (12, 9))


def test_ical_plans_at_its_padding(scene):
    """``ical(padding=...)`` plans at that padding (a wide support needs
    more than the default 1.25: the grid correction divides the image
    corners by the ES kernel's transform there); without it, at 1.25.
    With ``use_plan=False`` the padding reaches the composed routes: their
    invert equals one at that padding (npad 392 at 128^2), not at their
    default 2 (npad 256)."""
    vis, vis_dft, model = scene
    pvis, pmodel = _port(vis, model)
    for kw, padding in (({}, 1.25), ({"padding": 3.0}, 3.0)):
        _, plan, ikw = pipeline._setup("ical", pvis, pmodel, "ng", {"support": 24, **kw})
        assert plan.plans[0].npad == _npad_for(pmodel.npixel, padding)
        assert plan.plans[0].gp.support == 24 and ikw.get("padding") == kw.get("padding")
    _, plan, ikw = pipeline._setup(
        "ical", pvis, pmodel, "ng", {"support": 24, "padding": 3.0, "use_plan": False})
    assert plan is None and ikw == {"support": 24, "padding": 3.0}
    dvis, dmodel = _port(vis_dft, model)
    out, _ = invert_visibility(dvis, dmodel, context="ng", **ikw)
    at, _ = invert_visibility(dvis, dmodel, context="ng", support=24, padding=3.0)
    default, _ = invert_visibility(dvis, dmodel, context="ng", support=24)
    assert torch.equal(out.pixels, at.pixels)
    assert not torch.equal(out.pixels, default.pixels)
