"""The port's imaging weights, uv tapers and imaging helpers against the
JAX package's, on a small seeded observation in f64.

Tolerances: robust (Briggs) and uniform weights and both tapers 1e-10
relative (the density grids sum the same weights in another order: the
port's in int64 fixed point); ``fill_vis_for_psf`` exact;
``visibility_recentre`` 1e-12; ``advise_wide_field`` the JAX key set and
its values to 1e-12 relative (both compute on the host in f64). The
density grid is the same bit for bit whatever the order of its entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.ops import (
    advise_wide_field as jax_advise_wide_field,
    create_image_from_visibility as jax_create_image,
    fill_vis_for_psf as jax_fill_vis_for_psf,
    taper_visibility_gaussian as jax_taper_gaussian,
    taper_visibility_tukey as jax_taper_tukey,
    visibility_recentre as jax_visibility_recentre,
    weight_visibility as jax_weight_visibility,
)
from ska_sdp_func_python_tpu.utils.arrays import tukey_filter as jax_tukey_filter
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops import (
    advise_wide_field,
    fill_vis_for_psf,
    grid_weights_nearest,
    taper_visibility_gaussian,
    taper_visibility_tukey,
    visibility_recentre,
    weight_visibility,
)
from ska_sdp_func_python_torch.utils.arrays import tukey_filter

from simul import make_visibility

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))


@pytest.fixture(scope="module")
def obs():
    """20 stations, 4 integrations, 2 channels, 128^2; weights 1 + N(0,
    0.1) and a few flags, so the density sums are not small integers."""
    vis = make_visibility(nants=20, ntimes=4, nchan=2, rmax=800.0, phasecentre=PC)
    rng = np.random.default_rng(11)
    wt = 1.0 + 0.1 * rng.normal(size=vis.weight.shape)
    flags = (rng.uniform(size=vis.weight.shape) < 0.05).astype(vis.flags.dtype)
    vis = vis.replace(weight=jnp.asarray(wt), flags=jnp.asarray(flags))
    model = jax_create_image(vis, npixel=128, oversampling=3.0, nchan=2)
    return vis, model


def _close(out, ref, rel):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref))


@pytest.mark.parametrize("weighting,robustness", [
    ("robust", -2.0), ("robust", 0.0), ("robust", 2.0), ("uniform", 0.0),
])
def test_weight_visibility_matches_jax(obs, weighting, robustness):
    vis, model = obs
    ref = jax_weight_visibility(vis, model, weighting=weighting, robustness=robustness)
    out = weight_visibility(
        interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU),
        weighting=weighting, robustness=robustness,
    )
    _close(out.imaging_weight.numpy(), ref.imaging_weight, 1e-10)


def test_tapers_match_jax(obs):
    vis, model = obs
    jvis = jax_weight_visibility(vis, model, weighting="robust", robustness=0.5)
    pvis = weight_visibility(
        interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU),
        weighting="robust", robustness=0.5,
    )
    beam = 3.0 * float(model.cellsize)
    _close(taper_visibility_gaussian(pvis, beam).imaging_weight.numpy(),
           jax_taper_gaussian(jvis, beam).imaging_weight, 1e-10)
    for tukey in (0.1, 0.5):
        _close(taper_visibility_tukey(pvis, tukey).imaging_weight.numpy(),
               jax_taper_tukey(jvis, tukey).imaging_weight, 1e-10)
    x = np.linspace(0, 1, 101)
    np.testing.assert_allclose(tukey_filter(torch.as_tensor(x), 0.3).numpy(),
                               np.asarray(jax_tukey_filter(jnp.asarray(x), 0.3)),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_density_grid_does_not_depend_on_the_order(dtype):
    """The density grid of weights 1 + N(0, 0.1), entries crowded onto few
    cells, is the same bit for bit under permutations of the entries, and
    holds each cell's sum to 1e-6 (f32) or 1e-12 (f64) of the largest."""
    rng = np.random.default_rng(5)
    n, npix = 20000, 64
    u = rng.normal(npix / 2, 6, n)
    v = rng.normal(npix / 2, 6, n)
    w = torch.as_tensor(1.0 + 0.1 * rng.normal(size=n)).to(dtype)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    first, sw = grid_weights_nearest(ut, vt, w, npix)
    assert first.dtype == dtype
    for seed in range(3):
        p = torch.as_tensor(np.random.default_rng(seed).permutation(n))
        again, _ = grid_weights_nearest(ut[p], vt[p], w[p], npix)
        assert torch.equal(again, first)
    ref, _ = grid_weights_nearest(ut, vt, w.double(), npix)
    exact = np.zeros(npix * npix)
    iu, iv = np.round(u).astype(int), np.round(v).astype(int)
    np.add.at(exact, iv * npix + iu, w.double().numpy())
    np.add.at(exact, (npix - iv) * npix + (npix - iu), w.double().numpy())
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    assert np.max(np.abs(first.double().numpy().ravel() - exact)) <= tol * exact.max()
    assert abs(float(sw) - 2.0 * float(w.double().sum())) <= tol * float(sw)


@pytest.mark.parametrize("frame", ["stokesI", "linear"])
def test_fill_vis_for_psf_matches_jax(frame):
    vis = make_visibility(nants=5, ntimes=2, nchan=2, polarisation_frame=frame)
    rng = np.random.default_rng(2)
    vis = vis.replace(vis=jnp.asarray(rng.normal(size=vis.vis.shape) + 1j * rng.normal(size=vis.vis.shape)))
    ref = np.asarray(jax_fill_vis_for_psf(vis).vis)
    out = fill_vis_for_psf(interop.to_visibility(vis, device=CPU)).vis.numpy()
    np.testing.assert_array_equal(out, ref)


def test_visibility_recentre_matches_jax(obs):
    vis, _ = obs
    uvw = np.array(vis.uvw)
    ref = np.asarray(jax_visibility_recentre(jnp.asarray(uvw), 0.013, -0.021))
    out = visibility_recentre(torch.as_tensor(uvw), 0.013, -0.021).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("facets", [1, 4])
def test_advise_wide_field_matches_jax(obs, facets):
    vis, _ = obs
    ref = jax_advise_wide_field(vis, facets=facets)
    out = advise_wide_field(interop.to_visibility(vis, device=CPU), facets=facets)
    assert set(out) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(out[k], r, rtol=1e-12, err_msg=k)
