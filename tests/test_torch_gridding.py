"""Parity of the port's plan gridding (kernels K1+K2 and K3, plain
versions on the CPU) with the JAX package's fused Pallas plan path (run in
interpret mode on the CPU).

Tolerance: 1e-5 of the grid or image maximum. Both sides grid in f32 from
taps evaluated at f64 positions (the JAX side runs under x64, the port
gets the same f64 inputs); only the f32 summation order differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops import create_image_from_visibility
from ska_sdp_func_python_tpu.ops.gridding_plan import (
    degrid_with_plan as jax_degrid_with_plan,
    grid_with_plan as jax_grid_with_plan,
    make_grid_plan as jax_make_grid_plan,
)
from ska_sdp_func_python_tpu.ops.imaging import (
    invert_with_plan as jax_invert_with_plan,
    make_visibility_plan as jax_make_visibility_plan,
    predict_with_plan as jax_predict_with_plan,
    w_kernel_correction as jax_w_kernel_correction,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.gridding_plan import (
    degrid_with_plan,
    grid_with_plan,
    make_grid_plan,
)
from ska_sdp_func_python_torch.ops.imaging import (
    invert_with_plan,
    make_visibility_plan,
    predict_with_plan,
    w_kernel_correction,
)

from simul import make_visibility

CPU = torch.device("cpu")

TOL = 1e-5
NW = 4


@pytest.fixture(scope="module")
def plans():
    # 20 stations x 10 times: 1900 visibilities on a 128^2 image, nw 4
    vis = make_visibility(nants=20, ntimes=10, nchan=1, rmax=400.0)
    model = create_image_from_visibility(
        vis, npixel=128, oversampling=3.0, nchan=1
    )
    jplan = jax_make_visibility_plan(vis, model, context="ng", nw=NW)
    pplan = make_visibility_plan(
        interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU), nw=NW
    )
    return jplan.plans[0], pplan.plans[0]


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n) + 1j * rng.normal(size=n)


def test_plan_geometry_matches(plans):
    jp, pp = plans
    assert (pp.npad, pp.nw, pp.gp.tile) == (jp.npad, jp.nw, jp.gp.tile)
    assert pp.gp.n == jp.gp.n
    perm = interop.permutation_from_backsort_keys(jp.gp.geo[3, : jp.gp.n])
    np.testing.assert_array_equal(pp.gp.perm.numpy(), perm)


def test_grid_with_plan_matches_jax(plans):
    jp, pp = plans
    vals = _values(pp.gp.n, 1)
    ref = np.asarray(jax_grid_with_plan(jp.gp, jnp.asarray(vals)))
    out = grid_with_plan(pp.gp, torch.as_tensor(vals)).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= TOL * np.max(np.abs(ref))


def test_degrid_with_plan_matches_jax(plans):
    jp, pp = plans
    rng = np.random.default_rng(2)
    shape = (NW, pp.npad, pp.npad)
    grids = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    for to_sorted in (False, True):
        ref = np.asarray(
            jax_degrid_with_plan(jp.gp, jnp.asarray(grids), to_sorted=to_sorted)
        )
        out = degrid_with_plan(
            pp.gp, torch.as_tensor(grids), to_sorted=to_sorted
        ).numpy()
        assert np.max(np.abs(out - ref)) <= TOL * np.max(np.abs(ref))


def test_invert_with_plan_matches_jax(plans):
    jp, pp = plans
    n = pp.gp.n
    vals = _values(n, 3)
    wgt = np.random.default_rng(4).uniform(0.5, 1.5, n)
    ref, ref_sw = jax_invert_with_plan(jp, jnp.asarray(vals), jnp.asarray(wgt))
    ref = np.asarray(ref)
    out, sw = invert_with_plan(pp, torch.as_tensor(vals), torch.as_tensor(wgt))
    assert np.max(np.abs(out.numpy() - ref)) <= TOL * np.max(np.abs(ref))
    np.testing.assert_allclose(float(sw), float(ref_sw), rtol=1e-12)


def test_predict_with_plan_matches_jax(plans):
    jp, pp = plans
    rng = np.random.default_rng(5)
    image = np.zeros((pp.npixel, pp.npixel), np.float32)
    iy, ix = rng.integers(20, pp.npixel - 20, (2, 6))
    image[iy, ix] = rng.uniform(0.5, 2.0, 6)
    ref = np.asarray(jax_predict_with_plan(jp, jnp.asarray(image)))
    out = predict_with_plan(pp, torch.as_tensor(image)).numpy()
    assert np.max(np.abs(out - ref)) <= TOL * np.max(np.abs(ref))


def test_split_coordinate_plan_matches_jax():
    """Compensated (hi, lo) f32 coordinates: the lo residual enters the
    taps after the small difference on both sides."""
    rng = np.random.default_rng(8)
    n, npix = 2000, 128
    u64 = rng.uniform(-10, npix + 10, n)
    v64 = rng.uniform(-10, npix + 10, n)
    u_hi, v_hi = u64.astype(np.float32), v64.astype(np.float32)
    u_lo = (u64 - u_hi).astype(np.float32)
    v_lo = (v64 - v_hi).astype(np.float32)
    vals = _values(n, 9)
    jgp = jax_make_grid_plan(
        jnp.asarray(u_hi), jnp.asarray(v_hi), npixel=npix, tile=32,
        u_lo=jnp.asarray(u_lo), v_lo=jnp.asarray(v_lo),
    )
    ref = np.asarray(jax_grid_with_plan(jgp, jnp.asarray(vals)))
    pgp = make_grid_plan(
        torch.as_tensor(u_hi), torch.as_tensor(v_hi), npixel=npix, tile=32,
        u_lo=torch.as_tensor(u_lo), v_lo=torch.as_tensor(v_lo),
    )
    out = grid_with_plan(pgp, torch.as_tensor(vals)).numpy()
    assert np.max(np.abs(out - ref)) <= TOL * np.max(np.abs(ref))
    # the residual carries the f64 position: taps agree with taps taken
    # at the f64 coordinates (8e-7 here; 3e-6 with the residual dropped)
    p64 = make_grid_plan(
        torch.as_tensor(u64), torch.as_tensor(v64), npixel=npix, tile=32
    )
    assert torch.equal(pgp.perm, p64.perm)
    assert float((pgp.ku - p64.ku).abs().max()) < 2e-6
    assert float((pgp.kv - p64.kv).abs().max()) < 2e-6


def test_w_kernel_correction_matches_jax():
    ref = np.asarray(
        jax_w_kernel_correction(64, 2e-3, 40.0, 8, jnp.float64)
    )
    out = w_kernel_correction(64, 2e-3, 40.0, 8, torch.float64).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=0)
