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
from ska_sdp_func_python_torch.ops.gridding_fused import grid_plain
from ska_sdp_func_python_torch.ops.gridding_plan import (
    default_chunk,
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


def _random_plan(chunk=None, n=40000, npix=256, tile=32, nplanes=5, seed=21):
    rng = np.random.default_rng(seed)
    # a dense core and a sparse outside, and entries outside the grid
    u = np.concatenate([rng.normal(npix / 2, 12, n // 2), rng.uniform(-20, npix + 20, n // 2)])
    v = np.concatenate([rng.normal(npix / 2, 12, n // 2), rng.uniform(-20, npix + 20, n // 2)])
    return make_grid_plan(
        torch.as_tensor(u), torch.as_tensor(v),
        torch.as_tensor(rng.integers(0, nplanes - 1, n)),
        torch.as_tensor(rng.uniform(0, 1, n)),
        npixel=npix, nplanes=nplanes, tile=tile, chunk=chunk,
    )


def _segments(gp):
    nta = gp.npixel // gp.tile
    n = gp.n_in
    return (gp.plane[:n].long() * nta + gp.iv0[:n].long() // gp.tile) * nta + (
        gp.iu0[:n].long() // gp.tile
    )


@pytest.mark.parametrize("chunk", [None, 100, 2048])
def test_chunks_cover_each_segment_in_order(chunk):
    """The grid kernel's chunks cut every non-empty segment of the sorted
    stream, in order, into runs of at most ``chunk`` entries (the default:
    a power of two within the old bound of 2048)."""
    gp = _random_plan(chunk)
    seg = _segments(gp)
    start, count = gp.chunk_start.long(), gp.chunk_count.long()
    bound = 2048 if chunk is None else chunk
    assert int(count.min()) > 0 and int(count.max()) <= bound
    # contiguous and complete: each chunk starts where the last ended
    assert int(start[0]) == 0 and torch.equal(start[1:], (start + count)[:-1])
    assert int((start + count)[-1]) == gp.n_in
    # each chunk lies in its segment, and segments follow in order
    assert torch.equal(seg[start], gp.chunk_seg.long())
    assert torch.equal(seg[start + count - 1], gp.chunk_seg.long())
    assert bool((gp.chunk_seg[1:] >= gp.chunk_seg[:-1]).all())
    if chunk is None:
        assert int(count.max()) <= default_chunk(torch.bincount(seg))


def test_default_chunk_fills_the_card():
    """A few waves of CTAs at both main-path sizes: the flagship keeps
    2048 entries a chunk, a cube channel's ~150 segments go down to 256."""
    assert default_chunk(torch.full((2880,), 3452)) == 2048
    assert default_chunk(torch.full((147,), 2000)) == 256
    assert default_chunk(torch.full((147,), 7000)) == 1024
    assert default_chunk(torch.full((3,), 10)) == 256


def test_walk_order_is_a_corner_sort_within_segments():
    """korder, which only the grid kernel reads, permutes the entries of
    each segment into (row, column) window-corner order, stably; the plan
    order itself is untouched."""
    gp = _random_plan()
    k = gp.korder.long()
    assert torch.equal(torch.sort(k).values, torch.arange(gp.n_in))
    seg = _segments(gp)
    assert torch.equal(seg[k], seg)
    key = (seg[k] * gp.npixel + gp.iv0[k]) * gp.npixel + gp.iu0[k]
    assert bool((key[1:] >= key[:-1]).all())
    tie = key[1:] == key[:-1]
    assert bool((k[1:][tie] > k[:-1][tie]).all())
    assert torch.equal(gp.perm, _random_plan(2048).perm)


@pytest.mark.parametrize("wstacked", [True, False])
def test_tap_bound_bounds_every_contribution(wstacked):
    """tap_bound, the grid kernel's fixed-point bound, is at least what any
    entry adds to one cell per unit of |re| + |im|: its largest u tap times
    its largest v tap times its larger plane weight (and, without w planes,
    weight 1). With the plain version's f64 grids of |re| + |im| = 1 values
    no cell exceeds tap_bound times the number of entries."""
    gp = _random_plan()
    if not wstacked:
        rng = np.random.default_rng(3)
        gp = make_grid_plan(
            torch.as_tensor(rng.uniform(-20, 276, 5000)),
            torch.as_tensor(rng.uniform(-20, 276, 5000)),
            None, None, npixel=256, nplanes=1, tile=32,
        )
    n = gp.n_in
    per_entry = gp.ku[:n].abs().amax(1) * gp.kv[:n].abs().amax(1)
    if gp.wstacked:
        f = gp.frac[:n]
        per_entry = per_entry * torch.maximum(f.abs(), (1 - f).abs())
    bound = float(gp.tap_bound)
    assert gp.tap_bound.shape == (1,) and gp.tap_bound.dtype == torch.float32
    assert float(per_entry.max()) <= bound <= 1.0 + 1e-6
    grids = grid_plain(gp, torch.ones(gp.n, dtype=torch.complex128))
    assert float(grids.abs().max()) <= bound * gp.n
