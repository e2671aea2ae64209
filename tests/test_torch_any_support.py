"""Every support and tile the JAX package's gridders take, against the JAX
package: windows past 64 cells on the plan path (``make_grid_plan``,
``grid_with_plan``, ``degrid_with_plan``), ``tiled_grid`` at supports 1
and past 64, and the plain versions on tiles past what a cluster of the
card holds. On the card these run K1's route 4, K3's long-window
kernel and K9's route 4 (``ska_grid_route``,
``ska_degrid_route``, ``ska_unit_tiles_route`` return 4); on the CPU the
wrappers take their plain versions, held here to the JAX package's own
results (its Pallas kernels in interpret mode, in x64).

Tolerances: the plan path and ``tiled_grid`` in f32 to 1e-5 of the grid's
(or values') maximum (the JAX kernels evaluate their taps in f32, and both
sides sum f32 products in other orders); the plain versions at a large
tile against the same plain versions at the imaging API's tile to 1e-6 of
the maximum (the same sums over other partitions of the grid).
"""

import jax.numpy as jnp
import numpy as np
import torch

from ska_sdp_func_python_tpu.ops.gridding_plan import (
    degrid_with_plan as jax_degrid_with_plan,
    grid_with_plan as jax_grid_with_plan,
    make_grid_plan as jax_make_grid_plan,
)
from ska_sdp_func_python_tpu.ops.gridding_tiled import tiled_grid as jax_tiled_grid
from ska_sdp_func_python_torch.ops.gridding_plan import (
    degrid_with_plan,
    grid_with_plan,
    make_grid_plan,
)
from ska_sdp_func_python_torch.ops.gridding_tiled import entry_stream, tiled_grid

NW = 3


def _coords(seed, n, npix, tile):
    """``n`` pixel coordinates over an npix^2 grid and past its edges (a
    fifth near a tile seam, so windows cross it), lower planes, fractions
    and values."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-6, npix + 6, n)
    v = rng.uniform(-6, npix + 6, n)
    v[: n // 5] = rng.uniform(tile - 10, tile + 10, n // 5)
    p0 = rng.integers(0, NW - 1, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    return u, v, p0, frac, vals


def _rel(out, ref):
    return np.max(np.abs(out - ref)) / np.max(np.abs(ref))


def test_plan_path_past_64_cells_matches_jax():
    """``make_grid_plan`` + ``grid_with_plan`` and ``degrid_with_plan`` on a
    192^2 grid at tile 96: supports 72 and 67 (odd: windows of 68 cells),
    on a linear plan of 3 planes and a nearest plane plan, to 1e-5 of the
    maximum."""
    npix, tile = 192, 96
    for support, mode in ((72, "linear"), (72, "nearest"), (67, "linear"), (67, "nearest")):
        u, v, p0, frac, vals = _coords(700 + support, 300, npix, tile)
        f = frac if mode == "linear" else None
        jp = jax_make_grid_plan(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(p0),
            None if f is None else jnp.asarray(f),
            npixel=npix, support=support, nplanes=NW, tile=tile,
        )
        pp = make_grid_plan(
            torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(p0),
            None if f is None else torch.as_tensor(f),
            npixel=npix, support=support, nplanes=NW, tile=tile,
        )
        assert pp.span == support + support % 2 and pp.ku.shape[1] == 72
        assert pp.n_in > 0
        ref = np.asarray(jax_grid_with_plan(jp, jnp.asarray(vals)))
        out = grid_with_plan(pp, torch.as_tensor(vals)).numpy()
        assert out.shape == ref.shape == (NW, npix, npix)
        assert _rel(out, ref) <= 1e-5, (support, mode, _rel(out, ref))
        rng = np.random.default_rng(support)
        grids = rng.normal(size=ref.shape) + 1j * rng.normal(size=ref.shape)
        dref = np.asarray(jax_degrid_with_plan(jp, jnp.asarray(grids)))
        dout = degrid_with_plan(pp, torch.as_tensor(grids)).numpy()
        assert np.count_nonzero(dref) == pp.n_in
        assert _rel(dout, dref) <= 1e-5, (support, mode, _rel(dout, dref))


def test_tiled_grid_at_supports_1_and_past_64_matches_jax():
    """``tiled_grid`` in f32 on linear w-planes: support 72 on tile 96 of
    a 192^2 grid, 80 on tile 192, and 1 (whose ES kernel of half width 0
    is zero everywhere: both grids are zero), to 1e-5 of the maximum."""
    for support, npix, tile in ((72, 192, 96), (80, 192, 192), (1, 192, 96)):
        u, v, p0, frac, vals = _coords(800 + support, 300, npix, tile)
        u, v, frac = u.astype(np.float32), v.astype(np.float32), frac.astype(np.float32)
        vals = vals.astype(np.complex64)
        kw = dict(npixel=npix, support=support, nplanes=NW, tile=tile)
        ref = np.asarray(jax_tiled_grid(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(vals), jnp.asarray(p0),
            jnp.asarray(frac), unit=64, **kw,
        ))
        out = tiled_grid(
            torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(vals),
            torch.as_tensor(p0), torch.as_tensor(frac), unit=100, **kw,
        ).numpy()
        assert out.shape == ref.shape == (NW, npix, npix)
        assert out.dtype == np.complex64
        if support == 1:
            assert not np.any(ref) and not np.any(out)
        else:
            assert _rel(out, ref) <= 1e-5, (support, _rel(out, ref))


def test_plain_versions_on_tiles_past_a_cluster_match_the_api_tile():
    """The plain versions on one tile the whole grid, past what a cluster
    of the card holds (K9 on 2048^2 at tile 2048, support 64; K1 on
    1344^2 at tile 1344, support 48), equal the same plain versions at the
    imaging API's tile (64, 56), to 1e-6 of the maximum."""
    rng = np.random.default_rng(900)
    n, npix, support = 120, 2048, 64
    u, v = rng.uniform(900, 1150, (2, n))
    p0 = torch.as_tensor(rng.integers(0, NW - 1, n))
    frac = torch.as_tensor(rng.uniform(0, 1, n))
    vals = torch.as_tensor(rng.normal(size=n) + 1j * rng.normal(size=n))
    grids = [
        entry_stream(torch.as_tensor(u), torch.as_tensor(v), vals, p0, frac, npixel=npix,
                     support=support, nplanes=NW, tile=tile).grid(
            npixel=npix, tile=tile, support=support, plain=True)
        for tile in (2048, 64)
    ]
    assert _rel(grids[0].numpy(), grids[1].numpy()) <= 1e-6
    npix, support = 1344, 48
    u, v = rng.uniform(600, 760, (2, n))
    out = [
        grid_with_plan(make_grid_plan(torch.as_tensor(u), torch.as_tensor(v), p0, frac,
                                      npixel=npix, support=support, nplanes=NW, tile=tile),
                       vals)
        for tile in (1344, 56)
    ]
    assert _rel(out[0].numpy(), out[1].numpy()) <= 1e-6
