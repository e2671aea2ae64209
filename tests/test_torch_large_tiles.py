"""Tiles the imaging API never picks, against the JAX package: a 256^2
grid cut into tiles of 128, where the JAX package takes any tile that
divides the grid (its plan path and its tiled gridder check nothing
else). On the card these tiles run K1's and K9's cluster-banded wide
variants (``ska_grid_route``, ``ska_unit_tiles_route``); on the CPU the
wrappers take their plain versions, so this holds what those compute to
the JAX package's own, in x64 (its Pallas kernels in interpret mode).

Tolerances: the plan path to 1e-5 of the maximum, as
tests/test_torch_wide_plan_jax.py (the JAX kernel evaluates its taps in
f32 inside the kernel); ``tiled_grid`` to 1e-12 of the maximum in f64,
where both sides compute in f64, and to 1e-6 in f32, the port's plan
against the direct f64 scatter in tests/test_torch_wide_supports.py
(both sides sum f32 products, in other orders).
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
from ska_sdp_func_python_torch.ops.gridding_tiled import tiled_grid

NPIX, TILE, NW, N = 256, 128, 4, 400


def _coords(seed):
    """``N`` pixel coordinates over the 256^2 grid and past its edges (a
    tenth on its last columns, a tenth on its last rows, so windows cross
    the tiles' seams), lower planes, fractions and values."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-6, NPIX + 6, N)
    v = rng.uniform(-6, NPIX + 6, N)
    u[: N // 10] = rng.uniform(NPIX - 20, NPIX, N // 10)
    v[N // 10 : N // 5] = rng.uniform(TILE - 10, TILE + 10, N // 10)
    p0 = rng.integers(0, NW - 1, N)
    frac = rng.uniform(0, 1, N)
    vals = rng.normal(size=N) + 1j * rng.normal(size=N)
    return u, v, p0, frac, vals


def _rel(out, ref):
    return np.max(np.abs(out - ref)) / np.max(np.abs(ref))


def test_plan_path_on_a_large_tile_matches_jax():
    """``make_grid_plan`` + ``grid_with_plan`` and ``degrid_with_plan`` at
    tile 128: a linear plan at support 8 and a nearest plan at support 16
    (the tiles on which the card's K1 leaves its narrow kernel)."""
    for support, mode in ((8, "linear"), (16, "nearest")):
        u, v, p0, frac, vals = _coords(500 + support)
        f = frac if mode == "linear" else None
        jp = jax_make_grid_plan(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(p0),
            None if f is None else jnp.asarray(f),
            npixel=NPIX, support=support, nplanes=NW, tile=TILE,
        )
        pp = make_grid_plan(
            torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(p0),
            None if f is None else torch.as_tensor(f),
            npixel=NPIX, support=support, nplanes=NW, tile=TILE,
        )
        assert pp.tile == TILE and pp.nearest == (mode == "nearest")
        ref = np.asarray(jax_grid_with_plan(jp, jnp.asarray(vals)))
        out = grid_with_plan(pp, torch.as_tensor(vals)).numpy()
        assert _rel(out, ref) <= 1e-5, (support, mode)
        rng = np.random.default_rng(support)
        grids = rng.normal(size=ref.shape) + 1j * rng.normal(size=ref.shape)
        dref = np.asarray(jax_degrid_with_plan(jp, jnp.asarray(grids)))
        dout = degrid_with_plan(pp, torch.as_tensor(grids)).numpy()
        assert _rel(dout, dref) <= 1e-5, (support, mode)


def test_tiled_grid_on_a_large_tile_matches_jax():
    """``tiled_grid`` at tile 128 on linear w-planes: f64 at support 16 and
    f32 at support 8 (on the card, K9's wide variant past the tiles its
    narrow kernel holds)."""
    for support, dtype, tol in ((16, np.float64, 1e-12), (8, np.float32, 1e-6)):
        u, v, p0, frac, vals = _coords(600 + support)
        cdtype = np.complex128 if dtype == np.float64 else np.complex64
        u, v, frac, vals = u.astype(dtype), v.astype(dtype), frac.astype(dtype), vals.astype(cdtype)
        kw = dict(npixel=NPIX, support=support, nplanes=NW, tile=TILE)
        ref = np.asarray(jax_tiled_grid(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(vals), jnp.asarray(p0),
            jnp.asarray(frac), unit=64, **kw,
        ))
        out = tiled_grid(
            torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(vals),
            torch.as_tensor(p0), torch.as_tensor(frac), unit=100, **kw,
        ).numpy()
        assert out.shape == ref.shape == (NW, NPIX, NPIX)
        assert out.dtype == cdtype
        assert _rel(out, ref) <= tol, (support, _rel(out, ref))
