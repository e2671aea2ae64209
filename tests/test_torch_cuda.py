"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. This file
imports only the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The CLEAN kernels (K5, K6, K7, K8) run one cooperative grid per call;
their stress cases range from every resident CTA on one lane to one CTA
per lane over two launches.

Tolerances: ``permute_apply`` is bit-exact (elements are only moved);
``hogbom`` (with and without a window) and ``hogbom_complex`` give
identical component positions and values to 1e-6 relative (the same f32
operations in the same order); ``msclean`` and ``msmfs`` on the same f32
stacks agree bit for bit in rows, residuals and the kernels' component
images and moment models (``msclean_with_stacks`` from the FFTs of each
device to 1e-6); ``grid`` (fixed-point accumulation, the same bits from
launch to launch; held against the plain version accumulated in f64) and
``degrid`` (one entry's f32
sums in another order: rows per lane, then a shuffle reduction) agree to
1e-5 of the maximum, for one plan and for a stack of channel plans in one
launch, at supports 4 to 16 and on linear, nearest-plane and
single-plane plans; ``unit_tiles`` (atomics) agrees with its plain version
accumulated in f64 to 1e-5 of the grid maximum in f32 and to 1e-12 in
f64. The calibration paths (the composed "TG" ical with a sky component,
the fused "TB" bandpass cube, the full-Jones "T" + "B" chain on an MFS
image) and the streamed cycle over a store launch their kernels on the
card and agree with the CPU run to the slice bounds: gains 1e-4, peak
residual 1e-3 relative. K4 moves the
four polarisations of a cycle's leg in one launch; K1 and K3 take an MFS
plan's one row as they take a channel's.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from ska_sdp_func_python_torch import kernels
from ska_sdp_func_python_torch.ops import cleaners
from ska_sdp_func_python_torch.ops.cleaners import hogbom_lanes
from ska_sdp_func_python_torch.ops.gridding_fused import (
    degrid,
    degrid_plain,
    degrid_stack,
    degrid_stack_plain,
    grid,
    grid_plain,
)
from ska_sdp_func_python_torch.ops.gridding_plan import (
    STACKED,
    GridPlanStack,
    make_grid_plan,
    stack_views,
)
from ska_sdp_func_python_torch.ops.gridding_tiled import entry_stream
from ska_sdp_func_python_torch.ops.permute import (
    permute_apply,
    permute_apply_plain,
)

pytestmark = pytest.mark.cuda


def _stack(plans):
    """The plans' arrays copied into a channel stack, as
    ``make_visibility_plan`` builds it (``stack_views`` per channel, then
    ``GridPlanStack.of``); the stack's channel plans are new views."""
    store = {}
    views = [
        dataclasses.replace(gp, **stack_views(
            store, len(plans), c, gp.n, **{k: getattr(gp, k) for k in STACKED}
        ))
        for c, gp in enumerate(plans)
    ]
    return GridPlanStack.of(store, views)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(dev, n=20000, npix=256, nplanes=4, wstacked=True):
    g = torch.Generator().manual_seed(5)
    u = torch.rand(n, generator=g, dtype=torch.float64) * (npix + 20) - 10
    v = torch.rand(n, generator=g, dtype=torch.float64) * (npix + 20) - 10
    p0 = torch.randint(0, nplanes - 1, (n,), generator=g)
    frac = torch.rand(n, generator=g, dtype=torch.float64)
    if not wstacked:
        p0 = frac = None
        nplanes = 1
    return make_grid_plan(
        u.to(dev), v.to(dev), None if p0 is None else p0.to(dev),
        None if frac is None else frac.to(dev),
        npixel=npix, nplanes=nplanes, tile=64, chunk=512,
    )


@pytest.mark.parametrize("wstacked", [True, False])
def test_grid_and_degrid_match_plain(dev, wstacked):
    plan = _plan(dev, wstacked=wstacked)
    g = torch.Generator(device=dev).manual_seed(6)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    out = grid(plan, vals)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _support_plan(dev, support, mode, n=30000, npix=256, nplanes=5, tile=64):
    """A plan at ``support`` with windows on every edge of the grid (and
    entries outside it): "linear" (plane pairs), "nearest" (one plane an
    entry) or "single"."""
    rng = np.random.default_rng(support)
    u = rng.uniform(-10, npix + 10, n)
    v = rng.uniform(-10, npix + 10, n)
    u[: n // 10] = rng.uniform(npix - support, npix, n // 10)  # last columns
    v[n // 10 : n // 5] = rng.uniform(npix - support, npix, n // 10)  # last rows
    p0 = torch.as_tensor(rng.integers(0, nplanes, n)).to(dev)
    frac = torch.as_tensor(rng.uniform(0, 1, n)).to(dev)
    if mode == "single":
        p0 = frac = None
        nplanes = 1
    elif mode == "nearest":
        frac = None
    return make_grid_plan(
        torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, frac,
        npixel=npix, support=support, nplanes=nplanes, tile=tile,
    )


@pytest.mark.parametrize("mode", ["linear", "nearest", "single"])
@pytest.mark.parametrize("support", [4, 6, 7, 12, 16])
def test_grid_and_degrid_at_supports_match_plain(dev, support, mode):
    """K1 and K3 at supports 4 to 16 and on nearest-plane plans against
    their plain versions (K1's accumulated in f64), to 1e-5 of the
    maximum; K1 gives the same bits on a second launch, and no window,
    on the last rows and columns of the grid, reaches past it."""
    plan = _support_plan(dev, support, mode)
    assert plan.nearest == (mode == "nearest") and plan.wstacked == (mode == "linear")
    g = torch.Generator(device=dev).manual_seed(support)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    out = grid(plan, vals)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(grid(plan, vals), out)
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support", [6, 12])
def test_degrid_stack_at_supports_matches_plain(dev, support, mode):
    """K3 over a stack of three channel plans at supports 6 and 12, linear
    and nearest, against the per-channel plain version, to 1e-5."""
    st = _stack([_support_plan(dev, support, mode, n=8000, npix=128)] * 3)
    g = torch.Generator(device=dev).manual_seed(support + 1)
    grids = torch.randn((3, st.nplanes, st.npixel, st.npixel), generator=g,
                        device=dev, dtype=torch.complex64)
    out = degrid_stack(st, grids)
    ref = degrid_stack_plain(st, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("wstacked", [True, False])
def test_grid_gives_the_same_bits_every_launch(dev, wstacked):
    """K1 accumulates in fixed point, so the order of its atomics (chunks
    of one segment, halos of neighbouring tiles, the groups of a CTA)
    cannot change the result: launches on the same inputs agree bit for
    bit."""
    plan = _plan(dev, wstacked=wstacked)
    g = torch.Generator(device=dev).manual_seed(7)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    first = grid(plan, vals)
    for _ in range(8):
        assert torch.equal(grid(plan, vals), first)


@pytest.mark.parametrize("faint", [1e-3, 1e-9])
def test_grid_error_is_relative_to_each_cell(dev, faint):
    """K1 accumulates in int64 units of at most 2^-60 of the launch's
    bound (the sum of |re| + |im| over vals times the plan's tap bound).
    Values to the left of the grid's middle are ``faint`` times those to
    its right: every cell is within 2e-6 of the sum of |contribution| it
    receives (its f32 register sums), plus 64 units (the rounding of its
    flushes, which shows only where a cell is ~1e-12 of the bound)."""
    plan = _plan(dev)
    g = torch.Generator(device=dev).manual_seed(8)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    left = plan.iu0.to(torch.float32) < plan.npixel / 2 - 16
    vals = torch.where(left, vals * faint, vals)
    ref = grid_plain(plan, vals.to(torch.complex128))
    size = torch.view_as_real(vals).abs().sum(-1).to(torch.complex128)
    mag = grid_plain(plan, size).real  # the taps are positive
    unit = float(size.real.sum()) * float(plan.tap_bound) * 2.0**-60
    out = grid(plan, vals)
    assert bool(((out - ref).abs() <= 2e-6 * mag + 64 * unit).all())
    # and the faint half to 1e-5 of its own maximum where the units allow
    if faint == 1e-3:
        cols = slice(0, plan.npixel // 2 - 16)
        err = (out - ref)[:, :, cols].abs().max()
        assert err <= 1e-5 * ref[:, :, cols].abs().max()


def test_grid_of_zeros_and_of_a_nan(dev):
    """All-zero values give zero grids; a NaN value gives NaN grids (the
    fixed-point bound is not finite), as a NaN reaches the plain version's
    image through the FFT."""
    plan = _plan(dev)
    vals = torch.zeros(plan.n, device=dev, dtype=torch.complex64)
    assert not grid(plan, vals).abs().max()
    vals[plan.n // 2] = float("nan")
    assert torch.isnan(grid(plan, vals)).all()


def _stress_coords(case, npix, rng, tile=64):
    """f64 pixel coordinates (u, v) of one stress case for the register
    gridders (grid, unit_tiles) on an npix^2 grid of ``tile``-pixel
    tiles."""
    if case == "one_cell":
        # every entry on one point: the longest register runs
        n = 20000
        return np.full(n, 100.3), np.full(n, 77.6)
    if case == "alternating":
        # two distant cells of one tile, in turn: a cell change per entry
        # in plan order
        n = 6000
        u = np.where(np.arange(n) % 2 == 0, tile + 3.2, 2 * tile - 2.1)
        v = np.where(np.arange(n) % 2 == 0, tile + 6.4, 2 * tile - 6.9)
        return u, v
    if case == "lattice":
        # one entry on every window corner of the grid: the most cell
        # changes in the kernels' walk order
        iv, iu = np.mgrid[3 : npix - 5, 3 : npix - 5]
        return iu.ravel() + 0.37, iv.ravel() + 0.61
    # windows on tile edges, in the halo and on the grid edges
    edges = np.concatenate([np.arange(0, npix, tile) + d for d in (-1.5, -0.5, 0.5, 3.2, 3.9)])
    edges = edges[(edges >= 3) & (edges <= npix - 5)]
    uu, vv = np.meshgrid(edges, edges)
    u, v = np.repeat(uu.ravel(), 5), np.repeat(vv.ravel(), 5)
    return u + rng.uniform(0, 0.1, u.size), v + rng.uniform(0, 0.1, v.size)


@pytest.mark.parametrize("wstacked", [True, False], ids=["wstacked", "one-plane"])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges", "chunked"])
def test_grid_stress_matches_plain(dev, case, wstacked):
    """K1 (register runs) against grid_plain accumulated in f64, to 1e-5
    of the grid maximum: long runs, a cell change per entry, windows on
    tile and grid edges, and chunk boundaries inside segments with empty
    segments between them (a chunk of 100 entries)."""
    _grid_stress(dev, case, wstacked, 64)


@pytest.mark.parametrize("wstacked", [True, False], ids=["wstacked", "one-plane"])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges", "chunked"])
@pytest.mark.parametrize("tile", [56, 8])
def test_grid_stress_other_tiles_match_plain(dev, tile, case, wstacked):
    """The stress cases of test_grid_stress_matches_plain at the tile's
    other row strides: tile 56 (buf 64, the main path's: XOR-swizzled
    rows) and tile 8 (buf 16: rows padded to 24)."""
    _grid_stress(dev, case, wstacked, tile)


@pytest.mark.parametrize("support", [4, 7, 12, 16])
@pytest.mark.parametrize("case", ["one_cell", "lattice", "edges", "chunked"])
def test_grid_stress_at_supports_match_plain(dev, case, support):
    """The stress cases of test_grid_stress_matches_plain, w-stacked, at
    the supports 4 and 7 (residue period 8: windows narrower than it, an
    odd one a cell wider where its spare cell lies in the tile) and 12
    and 16 (period 16: four groups of 256 threads a CTA)."""
    _grid_stress(dev, case, True, 64, support)


def _grid_stress(dev, case, wstacked, tile, support=8):
    rng = np.random.default_rng(23)
    npix, nplanes = 4 * tile if tile > 8 else 256, 4
    u, v = _stress_coords("edges" if case == "chunked" else case, npix, rng, tile)
    n = u.size
    if case == "chunked":
        u, v = u[: n // 3], v[: n // 3]  # segments of the first tile row only
        n = u.size
    p0 = torch.as_tensor(rng.integers(0, nplanes - 1, n)).to(dev) if wstacked else None
    frac = torch.as_tensor(rng.uniform(0, 1, n)).to(dev) if wstacked else None
    plan = make_grid_plan(
        torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, frac,
        npixel=npix, nplanes=nplanes if wstacked else 1, tile=tile,
        chunk=100 if case == "chunked" else None, support=support,
    )
    vals = rng.uniform(0.5, 1.5, n) * (1.0 + 0.5j) * np.exp(0.1j * rng.normal(size=n))
    vals = torch.as_tensor(vals.astype(np.complex64)).to(dev)
    before = kernels.KERNELS["grid"].launches
    out = grid(plan, vals)
    torch.cuda.synchronize()
    assert kernels.KERNELS["grid"].launches == before + 1
    ref = grid_plain(plan, vals.to(torch.complex128))
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("inverse", [False, True])
def test_permute_bit_exact(dev, inverse):
    n = 100003
    perm = torch.randperm(n, device=dev).to(torch.int32)
    a = torch.randn(n, device=dev)
    b = torch.randn(n, device=dev, dtype=torch.complex64)
    for x in (a, b):
        out = permute_apply(perm, x, inverse=inverse)
        ref = permute_apply_plain(perm, x, inverse=inverse)
        assert torch.equal(out, ref)
    # mixed f32 and complex64 payloads in one launch
    before = kernels.KERNELS["permute"].launches
    out = permute_apply(perm, b, a, a, b, inverse=inverse)
    assert kernels.KERNELS["permute"].launches == before + 1
    ref = permute_apply_plain(perm, b, a, a, b, inverse=inverse)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def _channel_coords(kind, npix, n, rng, tile):
    """f64 pixel coordinates of one channel of a stack: on the window
    corners clipped at the grid edge (0 and npix - 8), wholly outside the
    grid (n_in 0), window corners in one tile (one long segment, so that
    a warp's 32 walk positions and its 4 groups' windows overlap), wholly
    inside (n_in n), or spread past its edges."""
    if kind == "dense":
        return rng.uniform(tile + 3, 2 * tile + 3, n), rng.uniform(tile + 3, 2 * tile + 3, n)
    if kind == "edges":
        lo, hi = rng.uniform(3, 4, n), rng.uniform(npix - 5, npix - 4, n)
        pick = rng.integers(0, 2, (2, n)) == 1
        return np.where(pick[0], lo, hi), np.where(pick[1], hi, lo)
    if kind == "outside":
        return rng.uniform(-40, -10, n), rng.uniform(npix + 10, npix + 40, n)
    if kind == "inside":
        return rng.uniform(8, npix - 9, n), rng.uniform(8, npix - 9, n)
    return rng.uniform(-10, npix + 10, n), rng.uniform(-10, npix + 10, n)


def _plan_stack(dev, nchan, tile, frac, n=3000, nplanes=4):
    """A stack of ``nchan`` channel plans on a (4 tile)^2 grid, channel
    kinds in turn edges, outside, dense, inside, spread; ``frac``
    "random", "zero" or "one" (w-stacked), or None (one plane)."""
    rng = np.random.default_rng(nchan * 100 + tile)
    npix = 4 * tile
    kinds = ("edges", "outside", "dense", "inside", "spread")
    plans = []
    for c in range(nchan):
        u, v = _channel_coords(kinds[c % len(kinds)], npix, n, rng, tile)
        p0 = f = None
        if frac is not None:
            p0 = torch.as_tensor(rng.integers(0, nplanes - 1, n)).to(dev)
            f = {"random": torch.as_tensor(rng.uniform(0, 1, n)),
                 "zero": torch.zeros(n, dtype=torch.float64),
                 "one": torch.ones(n, dtype=torch.float64)}[frac].to(dev)
        plans.append(make_grid_plan(
            torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, f,
            npixel=npix, nplanes=nplanes if frac is not None else 1, tile=tile,
        ))
    return _stack(plans)


@pytest.mark.parametrize(
    "frac", ["random", "zero", "one", None],
    ids=["wstacked", "frac0", "frac1", "one-plane"],
)
@pytest.mark.parametrize("tile", [56, 64])
@pytest.mark.parametrize("nchan", [1, 3, 64])
def test_degrid_stack_matches_plain(dev, nchan, tile, frac):
    """K3 over a stack of channel plans in one launch against the
    per-channel plain version, to 1e-5 of the largest |value|: ragged
    n_in (0 and n among them, and warps of 32 walk positions that straddle
    n_in), clipped corners, one dense segment and entries spread over many,
    plane fractions 0 and 1; and on one channel's plan alone."""
    st = _plan_stack(dev, nchan, tile, frac)
    n_in = st.n_in.tolist()
    if nchan > 1:
        assert 0 in n_in and st.n in n_in
    g = torch.Generator(device=dev).manual_seed(nchan + tile)
    grids = torch.randn((nchan, st.nplanes, st.npixel, st.npixel), generator=g,
                        device=dev, dtype=torch.complex64)
    before = kernels.KERNELS["degrid"].launches
    out = degrid_stack(st, grids)
    torch.cuda.synchronize()
    assert kernels.KERNELS["degrid"].launches == before + 1
    ref = degrid_stack_plain(st, grids)
    assert out.shape == ref.shape == (nchan, st.n)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    for c, k in enumerate(n_in):
        assert not out[c, k:].any()
    one = degrid(st.plans[0], grids[0])
    assert (one - ref[0]).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mode", ["forward", "inverse", "shared"])
def test_permute_stack_bit_exact(dev, mode):
    """K4 over 64 channel permutations in one launch, bit-exact with the
    plain version: mixed f32 and complex64 payloads, and (forward) one
    [n] source shared by every channel."""
    nchan, n = 64, 10007
    perm = torch.stack([torch.randperm(n, device=dev) for _ in range(nchan)]).to(torch.int32)
    a = torch.randn((nchan, n), device=dev)
    b = torch.randn((nchan, n), device=dev, dtype=torch.complex64)
    f = torch.randn(n, device=dev, dtype=torch.complex64)
    payloads = (b, f, a, f.real.contiguous()) if mode == "shared" else (b, a, a, b)
    shared = (1, 3) if mode == "shared" else ()
    inverse = mode == "inverse"
    before = kernels.KERNELS["permute"].launches
    out = permute_apply(perm, *payloads, inverse=inverse, shared=shared)
    torch.cuda.synchronize()
    assert kernels.KERNELS["permute"].launches == before + 1
    ref = permute_apply_plain(perm, *payloads, inverse=inverse, shared=shared)
    for o, r in zip(out, ref, strict=True):
        assert o.shape == (nchan, n) and torch.equal(o, r)


@pytest.mark.parametrize("nchan", [1, 3], ids=["mfs-row", "channels"])
@pytest.mark.parametrize("mode", ["gather", "shared"])
def test_permute_polarisations_in_one_launch(dev, nchan, mode):
    """K4 moving the four polarisations of a cycle's leg in one launch,
    bit-exact with the plain version: the model's plan -> natural gather
    (four complex64 rows a channel) and the factors' natural -> plan move
    from four shared [n] sources, on one MFS row and on a channel stack."""
    n = 50021
    perm = torch.stack([torch.randperm(n, device=dev) for _ in range(nchan)]).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(nchan)
    if mode == "gather":
        xs = [torch.randn((nchan, n), generator=g, device=dev, dtype=torch.complex64)
              for _ in range(4)]
        shared = ()
    else:
        xs = [torch.randn(n, generator=g, device=dev, dtype=torch.complex64)
              for _ in range(4)]
        shared = (0, 1, 2, 3)
    before = kernels.KERNELS["permute"].launches
    out = permute_apply(perm, *xs, shared=shared)
    torch.cuda.synchronize()
    assert kernels.KERNELS["permute"].launches == before + 1
    ref = permute_apply_plain(perm, *xs, shared=shared)
    for o, r in zip(out, ref, strict=True):
        assert o.shape == (nchan, n) and torch.equal(o, r)


def test_grid_and_degrid_on_an_mfs_row_match_plain(dev):
    """K1 and K3 on the one plan of an MFS image (six channels of the
    small cube in one row, (time, baseline, channel) order): grid against
    the plain version accumulated in f64, degrid over the one-row stack
    against the plain version, both to 1e-5 of the maximum."""
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan

    cs = _chip_smoke()
    vis, cube = cs.simulate_cube(dev, **cs.SMALL_CUBE)
    model = cube.replace(pixels=cube.pixels[:1].clone(), frequency=cube.frequency[:1],
                         channel_bandwidth=cube.channel_bandwidth[:1])
    plan = make_visibility_plan(vis, model, context="ng")
    assert plan.mfs and plan.stack.perm.shape == (1, vis.ntimes * vis.nbaselines * vis.nchan)
    gp = plan.plans[0].gp
    vals = sort_values(gp, (vis.vis * vis.imaging_weight)[..., 0].reshape(-1))
    ref = grid_plain(gp, vals.to(torch.complex128))
    out = grid(gp, vals)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    grids = torch.randn((1, gp.nplanes, gp.npixel, gp.npixel), device=dev,
                        dtype=torch.complex64)
    ref = degrid_stack_plain(plan.stack, grids)
    out = degrid_stack(plan.stack, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_stack_kernels_refuse_bad_inputs(dev):
    """Mismatched shapes, a misaligned tap view and planes too large for
    the kernel's 32-bit window offsets raise before a launch."""
    st = _plan_stack(dev, 3, 64, "random")
    grids = torch.zeros((3, st.nplanes, st.npixel, st.npixel), device=dev,
                        dtype=torch.complex64)
    with pytest.raises(ValueError, match="grids: shape"):
        degrid_stack(st, grids[:2])
    with pytest.raises(ValueError, match="grids: shape"):
        degrid(st.plans[0], grids[0, :1])
    gp = st.plans[1]
    spill = torch.empty(gp.ku.numel() + 1, device=dev)
    ku = spill[1:].view(gp.ku.shape)
    ku.copy_(gp.ku)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        degrid(dataclasses.replace(gp, ku=ku), grids[1])
    # planes whose window offsets pass int32 (a zero-stride grid stands in)
    big = torch.zeros((), device=dev, dtype=torch.complex64).expand(8, 16384, 16384)
    with pytest.raises(ValueError, match="exceeds int32"):
        degrid(dataclasses.replace(gp, npixel=16384, nplanes=8), big)
    x = torch.zeros(st.n, device=dev)
    with pytest.raises(ValueError, match="payload 0 shape"):
        permute_apply(st.perm, x)
    with pytest.raises(ValueError, match="shared source"):
        permute_apply(st.perm, x, inverse=True, shared=(0,))
    with pytest.raises(ValueError, match="payload 0 shape"):
        permute_apply(st.perm, x[1:], shared=(0,))
    with pytest.raises(ValueError, match="payload 0 shape"):
        permute_apply(st.perm[0], torch.zeros((3, st.n), device=dev))


def _clean_inputs(ny=128, py=64, seed=9):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:py, :py] - py // 2
    psf = np.exp(-(x**2 + y**2) / 8.0).astype(np.float32)
    dirty = 0.01 * rng.normal(size=(ny, ny)).astype(np.float32)
    for _ in range(4):
        cy, cx = rng.integers(0, ny, 2)
        dirty[max(cy - 3, 0) : cy + 3, max(cx - 3, 0) : cx + 3] += 1.0
    return dirty, psf


def _same(out, ref):
    for o, r in zip(out, ref):
        o = o.cpu()
        torch.testing.assert_close(o, r, rtol=0.0, atol=1e-6 * float(r.abs().max()))


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_hogbom_matches_plain(dev, window):
    dirty, psf = _clean_inputs()
    d = torch.as_tensor(dirty, device=dev)[None].contiguous()
    p = torch.as_tensor(psf, device=dev)[None].contiguous()
    w = None
    if window:
        w = torch.zeros_like(d)
        w[:, 20:100, 30:110] = 1.0
    kw = dict(gain=0.2, thresh=0.0, niter=300, fracthresh=0.01)
    before = kernels.KERNELS["hogbom"].launches
    comps, res = hogbom_lanes(d, p, w, **kw)
    assert kernels.KERNELS["hogbom"].launches == before + 1
    rc, rr = hogbom_lanes(d.cpu(), p.cpu(), None if w is None else w.cpu(), **kw)
    comps, res = comps.cpu(), res.cpu()
    assert torch.equal(comps != 0, rc != 0)
    torch.testing.assert_close(comps, rc, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(res, rr, rtol=0.0, atol=1e-6 * float(rr.abs().max()))


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_hogbom_complex_matches_plain(dev, window):
    dq, psf = _clean_inputs(seed=10)
    du = 0.6 * np.roll(dq, 7, axis=0)
    q, u, p = (torch.as_tensor(a, device=dev)[None].contiguous() for a in (dq, du, psf))
    w = None
    if window:
        w = torch.zeros_like(q)
        w[:, 10:90, 30:120] = 1.0
    kw = dict(gain=0.2, thresh=0.0, niter=200, fracthresh=0.01)
    before = kernels.KERNELS["hogbom_complex"].launches
    out = cleaners.hogbom_complex_lanes(q, u, p, w, **kw)
    assert kernels.KERNELS["hogbom_complex"].launches == before + 1
    ref = cleaners.hogbom_complex_lanes(
        q.cpu(), u.cpu(), p.cpu(), None if w is None else w.cpu(), **kw
    )
    assert torch.equal(out[0].cpu() != 0, ref[0] != 0)
    _same(out, ref)


def _resident(kind):
    return kernels.query("ska_hogbom_resident", kind)


def _hogbom_case(case, kind):
    """(dirty [lanes, ny, nx], psf [lanes, py, px], window or None, kw) of
    a Hogbom stress case: lane counts from every resident CTA on one lane
    to one CTA per lane in two launches, ties across CTA bands, footprints
    clipped at corners and edges, PSF patches of 2 ny, a stop at the first
    iteration, a window inside one band, a band height that does not divide
    ny."""
    nl, ny, nx, py, niter, seed = 1, 128, 128, 64, 300, 21
    thresh, bumps, window = 0.0, None, None
    if case == "lanes3":
        nl = 3
    elif case == "lanes200":
        nl, ny, nx, py, niter = 200, 64, 64, 32, 60
    elif case == "lanes_over_resident":
        nl, ny, nx, py, niter = _resident(kind) + 5, 32, 32, 16, 30
    elif case == "tie":  # equal peaks in rows 10 and 90: (10, 50) first
        bumps = [(90, 20), (10, 100), (10, 50)]
    elif case == "edges":
        bumps = [(0, 0), (127, 127), (0, 64), (64, 127), (127, 3)]
    elif case == "psf_2ny":
        py = 256
    elif case == "stop0":
        thresh = 100.0
    elif case == "window_band":
        window = (slice(40, 41), slice(10, 100))
    elif case == "ragged":
        # the smallest ny > resident / 2 whose band height does not divide it
        res = _resident(kind) // 2
        ny = next(n for n in range(res + 1, 4 * res)
                  if n % cleaners.hogbom_split(2, n, _resident(kind))[2])
        nl, nx = 2, 48
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:py, :py] - py // 2
    psf = np.exp(-(xx**2 + yy**2) / 8.0).astype(np.float32)
    if bumps is None:
        dirty = 0.01 * rng.normal(size=(nl, ny, nx)).astype(np.float32)
        for lane in range(nl):
            for _ in range(4):
                cy, cx = rng.integers(0, ny, 1)[0], rng.integers(0, nx, 1)[0]
                dirty[lane, max(cy - 3, 0) : cy + 3, max(cx - 3, 0) : cx + 3] += (
                    rng.uniform(0.5, 1.5)
                )
    else:
        dirty = np.zeros((nl, ny, nx), np.float32)
        for by, bx in bumps:
            dirty[:, by, bx] = 1.0
    win = None
    if window is not None:
        win = np.zeros((nl, ny, nx), np.float32)
        win[:, window[0], window[1]] = 1.0
    kw = dict(gain=0.2, thresh=thresh, niter=niter, fracthresh=0.01)
    return dirty, np.broadcast_to(psf, (nl, py, py)).copy(), win, kw


HOGBOM_CASES = ["lanes1", "lanes3", "lanes200", "lanes_over_resident", "tie",
                "edges", "psf_2ny", "stop0", "window_band", "ragged"]


@pytest.mark.parametrize("case", HOGBOM_CASES)
def test_hogbom_grid_loop_matches_plain(dev, case):
    """K5 on its cooperative grid against the plain loop: identical
    component positions, values and residuals to 1e-6 relative, one
    counted launch per call."""
    dirty, psf, win, kw = _hogbom_case(case, 0)
    d, p = (torch.as_tensor(a, device=dev) for a in (dirty, psf))
    w = None if win is None else torch.as_tensor(win, device=dev)
    before = kernels.KERNELS["hogbom"].launches
    comps, res = hogbom_lanes(d, p, w, **kw)
    assert kernels.KERNELS["hogbom"].launches == before + 1
    rc, rr = hogbom_lanes(d.cpu(), p.cpu(), None if w is None else w.cpu(), **kw)
    comps, res = comps.cpu(), res.cpu()
    assert torch.equal(comps != 0, rc != 0)
    torch.testing.assert_close(comps, rc, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(res, rr, rtol=0.0, atol=1e-6 * float(rr.abs().max()))
    if case == "tie":  # the first index of three equal peaks comes first
        first, _ = hogbom_lanes(d, p, w, **{**kw, "niter": 1})
        assert torch.equal(first[0].nonzero().cpu(), torch.tensor([[10, 50]]))
    if case == "stop0":
        assert int((comps != 0).sum()) == 1
    if case == "window_band":
        assert float(comps[:, :40].abs().max()) == 0.0
        assert float(comps[:, 41:].abs().max()) == 0.0


@pytest.mark.parametrize("case", HOGBOM_CASES)
def test_hogbom_complex_grid_loop_matches_plain(dev, case):
    """K6 on the same cases, U a shifted copy of Q: identical component
    positions, values and residuals to 1e-6 of their maxima."""
    dq, psf, win, kw = _hogbom_case(case, 1)
    du = 0.6 * np.roll(dq, 7, axis=1)
    if case == "tie":
        du = np.zeros_like(dq)
    q, u, p = (torch.as_tensor(a, device=dev) for a in (dq, du, psf))
    w = None if win is None else torch.as_tensor(win, device=dev)
    before = kernels.KERNELS["hogbom_complex"].launches
    out = cleaners.hogbom_complex_lanes(q, u, p, w, **kw)
    assert kernels.KERNELS["hogbom_complex"].launches == before + 1
    ref = cleaners.hogbom_complex_lanes(
        q.cpu(), u.cpu(), p.cpu(), None if w is None else w.cpu(), **kw
    )
    assert torch.equal(out[0].cpu() != 0, ref[0] != 0)
    _same(out, ref)
    if case == "tie":
        first = cleaners.hogbom_complex_lanes(q, u, p, w, **{**kw, "niter": 1})[0]
        assert torch.equal(first[0].nonzero().cpu(), torch.tensor([[10, 50]]))
    if case == "stop0":
        assert int((out[0] != 0).sum()) == 1


def test_hogbom_refuses_a_grid_larger_than_resident(dev):
    """A cooperative grid that cannot be resident is refused, and the
    wrapper raises: no smaller grid and no plain version is taken."""
    d = torch.zeros((1, 64, 64), device=dev)
    p = torch.ones((1, 8, 8), device=dev)
    rows = torch.empty((1, 10, 4), device=dev)
    scratch = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    too_many = _resident(0) + 1
    with pytest.raises(RuntimeError, match="kernel hogbom failed"):
        kernels.KERNELS["hogbom"].launch(
            d.data_ptr(), p.data_ptr(), None, torch.empty_like(d).data_ptr(),
            rows.data_ptr(), scratch.data_ptr(), 1, 1, too_many, 1, 64, 64, 8, 8,
            10, 0.2, 0.0, 0.01,
        )


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window+sensitivity"])
def test_msclean_matches_plain(dev, window):
    dirty, psf = _clean_inputs(ny=128, py=128, seed=11)
    d = torch.as_tensor(dirty, device=dev)
    p = torch.as_tensor(psf, device=dev)
    w = s = None
    if window:
        w = torch.zeros_like(d)
        w[16:112, 8:100] = 1.0
        s = torch.linspace(0.5, 1.5, 128 * 128, device=dev).reshape(128, 128)
    kw = dict(gain=0.2, thresh=0.0, niter=120, fracthresh=0.01)
    st = cleaners.msclean_psf_stacks(p, 128, 128, (0, 3, 10, 30))
    before = kernels.KERNELS["msclean"].launches
    out = cleaners.msclean_with_stacks(st, d, w, s, **kw)
    assert kernels.KERNELS["msclean"].launches == before + 1
    st_cpu = cleaners.MSCleanStacks(*(t.cpu() for t in st))
    ref = cleaners.msclean_with_stacks(
        st_cpu, d.cpu(), None if w is None else w.cpu(), None if s is None else s.cpu(), **kw
    )
    assert torch.equal(out[0].cpu() != 0, ref[0] != 0)
    _same(out, ref)


def _bit_equal(out, ref):
    for o, r in zip(out, ref):
        o = o.cpu()
        assert bool(torch.isfinite(r).all())
        assert torch.equal(o, r), float((o - r).abs().max())


def _split(symbol, variant, nl, ny, row_bytes, dev):
    """The launch split the wrapper takes on this card (clean_split)."""
    return cleaners.clean_split(
        nl, ny, row_bytes, lambda smem: cleaners._resident(symbol, dev, *variant, smem)
    )


def _gauss(n, sigma2=8.0):
    y, x = np.mgrid[:n, :n] - n // 2
    return np.exp(-(x**2 + y**2) / sigma2).astype(np.float32)


def _bumps(rng, nl, ny, nx, margin=0):
    out = 0.01 * rng.normal(size=(nl, ny, nx)).astype(np.float32)
    for lane in range(nl):
        for _ in range(4):
            cy = rng.integers(margin, ny - margin)
            cx = rng.integers(margin, nx - margin)
            out[lane, max(cy - 3, 0) : cy + 3, max(cx - 3, 0) : cx + 3] += rng.uniform(0.5, 1.5)
    return out


MSCLEAN_CASES = ["lanes1", "lanes3", "lanes_over_resident", "stop0", "all_niter",
                 "window_sens", "device_band"]


def _msclean_case(case, dev):
    """(res_stack, psf_ss, coupling_diag, pscalestack, windowstack,
    sensitivity, kw) of an msclean stress case, f32 on the CPU: one and
    three lanes, more lanes than resident CTAs (two launches), a stop at
    iteration 0, a loop that uses all of niter, a window stack with a
    sensitivity image, and a 4 x 2048^2 stack whose bands stay in device
    memory."""
    nl, n, pn, scales, niter = 1, 128, 64, (0, 3, 10, 30), 120
    kw = dict(gain=0.2, thresh=0.0, fracthresh=0.01)
    if case == "lanes3":
        nl = 3
    elif case == "lanes_over_resident":
        nl = kernels.query("ska_msclean_resident", 0, 0) + 5
        n, pn, scales, niter = 16, 8, (0, 3), 8
    elif case == "stop0":
        kw["thresh"] = 100.0
    elif case == "all_niter":
        kw["fracthresh"], niter = 0.0, 60
    elif case == "device_band":
        n, niter = 2048, 4
    rng = np.random.default_rng(31)
    st = cleaners.msclean_psf_stacks(torch.as_tensor(_gauss(pn)), n, n, scales)
    dirty = torch.as_tensor(_bumps(rng, nl, n, n))
    res_stack = torch.stack(
        [cleaners.convolve_scalestack(st.scalestack, d / st.pmax) for d in dirty]
    ).float().contiguous()
    ns = len(scales)
    win = sens = None
    if case == "window_sens":
        win = torch.zeros((nl, ns, n, n))
        win[:, :, 16:112, 8:100] = 1.0
        win[:, 1:, 40:60] = 0.0
        sens = torch.linspace(0.5, 1.5, n * n).reshape(1, n, n)
    lanes = lambda t: t[None].expand(nl, *t.shape).contiguous()  # noqa: E731
    return (res_stack, lanes(st.psf_ss), lanes(st.coupling_diag), lanes(st.pscalestack),
            win, sens, dict(kw, niter=niter))


@pytest.mark.parametrize("case", MSCLEAN_CASES)
def test_msclean_loop_matches_plain(dev, case):
    """K7 on its cooperative grid against the plain loop on the same f32
    stacks: rows, residual stacks and the kernel's component images
    bit for bit (the images against msclean_rows_to_comps of the plain
    rows), one counted launch per call."""
    args = _msclean_case(case, dev)
    *stacks, kw = args
    nl, ns, n, _ = stacks[0].shape
    variant = (int(stacks[4] is not None) + 2 * int(stacks[5] is not None),)
    per_launch, _, _, smem = _split("ska_msclean_resident", variant, nl, n,
                                    4 * (ns + 1) * n, dev)
    if case == "lanes_over_resident":
        assert per_launch < nl
    assert (smem == 0) == (case == "device_band")
    on_card = [None if t is None else t.to(dev) for t in stacks]
    before = kernels.KERNELS["msclean"].launches
    out = cleaners.msclean_lanes(*on_card, **kw)
    assert kernels.KERNELS["msclean"].launches == before + 1
    ref = cleaners.msclean_lanes(*stacks, **kw)
    _bit_equal(out, ref)
    used = (ref[0][..., 4] > 0).sum(dim=-1)
    if case == "stop0":
        assert int(used.max()) == 0 and float(out[2].abs().max()) == 0.0
    elif case == "all_niter":
        assert bool((used == kw["niter"]).all())
    else:
        assert int(used.min()) > 0


def test_msclean_ties_go_to_the_first_index(dev):
    """Exact ties within a band and across a band boundary: unit coupling,
    a delta PSF per scale, equal peaks at the last row of band 0 (columns 6
    and 7), the first row of band 1 and scale 1's (0, 0); each pick clears
    only its own pixel, and the kernel picks in (scale, y, x) order, as the
    plain version does, bit for bit."""
    ns, n, pn = 2, 40, 16
    band = _split("ska_msclean_resident", (0,), 1, n, 4 * (ns + 1) * n, dev)[2]
    assert band < n
    res = torch.zeros((1, ns, n, n))
    for s, y, x in ((1, 0, 0), (0, band, 3), (0, band - 1, 7), (0, band - 1, 6)):
        res[0, s, y, x] = 1.0
    psf_ss = torch.zeros((1, ns, ns, pn, pn))
    blobs = torch.zeros((1, ns, pn, pn))
    for s in range(ns):
        psf_ss[0, s, s, pn // 2, pn // 2] = 1.0
        blobs[0, s, pn // 2, pn // 2] = 1.0
    cd = torch.ones((1, ns))
    kw = dict(gain=1.0, thresh=0.0, fracthresh=0.01, niter=6)
    before = kernels.KERNELS["msclean"].launches
    out = cleaners.msclean_lanes(res.to(dev), psf_ss.to(dev), cd.to(dev), blobs.to(dev), **kw)
    assert kernels.KERNELS["msclean"].launches == before + 1
    ref = cleaners.msclean_lanes(res, psf_ss, cd, blobs, **kw)
    _bit_equal(out, ref)
    picks = [tuple(int(v) for v in r[:3]) for r in out[0][0].cpu() if r[4] > 0]
    assert picks == [(band - 1, 6, 0), (band - 1, 7, 0), (band, 3, 0), (0, 0, 1)]


@pytest.mark.parametrize("algorithm", ["hogbom-complex", "msclean"])
def test_deconvolve_cube_window_on_card_matches_cpu(dev, algorithm):
    """deconvolve_cube with the quarter window on the card (kernels) and on
    the CPU (plain versions): identical component positions, values to
    1e-5 of the maximum (msclean's scale stacks come from cuFFT on the
    card)."""
    from ska_sdp_func_python_torch.models.image import create_image
    from ska_sdp_func_python_torch.ops.deconvolution import deconvolve_cube

    dirty, psf = _clean_inputs(ny=96, py=96, seed=12)
    frame = "stokesIQUV" if algorithm == "hogbom-complex" else "stokesI"
    npol = 4 if frame == "stokesIQUV" else 1
    scale = np.array([1.0, 0.17, 0.1, 0.02])[:npol, None, None]
    out = {}
    for d in (dev, torch.device("cpu")):
        im = create_image(96, 0.001, (0.0, -0.6), polarisation_frame=frame, device=d)
        di = im.replace(pixels=torch.as_tensor(scale * dirty[None], dtype=torch.float32, device=d)[None])
        ps = im.replace(pixels=torch.as_tensor(np.broadcast_to(psf, (1, npol, 96, 96)).copy(), device=d))
        kernels.reset_launch_counts()
        out[d.type] = deconvolve_cube(
            di, ps, algorithm=algorithm, niter=40, gain=0.2,
            fractional_threshold=0.01, window_shape="quarter", scales=[0, 3, 10],
        )
        if d.type == "cuda":
            counts = kernels.launch_counts()
            names = ("hogbom", "hogbom_complex") if npol == 4 else ("msclean",)
            assert all(counts[n] > 0 for n in names), counts
    for a, b in zip(out["cuda"], out["cpu"]):
        a, b = a.pixels.cpu(), b.pixels
        assert torch.equal(a != 0, b != 0)
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5 * float(b.abs().max()))


def _moment_inputs(nmoment, n=96, seed=13, nchan=8, span=0.63, nl=1):
    """f32 moment images [nl, nmoment, n, n] and moment PSFs [2 nmoment, n,
    n] of an nchan-channel cube over 100 MHz to (1 + span) 100 MHz (PSF
    narrowing with frequency, sources with spectral indices), a different
    sky for each of the nl lanes."""
    rng = np.random.default_rng(seed)
    freq = np.linspace(1.0e8, 1.0e8 * (1.0 + span), nchan)
    f0 = freq[nchan // 2]
    x = (freq - f0) / f0
    yy, xx = np.mgrid[:n, :n] - n // 2
    psfs = np.stack([np.exp(-(yy**2 + xx**2) / (2.5 * f0 / f) ** 2) for f in freq])
    w = x[:, None] ** np.arange(2 * nmoment)[None, :]
    lanes = []
    margin = max(n // 12, 1)
    for _ in range(nl):
        dirty = 0.004 * rng.normal(size=(nchan, n, n))
        for _ in range(4):
            cy, cx = rng.integers(margin, n - margin, 2)
            alpha = rng.uniform(-1.5, 0.5)
            for c, f in enumerate(freq):
                dirty[c] += (f / f0) ** alpha * np.roll(psfs[c], (cy - n // 2, cx - n // 2), (0, 1))
        lanes.append(np.einsum("cm,cyx->myx", w[:, :nmoment], dirty))
    return (
        np.stack(lanes).astype(np.float32),
        np.einsum("cm,cyx->myx", w, psfs).astype(np.float32),
    )


def _msmfs_stacks(dirty, psf, scales, window):
    """The MSMFS stacks of ``msmfs_with_stacks`` in f32 on the CPU: the
    PSF's stacks, the scale-moment residuals [nl, ns, nm, ny, nx] and the
    window stack of a centred window, or None."""
    n = dirty.shape[-1]
    st = cleaners.msmfs_psf_stacks(torch.as_tensor(psf), n, n, scales)
    smres = torch.stack([
        cleaners.calculate_scale_moment_residual(torch.as_tensor(d) / st.pmax, st.scalestack)
        for d in dirty
    ]).float().contiguous()
    ws = None
    if window:
        w = torch.zeros((n, n))
        w[n // 4 + 1 : 3 * (n // 4), n // 4 + 1 : 3 * (n // 4)] = 1.0
        ws = (cleaners.convolve_scalestack(st.scalestack, w) > 0.9).float()
        ws = ws[None].expand(dirty.shape[0], *ws.shape).contiguous()
    return st, smres, ws


def _check_msmfs(dev, st, smres, ws, kw):
    """K8 against the plain loop on the same f32 stacks: rows, residuals
    and the kernel's moment models bit for bit (the models against
    msmfs_rows_to_model of the plain rows), one counted launch per call.
    Returns the kernel's outputs."""
    stacks = (smres, st.canvas, st.hsmm, st.ihsmm, st.pscalestack, ws)
    on_card = [None if t is None else t.to(dev) for t in stacks]
    before = kernels.KERNELS["msmfs"].launches
    out = cleaners.msmfs_lanes(*on_card, **kw)
    assert kernels.KERNELS["msmfs"].launches == before + 1
    _bit_equal(out, cleaners.msmfs_lanes(*stacks, **kw))
    return out


@pytest.mark.parametrize(
    "findpeak,window,nmoment",
    [("RASCIL", False, 3), ("CASA", False, 2), ("RASCIL", True, 3)],
    ids=["rascil", "casa", "rascil-window"],
)
def test_msmfs_matches_plain(dev, findpeak, window, nmoment):
    """K8 against msmfs_rows_plain on the same f32 stacks: the same rows,
    residual and moment model bit for bit, and one launch per call."""
    dirty, psf = _moment_inputs(nmoment)
    st, smres, ws = _msmfs_stacks(dirty, psf, (0, 3, 10), window)
    kw = dict(gain=0.5, thresh=0.0, fracthresh=0.03, niter=150, findpeak=findpeak)
    rows = _check_msmfs(dev, st, smres, ws, kw)[0]
    used = int((rows[0, :, 3] > 0).sum())
    assert 0 < used < 150


MSMFS_CASES = ["lanes3", "lanes_over_resident", "stop0", "all_niter", "casa_nm1",
               "casa_nm6", "rascil_nm6", "device_band"]


@pytest.mark.parametrize("case", MSMFS_CASES)
def test_msmfs_loop_matches_plain(dev, case):
    """K8's stress cases, bit for bit against the plain loop: three lanes
    in one call, more lanes than resident CTAs (two launches), a stop at
    iteration 0, a loop that uses all of niter, CASA's criterion at 1 and
    6 moments, RASCIL's at 6 with a window, and a 4 scales x 3 moments x
    1024^2 stack whose bands stay in device memory."""
    nm, n, scales, window, niter = 3, 96, (0, 3, 10), False, 150
    kw = dict(gain=0.5, thresh=0.0, fracthresh=0.03, findpeak="RASCIL")
    inputs = {}
    if case == "lanes3":
        inputs["nl"] = 3
    elif case == "lanes_over_resident":
        nm, n, scales, niter = 2, 16, (0, 3), 6
        inputs["nl"] = kernels.query("ska_msmfs_resident", nm, 0, 0) + 5
    elif case == "stop0":
        kw["thresh"] = 100.0
    elif case == "all_niter":
        kw["fracthresh"], niter = 0.0, 60
    elif case == "casa_nm1":
        nm, kw["findpeak"] = 1, "CASA"
    elif case in ("casa_nm6", "rascil_nm6"):
        nm, niter, window = 6, 80, case == "rascil_nm6"
        inputs.update(nchan=16, span=1.0)
        if case == "casa_nm6":
            kw["findpeak"] = "CASA"
    elif case == "device_band":
        n, scales, niter = 1024, (0, 3, 10, 30), 4
    dirty, psf = _moment_inputs(nm, n=n, **inputs)
    if case == "device_band":
        psf = psf[:, n // 2 - 64 : n // 2 + 64, n // 2 - 64 : n // 2 + 64].copy()
    st, smres, ws = _msmfs_stacks(dirty, psf, scales, window)
    nl, ns = smres.shape[:2]
    casa = int(kw["findpeak"] == "CASA")
    per_launch, _, _, smem = _split("ska_msmfs_resident", (nm, casa), nl, n,
                                    4 * (ns + 1) * nm * n, dev)
    if case == "lanes_over_resident":
        assert per_launch < nl
    assert (smem == 0) == (case == "device_band")
    rows = _check_msmfs(dev, st, smres, ws, dict(kw, niter=niter))[0].cpu()
    used = (rows[..., 3] > 0).sum(dim=-1)
    if case == "stop0":
        assert int(used.max()) == 0
    elif case == "all_niter":
        assert bool((used == niter).all())
    else:
        assert int(used.min()) > 0


def test_msmfs_ties_go_to_the_first_index(dev):
    """Exact ties across the kernel's bands and scales: unit Hessians, equal
    peaks at (31, 2), (30, 31) and (30, 30) of scale 1 and (5, 5) of
    scale 2, each pick clearing only its own pixel, rows 30 and 31 in
    different bands; the kernel picks in (scale, y, x) order, as the plain
    version does, bit for bit."""
    ns, nm, n, pn = 3, 2, 40, 16
    band = _split("ska_msmfs_resident", (nm, 0), 1, n, 4 * (ns + 1) * nm * n, dev)[2]
    assert 30 // band != 31 // band
    smres = torch.zeros((1, ns, nm, n, n))
    for s, y, x in ((2, 5, 5), (1, 31, 2), (1, 30, 31), (1, 30, 30)):
        smres[0, s, 0, y, x] = 1.0
    canvas = torch.zeros((ns, ns, 2 * nm - 1, pn, pn))
    blobs = torch.zeros((ns, pn, pn))
    for s in range(ns):
        canvas[s, s, :, pn // 2, pn // 2] = 1.0
        blobs[s, pn // 2, pn // 2] = 1.0
    eye = torch.eye(nm).expand(ns, nm, nm).contiguous()
    kw = dict(gain=1.0, thresh=0.0, fracthresh=0.01, niter=4)
    args = (smres, canvas, eye, eye, blobs)
    before = kernels.KERNELS["msmfs"].launches
    out = cleaners.msmfs_lanes(*(t.to(dev) for t in args), **kw)
    assert kernels.KERNELS["msmfs"].launches == before + 1
    _bit_equal(out, cleaners.msmfs_lanes(*args, **kw))
    picks = [tuple(int(v) for v in r[:3]) for r in out[0][0].cpu()]
    assert picks == [(30, 30, 1), (30, 31, 1), (31, 2, 1), (5, 5, 2)]


def _unit_stream(case, dtype, with_lo, dev):
    """A tiled-gridder entry stream on ``dev`` in ``dtype`` (hi, lo pairs
    of f64 positions for f32), and the same stream in f64 for the plain
    version. Four linear w-planes at 256^2, tile 64."""
    rng = np.random.default_rng(17)
    npix = 256
    if case == "random":
        n = 20000
        u64 = rng.uniform(-10, npix + 10, n)
        v64 = rng.uniform(-10, npix + 10, n)
        # integer hi with a negative residual: the tap window starts one
        # cell lower than the hi coordinate's
        u64[:200] = np.round(u64[:200]) - 3e-6
        v64[100:300] = np.round(v64[100:300]) - 3e-6
    elif case == "one_segment":
        n = 3000
        u64, v64 = np.full(n, 43.3), np.full(n, 77.7)
    elif case == "single":
        n = 1
        u64, v64 = np.asarray([30.2]), np.asarray([99.9])
    else:
        n = 500
        u64 = rng.uniform(-400, -100, n)
        v64 = rng.uniform(npix + 100, npix + 400, n)
    p0 = rng.integers(0, 3, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    if dtype == torch.float32:
        u, v = u64.astype(np.float32), v64.astype(np.float32)
        ulo, vlo = (u64 - u).astype(np.float32), (v64 - v).astype(np.float32)
        vals = vals.astype(np.complex64)
    else:
        u, v = u64.copy(), v64.copy()
        if case == "random":
            u[:200], v[100:300] = np.round(u[:200]), np.round(v[100:300])
        ulo = np.where(np.arange(n) < 300, -2e-9, rng.uniform(-1e-9, 1e-9, n))
        vlo = ulo.copy()
    if not with_lo:
        ulo = vlo = None
    out = []
    for d, dt in ((dev, dtype), (dev, torch.float64)):
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.float64)).to(d, dt)
        cd = torch.complex128 if dt == torch.float64 else torch.complex64
        out.append(entry_stream(
            t(u), t(v), torch.as_tensor(vals).to(d, cd), torch.as_tensor(p0).to(d),
            t(frac), t(ulo), t(vlo), npixel=npix, support=8, nplanes=4, tile=64,
            unit=256,
        ))
    return out


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "one_segment", "single", "all_outside"])
def test_unit_tiles_matches_plain(dev, case, dtype, with_lo):
    """K9 against unit_tiles_plain accumulated in f64: f32 to 1e-5 of the
    grid maximum, f64 to 1e-12; one launch per stream with units."""
    stream, ref_stream = _unit_stream(case, dtype, with_lo, dev)
    kw = dict(npixel=256, tile=64, support=8, beta=16.0)
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    nunits = int(stream.unit_seg.shape[0])
    assert kernels.KERNELS["unit_tiles"].launches == before + (1 if nunits else 0)
    ref = ref_stream.grid(plain=True, **kw)
    assert out.dtype == (torch.complex64 if dtype == torch.float32 else torch.complex128)
    if case == "all_outside":
        assert nunits == 0 and not out.abs().max() > 0 and not ref.abs().max() > 0
        return
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (out.to(torch.complex128) - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support", [6, 8, 12, 16])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges"])
def test_unit_tiles_stress_matches_plain(dev, case, support, dtype, with_lo):
    """K9 (register runs) against unit_tiles_plain accumulated in f64, f32
    to 1e-5 of the grid maximum and f64 to 1e-12, at supports 6 and 8 (the
    main path's) and 12 and 16 (the deep-f64-s12 and -s16 rows: two groups
    and one group of a CTA): the longest runs, a cell change per entry,
    windows on tile and grid edges;
    a fifth of the coordinates are integers with a negative residual (the
    tap window one cell lower)."""
    rng = np.random.default_rng(29)
    npix = 256
    u64, v64 = _stress_coords(case, npix, rng)
    n = u64.size
    ints = np.arange(n) % 5 == 0
    u64 = np.where(ints, np.round(u64), u64)
    v64 = np.where(ints, np.round(v64), v64)
    lo = np.where(ints, -3e-9 if dtype == torch.float64 else -3e-6, 0.0)
    p0 = rng.integers(0, 3, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.uniform(0.5, 1.5, n) * (1.0 + 0.5j) * np.exp(0.1j * rng.normal(size=n))
    if dtype == torch.float32:
        u, v = u64.astype(np.float32), v64.astype(np.float32)
        vals = vals.astype(np.complex64)
    else:
        u, v = u64, v64
    ulo = vlo = lo if with_lo else None
    streams = []
    for dt in (dtype, torch.float64):
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.float64)).to(dev, dt)
        cd = torch.complex128 if dt == torch.float64 else torch.complex64
        streams.append(entry_stream(
            t(u), t(v), torch.as_tensor(vals).to(dev, cd), torch.as_tensor(p0).to(dev),
            t(frac), t(ulo), t(vlo), npixel=npix, support=support, nplanes=4,
            tile=64, unit=256,
        ))
    stream, ref_stream = streams
    kw = dict(npixel=npix, tile=64, support=support, beta=2.3 * support)
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["unit_tiles"].launches == before + 1
    ref = ref_stream.grid(plain=True, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (out.to(torch.complex128) - ref).abs().max() <= tol * ref.abs().max()


def _chip_smoke():
    """``chip_smoke.py`` at the checkout's root: its small calibration
    slices run the same observation on any device."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def test_composed_tg_ical_with_component_on_card_matches_cpu(dev):
    cs = _chip_smoke()
    ga, _, ra, _, _, counts = cs.tg_slice(dev)
    assert all(counts[k] > 0 for k in ("grid", "degrid", "permute", "hogbom")), counts
    gb, _, rb, _, _, _ = cs.tg_slice("cpu")
    cs.slices_agree("composed TG", ga, ra, gb, rb)


def test_fused_tb_cube_on_card_matches_cpu(dev):
    cs = _chip_smoke()
    ga, ra, counts = cs.tb_slice(dev)
    assert all(counts[k] > 0 for k in ("grid", "degrid", "permute", "hogbom")), counts
    gb, rb, _ = cs.tb_slice("cpu")
    cs.slices_agree("fused TB cube", ga, ra, gb, rb)


def test_full_jones_mfs_ical_on_card_matches_cpu(dev):
    """The "matrix" "T" + "B" chain imaged MFS (chip_smoke phase 11d)."""
    _chip_smoke().small_jones_slice(dev)


def test_streamed_ical_on_card_matches_cpu(dev):
    """``streamed_ical`` over a store of phase 7's small observation, on the
    card and on the CPU (chip_smoke phase 12d): gains 1e-4, peak residual
    1e-3 relative; the card's run launches grid, permute and hogbom in
    every cycle and degrid from the second."""
    from ska_sdp_func_python_torch import kernels

    cs = _chip_smoke()
    kernels.reset_launch_counts()
    cs.streamed_card_vs_cpu(dev)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("grid", "degrid", "permute", "hogbom")), counts
