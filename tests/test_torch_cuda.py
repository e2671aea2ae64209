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
launch, at supports 2 to 64 (the wide variants past 16 and on tiles the
narrow kernel cannot hold, up to 512), past 64 (K1's route 4,
K3's long-window kernel, its windows straddling the bands it stages, on
dense and sparse streams) and on tiles no cluster holds, and on linear,
nearest-plane and single-plane plans; ``unit_tiles`` (fixed-point sums:
int64 in f32, a 128-bit pair in f64, the same bits from launch to launch)
agrees with its plain version accumulated in f64 to 1e-5 of the grid
maximum in f32 and to 1e-12 in f64, at even supports to 16 and, through
its wide variant, at odd ones, up to 64 and on tiles up to 512, and
through its route 4 at support 1, past 64 (f32 against the plain version
in f32, whose taps it shares), on tiles no cluster holds a window of
(windows straddling its sub-tiles and bands, sparse streams, f64 sums
whose low words carry) and past the largest window a cluster holds. The route queries take every support on every tile. The calibration paths (the composed "TG" ical with a sky component,
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
    grid_convert,
    grid_convert_plain,
    grid_plain,
    grid_vsum,
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


def test_grid_raw_route_sums_shards_exactly(dev):
    """The sharded invert's route of K1: the int64 planes (``raw=True``)
    converted on their own give the launch's own grids bit for bit, and
    the conversion equals its plain version; the values split over 4
    shards, each gridded at the global bound (the sum of the shards'
    vsums, the plan's tap bound), sum in int64 to the same bits in any
    order, within 1e-5 of the whole stream's grids."""
    plan = _plan(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    own = (grid_vsum(vals), plan.tap_bound)
    raw = grid(plan, vals, raw=True, bound=own)
    assert raw.dtype == torch.int64 and raw.shape[-1] == 2
    whole = grid(plan, vals)
    assert torch.equal(grid_convert(raw, own), whole)
    assert torch.equal(grid_convert_plain(raw.cpu(), tuple(t.cpu() for t in own)), whole.cpu())
    shard = torch.arange(plan.n, device=dev) % 4
    parts = [torch.where(shard == d, vals, 0) for d in range(4)]
    vsum = grid_vsum(parts[0]) + grid_vsum(parts[1]) + grid_vsum(parts[2]) + grid_vsum(parts[3])
    bound = (vsum, plan.tap_bound)
    raws = [grid(plan, p, raw=True, bound=bound) for p in parts]
    a = ((raws[0] + raws[1]) + raws[2]) + raws[3]
    b = raws[3] + (raws[1] + (raws[2] + raws[0]))
    assert torch.equal(a, b)
    out = grid_convert(a, bound)
    assert (out - whole).abs().max() <= 1e-5 * whole.abs().max()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_unit_tiles_gives_the_same_bits_every_launch(dev, dtype):
    """K9 sums in fixed point, so the order of its atomics does not show:
    two launches on the same stream (a few segments of 3000 entries on one
    cell each, many units on every tile) give the same bits, in f32 and in
    f64."""
    rng = np.random.default_rng(31)
    npix, n = 256, 60000
    u = np.concatenate([rng.uniform(4, npix - 4, n - 6000), np.full(3000, 43.3),
                        np.full(3000, 200.1)])
    v = np.concatenate([rng.uniform(4, npix - 4, n - 6000), np.full(3000, 77.7),
                        np.full(3000, 12.9)])
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    cd = torch.complex128 if dtype == torch.float64 else torch.complex64
    stream = entry_stream(
        torch.as_tensor(u).to(dev, dtype), torch.as_tensor(v).to(dev, dtype),
        torch.as_tensor(vals).to(dev, cd), torch.as_tensor(rng.integers(0, 3, n)).to(dev),
        torch.as_tensor(rng.uniform(0, 1, n)).to(dev, dtype), npixel=npix, support=8,
        nplanes=4, tile=64, unit=256,
    )
    kw = dict(npixel=npix, tile=64, support=8, beta=16.0)
    first = stream.grid(**kw)
    for _ in range(3):
        assert torch.equal(stream.grid(**kw), first)


@pytest.mark.parametrize("mode", ["linear", "nearest", "single"])
@pytest.mark.parametrize("support", [17, 24, 31, 32, 33, 48, 63, 64])
def test_grid_and_degrid_at_wide_supports_match_plain(dev, support, mode):
    """K1's and K3's wide variants (windows of 17 to 64 cells: residue
    period the span, the tile's rows in shared int64 over a cluster of
    CTAs; windows staged in shared memory, up to 8 entries of one corner
    row a pass, one or two columns a lane) against their plain versions on
    tile 64, to 1e-5 of the maximum; K1 gives the same bits on a second
    launch, and no window on the grid's last rows and columns reaches past
    it."""
    plan = _support_plan(dev, support, mode, n=6000)
    g = torch.Generator(device=dev).manual_seed(support)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    before = kernels.KERNELS["grid"].launches
    out = grid(plan, vals)
    torch.cuda.synchronize()
    assert kernels.KERNELS["grid"].launches == before + 1
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(grid(plan, vals), out)
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support", [24, 40])
def test_degrid_stack_at_wide_supports_matches_plain(dev, support, mode):
    """K3's wide variant over a stack of three channel plans, against the
    per-channel plain version, to 1e-5."""
    st = _stack([_support_plan(dev, support, mode, n=3000, npix=128)] * 3)
    g = torch.Generator(device=dev).manual_seed(support + 1)
    grids = torch.randn((3, st.nplanes, st.npixel, st.npixel), generator=g,
                        device=dev, dtype=torch.complex64)
    out = degrid_stack(st, grids)
    ref = degrid_stack_plain(st, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("support", [24, 64])
@pytest.mark.parametrize("case", ["one_cell", "lattice", "edges", "chunked"])
def test_grid_stress_at_wide_supports_match_plain(dev, case, support):
    """The stress cases of test_grid_stress_matches_plain, w-stacked, on
    K1's wide variant at periods 32 (support 24) and 64."""
    _grid_stress(dev, case, True, 64, support)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support", [31, 32])
def test_grid_and_degrid_wide_at_tile_32(dev, support, mode):
    """Windows of 32 cells on tiles of 32 (buf 64: K1's whole tile in one
    CTA) against the plain versions, to 1e-5 of the maximum."""
    plan = _support_plan(dev, support, mode, n=6000, tile=32)
    assert plan.span == 32 and plan.tile == 32
    g = torch.Generator(device=dev).manual_seed(support)
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


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support,tile", [(17, 256), (33, 256), (64, 256), (64, 512)])
def test_grid_and_degrid_wide_on_large_tiles_match_plain(dev, support, tile, mode):
    """Tiles whose int64 rows no cluster of K1's holds whole (256 and 512
    on linear plans, 512 on nearest-plane ones): K1 serves each run in
    turns of entries whose windows the bands' rows hold; 512 at span 64 is
    the largest such tile a linear plan takes. Against the plain versions,
    to 1e-5 of the maximum, with the same bits on a second launch."""
    plan = _support_plan(dev, support, mode, n=6000, npix=2 * tile, nplanes=3, tile=tile)
    nacc = 4 if mode == "linear" else 2
    rows = kernels.query("ska_grid_wide_geometry", plan.span, tile, nacc, 6)
    assert rows >= plan.span
    if mode == "linear" or tile == 512:
        assert rows < tile + plan.span  # the run is served in turns
    g = torch.Generator(device=dev).manual_seed(support + tile)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    out = grid(plan, vals)
    assert torch.equal(grid(plan, vals), out)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("support,tile", [(64, 1024), (8, 4096)])
def test_grid_refuses_a_tile_it_cannot_hold(dev, support, tile):
    """Past the largest tile a cluster serves: a linear plan's bands over
    a cluster of 8 hold fewer than one window's rows at span 64 on tile
    1024 and at span 8 on tile 4096, where K1 refused the tile until its
    route 4 took it (``ska_grid_route`` 4): against the plain
    version accumulated in f64, to 1e-5 of the maximum, with the same bits
    on a second launch; one launch a call."""
    plan = _support_plan(dev, support, "linear", n=2000, npix=tile, nplanes=3, tile=tile)
    assert kernels.query("ska_grid_wide_geometry", plan.span, tile, 4, 0) == 0
    assert kernels.query("ska_grid_route", plan.span, tile, 4) == 4
    g = torch.Generator(device=dev).manual_seed(support + tile)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    before = kernels.KERNELS["grid"].launches
    out = grid(plan, vals)
    assert torch.equal(grid(plan, vals), out)
    assert kernels.KERNELS["grid"].launches == before + 2
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("tile", [96, 128, 256])
@pytest.mark.parametrize("support", [2, 8, 16])
def test_grid_narrow_windows_on_large_tiles_match_plain(dev, support, tile, mode):
    """Windows of up to 16 cells on tiles of a 768^2 grid: where the
    narrow kernel holds the tile's int64 rows (96 on a nearest plan) it
    stays K1's route, elsewhere K1's wide variant takes them over a
    cluster's bands (in turns at 256 on a linear plan). Against the plain
    version accumulated in f64, to 1e-5 of the maximum, with the same bits
    on a second launch; K3 against its plain version (it reads the grids
    from device memory at any tile)."""
    plan = _support_plan(dev, support, mode, n=40000, npix=768, nplanes=3, tile=tile)
    nacc = 4 if mode == "linear" else 2
    route = kernels.query("ska_grid_route", plan.span, tile, nacc)
    assert route == (1 if tile == 96 and mode == "nearest" else
                     3 if tile == 256 and mode == "linear" else 2)
    if route == 3:
        rows = kernels.query("ska_grid_wide_geometry", plan.span, tile, nacc, 6)
        assert plan.span <= rows < tile + plan.span
    g = torch.Generator(device=dev).manual_seed(support + tile)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    before = kernels.KERNELS["grid"].launches
    out = grid(plan, vals)
    assert torch.equal(grid(plan, vals), out)
    assert kernels.KERNELS["grid"].launches == before + 2
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("wstacked", [True, False], ids=["wstacked", "nearest"])
@pytest.mark.parametrize("support", [17, 24, 32, 33, 40, 48, 64])
def test_grid_and_degrid_give_the_same_bits_at_wide_supports(dev, support, wstacked):
    """K1's wide variant adds its register runs to the shared tiles (its
    own and, through distributed shared memory, its cluster's) and to the
    grids in int64, and K3's writes each value once: launches on the same
    inputs agree bit for bit at every wide support."""
    plan = _support_plan(dev, support, "linear" if wstacked else "nearest", n=6000)
    g = torch.Generator(device=dev).manual_seed(support + 2)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    first = grid(plan, vals)
    for _ in range(4):
        assert torch.equal(grid(plan, vals), first)
    grids = torch.randn(first.shape, generator=g, device=dev, dtype=torch.complex64)
    first = degrid(plan, grids)
    assert torch.equal(degrid(plan, grids), first)


def _dense_plan(dev, support, chunk, wstacked=True, n=40000, npix=256, tile=64):
    """A plan whose entries lie in one tile, ten or so a window corner: a
    long segment whose chunks of ``chunk`` entries split its rows, and
    windows that share most cells."""
    rng = np.random.default_rng(support + 50)
    u = rng.uniform(tile + 2, tile + 2 + 64, n)
    v = rng.uniform(tile + 2, tile + 2 + 64, n)
    p0 = torch.as_tensor(rng.integers(0, 3, n)).to(dev) if wstacked else None
    frac = torch.as_tensor(rng.uniform(0, 1, n)).to(dev) if wstacked else None
    if not wstacked:
        p0 = torch.as_tensor(rng.integers(0, 4, n)).to(dev)
    return make_grid_plan(
        torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, frac,
        npixel=npix, support=support, nplanes=4, tile=tile, chunk=chunk,
    )


@pytest.mark.parametrize("chunk", [100, None], ids=["chunk100", "default"])
@pytest.mark.parametrize("support", [24, 33, 40, 64])
def test_grid_and_degrid_wide_dense_segments_match_plain(dev, support, chunk):
    """Dense windows (one tile, many entries a corner: K1's long register
    runs and its chunks' row bookkeeping where a chunk of 100 entries
    splits the segment's rows; K3's staged boxes and runs of entries on
    one corner row) against the plain versions, to 1e-5 of the maximum,
    on linear and nearest-plane plans."""
    for wstacked in (True, False):
        plan = _dense_plan(dev, support, chunk, wstacked)
        g = torch.Generator(device=dev).manual_seed(support + 3)
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


@pytest.mark.parametrize("support", [24, 64])
def test_grid_wide_raw_route_sums_shards_exactly(dev, support):
    """K1's sharded route at wide supports: the raw int64 planes converted
    on their own give the launch's own grids bit for bit; the values split
    over two shards, each gridded at the global bound, sum in int64 to the
    same bits in either order, within 1e-5 of the whole stream's grids."""
    plan = _support_plan(dev, support, "linear", n=6000)
    g = torch.Generator(device=dev).manual_seed(support + 4)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    own = (grid_vsum(vals), plan.tap_bound)
    whole = grid(plan, vals)
    assert torch.equal(grid_convert(grid(plan, vals, raw=True, bound=own), own), whole)
    shard = torch.arange(plan.n, device=dev) % 2
    parts = [torch.where(shard == d, vals, 0) for d in range(2)]
    bound = (grid_vsum(parts[0]) + grid_vsum(parts[1]), plan.tap_bound)
    raws = [grid(plan, p, raw=True, bound=bound) for p in parts]
    assert torch.equal(raws[0] + raws[1], raws[1] + raws[0])
    out = grid_convert(raws[0] + raws[1], bound)
    assert (out - whole).abs().max() <= 1e-5 * whole.abs().max()


@pytest.mark.parametrize("support", [24, 64])
def test_grid_wide_of_a_nan(dev, support):
    """At wide supports too, a NaN value gives NaN in every cell (the
    fixed-point bound is not finite), and zeros give zeros."""
    plan = _support_plan(dev, support, "linear", n=6000)
    vals = torch.zeros(plan.n, device=dev, dtype=torch.complex64)
    assert not grid(plan, vals).abs().max()
    vals[plan.n // 2] = float("nan")
    assert torch.isnan(grid(plan, vals)).all()


@pytest.mark.parametrize("frac", ["random", None], ids=["wstacked", "one-plane"])
@pytest.mark.parametrize("support", [24, 33, 64])
def test_degrid_stack_wide_unequal_n_in_matches_plain(dev, support, frac):
    """K3's wide variant over a stack of three channel plans whose n_in
    differ (corners spread ever further past the grid's edges), against
    the per-channel plain version, to 1e-5."""
    rng = np.random.default_rng(support + 6)
    n, npix, plans = 3000, 256, []
    for c in range(3):
        u, v = (rng.uniform(-10 - 40 * c, npix + 10 + 40 * c, n) for _ in range(2))
        p0 = f = None
        if frac is not None:
            p0 = torch.as_tensor(rng.integers(0, 3, n)).to(dev)
            f = torch.as_tensor(rng.uniform(0, 1, n)).to(dev)
        plans.append(make_grid_plan(
            torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, f, npixel=npix,
            nplanes=4 if frac is not None else 1, tile=64, support=support,
        ))
    st = _stack(plans)
    assert len(set(st.n_in.tolist())) == 3
    g = torch.Generator(device=dev).manual_seed(support + 5)
    grids = torch.randn((3, st.nplanes, st.npixel, st.npixel), generator=g,
                        device=dev, dtype=torch.complex64)
    out = degrid_stack(st, grids)
    ref = degrid_stack_plain(st, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _wide_unit_streams(dev, case, support, dtype, with_lo, tile=64):
    """A stress stream (test_unit_tiles_stress_matches_plain's) at
    ``support`` on ``dtype``, and the same stream in f64."""
    rng = np.random.default_rng(37)
    npix = 4 * tile
    u64, v64 = _stress_coords(case, npix, rng, tile)
    n = u64.size
    ints = np.arange(n) % 5 == 0
    u64 = np.where(ints, np.round(u64), u64)
    v64 = np.where(ints, np.round(v64), v64)
    lo = np.where(ints, -3e-9 if dtype == torch.float64 else -3e-6, 0.0)
    p0 = rng.integers(0, 3, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.uniform(0.5, 1.5, n) * (1.0 + 0.5j) * np.exp(0.1j * rng.normal(size=n))
    streams = []
    for dt in (dtype, torch.float64):
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.float64)).to(dev, dt)
        cd = torch.complex128 if dt == torch.float64 else torch.complex64
        streams.append(entry_stream(
            t(u64 if dtype == torch.float64 else u64.astype(np.float32)),
            t(v64 if dtype == torch.float64 else v64.astype(np.float32)),
            torch.as_tensor(vals).to(dev, cd), torch.as_tensor(p0).to(dev), t(frac),
            t(lo if with_lo else None), t(lo if with_lo else None), npixel=npix,
            support=support, nplanes=4, tile=tile, unit=256,
        ))
    return streams, dict(npixel=npix, tile=tile, support=support, beta=2.3 * support)


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support", [3, 7, 17, 18, 25, 32, 45, 64])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges"])
def test_unit_tiles_at_odd_and_wide_supports_match_plain(dev, case, support, dtype, with_lo):
    """K9's wide variant (odd supports and supports past 16, flushed
    straight into the fixed-point grids; past S 32 each thread owns
    several classes) against unit_tiles_plain accumulated in f64: f32 to
    1e-5 of the grid maximum, f64 to 1e-12; two launches give the same
    bits."""
    (stream, ref_stream), kw = _wide_unit_streams(dev, case, support, dtype, with_lo)
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["unit_tiles"].launches == before + 1
    ref = ref_stream.grid(plain=True, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (out.to(torch.complex128) - ref).abs().max() <= tol * ref.abs().max()
    assert torch.equal(stream.grid(**kw), out)


def test_unit_tiles_refuses_a_support_past_the_tile(dev):
    (stream, _), kw = _wide_unit_streams(dev, "edges", 8, torch.float32, False, tile=16)
    with pytest.raises(ValueError, match="support 17"):
        stream.grid(**dict(kw, support=17))


def _k9_streams(dev, u64, v64, dtype, support, tile, npix, unit, with_lo, vals=None):
    """The tiled gridder's entry stream of f64 positions (u64, v64) on
    ``dtype`` (f32: the positions rounded to f32), 4 linear w-planes of
    npix^2 and units of at most ``unit`` entries, and the same stream in
    f64; every fifth position an integer with a negative residual where
    ``with_lo`` (the window a cell lower). Returns the streams and the
    grid keywords."""
    rng = np.random.default_rng(41)
    n = u64.size
    ints = np.arange(n) % 5 == 0
    if with_lo:
        u64 = np.where(ints, np.round(u64), u64)
        v64 = np.where(ints, np.round(v64), v64)
    lo = np.where(ints, -3e-9 if dtype == torch.float64 else -3e-6, 0.0)
    p0 = rng.integers(0, 3, n)
    frac = rng.uniform(0, 1, n)
    if vals is None:
        vals = rng.uniform(0.5, 1.5, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    streams = []
    for dt in (dtype, torch.float64):
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.float64)).to(dev, dt)
        cd = torch.complex128 if dt == torch.float64 else torch.complex64
        streams.append(entry_stream(
            t(u64 if dtype == torch.float64 else u64.astype(np.float32)),
            t(v64 if dtype == torch.float64 else v64.astype(np.float32)),
            torch.as_tensor(vals).to(dev, cd), torch.as_tensor(p0).to(dev), t(frac),
            t(lo if with_lo else None), t(lo if with_lo else None), npixel=npix,
            support=support, nplanes=4, tile=tile, unit=unit,
        ))
    return streams, dict(npixel=npix, tile=tile, support=support, beta=2.3 * support)


def _k9_check(streams, kw, dtype, bits=True, tol=None):
    """One launch of K9 against unit_tiles_plain accumulated in f64 (f32
    to 1e-5 of the grid maximum, f64 to 1e-12, or ``tol``) and, with
    ``bits``, a second launch to the same bits."""
    stream, ref_stream = streams
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["unit_tiles"].launches == before + 1
    ref = ref_stream.grid(plain=True, **kw)
    if tol is None:
        tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert ref.abs().max() > 0
    assert (out.to(torch.complex128) - ref).abs().max() <= tol * ref.abs().max()
    if bits:
        assert torch.equal(stream.grid(**kw), out)
    return out


def _k9_wide_geometry(support, tile, dtype):
    f64 = int(dtype == torch.float64)
    return [kernels.query("ska_unit_tiles_wide_geometry", support, tile, f64, w)
            for w in range(7)]


_K9_WIDE = [7, 9, 15, 17, 24, 31, 32, 33, 48, 64]


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tile", [56, 64])
@pytest.mark.parametrize("support", _K9_WIDE)
def test_unit_tiles_wide_tile_matches_plain(dev, support, tile, dtype, with_lo):
    """K9's wide variant (the tile held in shared memory, in bands over a
    cluster where one CTA cannot hold it) on a core-heavy stream of full
    units (4096 entries) and sparse ones, tiles 56 and 64 (at 56 the
    support 64 is past the tile and refused): against unit_tiles_plain
    accumulated in f64, f32 to 1e-5 of the grid maximum and f64 to 1e-12;
    two launches give the same bits."""
    npix = 4 * tile
    if support > tile:
        (stream, _), kw = _k9_streams(dev, np.asarray([30.2]), np.asarray([40.7]), dtype,
                                      min(support, tile), tile, npix, 4096, with_lo)
        with pytest.raises(ValueError, match=f"support {support}"):
            stream.grid(**dict(kw, support=support))
        return
    rng = np.random.default_rng(support)
    n = 30000
    core = rng.normal(npix / 2, npix / 12, (2, n - 3000))
    wide = rng.uniform(0, npix, (2, 3000))
    u64, v64 = np.concatenate([core, wide], axis=1)
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, npix, 4096, with_lo)
    assert int(streams[0].unit_count.max()) == 4096
    _k9_check(streams, kw, dtype)


_K9_CLUSTERS = [(24, 128, torch.float64), (32, 128, torch.float64), (48, 128, torch.float64),
                (64, 64, torch.float32), (64, 64, torch.float64), (33, 256, torch.float32)]


def test_unit_tiles_wide_clusters(dev):
    """The geometries that the wide tests reach: the tiles of
    _K9_CLUSTERS need a cluster of several CTAs; every support of the
    wide tests keeps at most an eighth of its classes idle from 7 up; no
    cluster holds the tile of 512 at support 17."""
    for support, tile, dtype in _K9_CLUSTERS:
        assert _k9_wide_geometry(support, tile, dtype)[0] > 1, (support, tile, dtype)
    for dtype in (torch.float32, torch.float64):
        for support in _K9_WIDE:
            cs, threads, smem, walks, k, stage, rows = _k9_wide_geometry(support, 64, dtype)
            assert cs in (1, 2, 4, 8) and 0 < smem <= 232448 and stage >= 1
            assert 8 * walks * support * support >= 7 * threads * k, (support, dtype)
            assert rows >= 64 + support + 1
        # no cluster holds the tile of 512 at support 17: 8 CTAs serve it in
        # turns; at 64 on tile 4096 their bands cannot hold one window
        cs, _, smem, _, _, _, rows = _k9_wide_geometry(17, 512, dtype)
        assert cs == 8 and 17 + 1 <= rows < 512 + 17 + 1 and smem <= 232448
        assert _k9_wide_geometry(64, 4096, dtype)[0] == 0


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("support,tile,dtype", _K9_CLUSTERS)
def test_unit_tiles_wide_cluster_tiles_match_plain(dev, support, tile, dtype, with_lo):
    """K9's wide variant on tiles that a cluster of CTAs holds in bands
    (f64 at supports 24, 32 and 48 on tile 128; both types at
    64; f32 at 33 on 256), on a core-heavy stream of full units: against
    unit_tiles_plain accumulated in f64, f32 to 1e-5 of the grid maximum
    and f64 to 1e-12; two launches give the same bits."""
    npix = 4 * tile
    rng = np.random.default_rng(support + tile)
    n = 30000
    core = rng.normal(npix / 2, tile / 3, (2, n - 3000))
    wide = rng.uniform(0, npix, (2, 3000))
    u64, v64 = np.concatenate([core, wide], axis=1)
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, npix, 4096, with_lo)
    assert int(streams[0].unit_count.max()) == 4096
    _k9_check(streams, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support", [7, 24, 33])
@pytest.mark.parametrize("case", ["one_entry_units", "one_window", "one_segment"])
def test_unit_tiles_wide_unit_shapes_match_plain(dev, case, support, dtype):
    """K9's wide variant on units of one entry each (a run a unit, or the
    units of one segment served as one run), on 4096-entry units whose
    entries all lie on one window (the kRunCap cuts of every class) and on
    many consecutive units of 100 entries of one segment: against
    unit_tiles_plain accumulated in f64; the same bits on two launches."""
    rng = np.random.default_rng(53)
    tile, npix = 64, 256
    if case == "one_entry_units":
        u64, v64 = rng.uniform(3, npix - 70, (2, 500))
        unit = 1
    elif case == "one_window":
        u64, v64 = np.full(3 * 4096 + 17, 100.3), np.full(3 * 4096 + 17, 77.6)
        unit = 4096
    else:
        u64, v64 = rng.uniform(tile, 2 * tile, (2, 5000))
        unit = 100
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, npix, unit, True)
    if case == "one_window":
        assert int((streams[0].unit_count == 4096).sum()) >= 3
    _k9_check(streams, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support", [17, 64])
def test_unit_tiles_wide_nan_value_gives_nan_grids(dev, support, dtype):
    """A NaN value makes the stream's bound NaN: every cell of the wide
    variant's grids is NaN, as the plain version's sums are where the
    value lands."""
    rng = np.random.default_rng(59)
    u64, v64 = rng.uniform(3, 180, (2, 2000))
    vals = np.ones(2000, np.complex128)
    vals[777] = complex(float("nan"), 0.0)
    (stream, _), kw = _k9_streams(dev, u64, v64, dtype, support, 64, 256, 4096, False,
                                  vals=vals)
    assert torch.isnan(stream.grid(**kw)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_unit_tiles_wide_refuses_a_tile_no_cluster_holds(dev, dtype):
    """A tile of whose fixed-point words a cluster of 8 CTAs cannot hold
    one window's rows (4096 at support 64), which K9 refused until its
    route 4 took it (``ska_unit_tiles_route`` 4): against
    unit_tiles_plain accumulated in f64 (f32 to 1e-5 of the grid maximum,
    f64 to 1e-12), two launches to the same bits."""
    tile, support = 4096, 64
    f64 = int(dtype == torch.float64)
    assert _k9_wide_geometry(support, tile, dtype)[0] == 0
    assert kernels.query("ska_unit_tiles_route", support, tile, f64) == 4
    rng = np.random.default_rng(61)
    u64, v64 = rng.normal(2048, 300, (2, 3000))
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, tile, 1024, True)
    _k9_check(streams, kw, dtype)


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("support", [2, 8, 16])
def test_unit_tiles_narrow_supports_on_large_tiles_match_plain(dev, support, tile, dtype,
                                                               with_lo):
    """Even supports to 16 on tiles the narrow kernel cannot hold: K9's
    wide variant, its whole tile in a cluster's bands at 128 and in turns
    at 512, on a core-heavy stream whose units span the tile's rows (so a
    run takes several turns, and with ``with_lo`` windows start a row
    early at their edges): against unit_tiles_plain accumulated in f64,
    f32 to 1e-5 of the grid maximum and f64 to 1e-12; two launches give
    the same bits."""
    f64 = int(dtype == torch.float64)
    assert kernels.query("ska_unit_tiles_route", support, tile, f64) == (2 if tile == 128 else 3)
    npix = 2 * tile
    rng = np.random.default_rng(support + tile)
    n = 30000
    core = rng.normal(npix / 2, tile / 3, (2, n - 3000))
    wide = rng.uniform(0, npix, (2, 3000))
    u64, v64 = np.concatenate([core, wide], axis=1)
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, npix, 4096, with_lo)
    _k9_check(streams, kw, dtype)


def test_route_tables_take_every_tile(dev):
    """The libraries' own route queries: K1 takes every window (supports 1
    to 256, linear and one-plane plans), K3 every window, and K9 every
    support (1 to 256, f32 and f64) on every tile that divides a 1024^2,
    1344^2, 2048^2 or 4096^2 grid and holds the support, and a support as
    wide as the tile at every such tile from 512 to 4096; the narrow
    kernels stay the route at the tiles the imaging API picks."""
    tiles = sorted({t for n in (1024, 1344, 2048, 4096) for t in range(1, n + 1) if n % t == 0})
    cases = [(s, t) for s in range(1, 257) for t in tiles
             if t >= s and not (s % 2 and s % t == 0)]
    cases += [(t, t) for t in tiles if 512 <= t <= 4096 and t > 256]
    refused = []
    for support, t in cases:
        span = support + support % 2
        for nacc in (4, 2):
            if not kernels.query("ska_grid_route", span, t, nacc):
                refused.append(("grid", support, t, nacc))
        for f64 in (0, 1):
            if not kernels.query("ska_unit_tiles_route", support, t, f64):
                refused.append(("unit_tiles", support, t, f64))
        if not kernels.query("ska_degrid_route", span):
            refused.append(("degrid", support, t))
    assert refused == []
    for tile in (56, 64, 48, 32, 16, 8):
        for support in range(1, min(tile, 16) + 1):
            span = support + support % 2
            assert kernels.query("ska_grid_route", span, tile, 4) == 1, (support, tile)
            assert kernels.query("ska_degrid_route", span) == 1
            if support % 2 == 0:
                for f64 in (0, 1):
                    assert kernels.query("ska_unit_tiles_route", support, tile, f64) == 1


# sha256 of the routes 1-3 of K1 (spans 2-64, nacc 4 then 2) and K9
# (supports 2-64, f32 then f64) on tiles 1-512, one byte a query (route 4
# and refusals as 0), taken from the library before the device-memory
# routes were added
_ROUTES_1_3 = {
    "grid": "46241d1a76196b56420435a02bc2f7b48a94f01d72b7b5285946ddbd6b097b44",
    "unit_tiles": "1c7613c0fc96e0cf4a46cb1fe3c7b0a8086feee35a6eaf62c5c87256b5babc72",
}


def _routes_1_3(kernel):
    import hashlib

    if kernel == "grid":
        rows = [kernels.query("ska_grid_route", s, t, nacc)
                for nacc in (4, 2) for s in range(2, 65, 2) for t in range(1, 513)]
    else:
        rows = [kernels.query("ska_unit_tiles_route", s, t, f64)
                for f64 in (0, 1) for s in range(2, 65) for t in range(1, 513)]
    return hashlib.sha256(bytes(r if r < 4 else 0 for r in rows)).hexdigest()


def test_routes_1_to_3_unchanged_up_to_tile_512(dev):
    """K1's and K9's narrow kernel and cluster-banded routes (1-3) take the
    same geometries as before the device-memory route (4) was added: on
    tiles 1-512 every query that gave 1, 2 or 3 gives it still, and route
    4 appears only where the library refused (0)."""
    for kernel, digest in _ROUTES_1_3.items():
        assert _routes_1_3(kernel) == digest, kernel


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support,tile", [(72, 96), (97, 448), (128, 256)])
def test_grid_and_degrid_past_64_cells_match_plain(dev, support, tile, mode):
    """Windows past 64 cells (an odd support's are S + 1): K1's
    route 4 (``ska_grid_route`` 4) and K3's long-window kernel
    (``ska_degrid_route`` 4) against their plain versions (K1's
    accumulated in f64), to 1e-5 of the maximum; two launches of each give
    the same bits, one launch a call."""
    npix = 2 * tile if tile < 448 else tile
    plan = _support_plan(dev, support, mode, n=4000, npix=npix, nplanes=3, tile=tile)
    nacc = 4 if mode == "linear" else 2
    assert plan.ku.shape[1] == (plan.span + 7) // 8 * 8
    assert kernels.query("ska_grid_route", plan.span, tile, nacc) == 4
    assert kernels.query("ska_degrid_route", plan.span) == 4
    g = torch.Generator(device=dev).manual_seed(support)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    before = kernels.launch_counts()
    out = grid(plan, vals)
    assert torch.equal(grid(plan, vals), out)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    assert torch.equal(degrid(plan, grids), out)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    after = kernels.launch_counts()
    assert after["grid"] == before["grid"] + 2 and after["degrid"] == before["degrid"] + 2


@pytest.mark.parametrize("frac", ["random", None], ids=["wstacked", "one-plane"])
def test_degrid_stack_past_64_cells_matches_plain(dev, frac):
    """K3's long-window kernel over a stack of three channel plans of
    unequal n_in at support 80 in one launch, against degrid_stack_plain
    to 1e-5 of the maximum."""
    rng = np.random.default_rng(71)
    npix, nplanes, n, support = 256, 3, 3000, 80
    plans = []
    for c in range(3):
        u = rng.uniform(-10, npix + 10 - 40 * c, n)
        v = rng.uniform(-10, npix + 10, n)
        p0 = torch.as_tensor(rng.integers(0, nplanes - 1, n)).to(dev)
        f = torch.as_tensor(rng.uniform(0, 1, n)).to(dev) if frac else None
        plans.append(make_grid_plan(
            torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0 if frac else None, f,
            npixel=npix, support=support, nplanes=nplanes if frac else 1, tile=128))
    st = _stack(plans)
    assert len({p.n_in for p in plans}) > 1
    grids = torch.randn((3, st.nplanes, npix, npix), device=dev, dtype=torch.complex64)
    out = degrid_stack(st, grids)
    ref = degrid_stack_plain(st, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support,tile", [(72, 96), (80, 192), (97, 256), (128, 256)])
def test_unit_tiles_past_64_matches_plain(dev, support, tile, dtype, with_lo):
    """K9's route 4 (``ska_unit_tiles_route`` 4) at supports
    past 64 on a core-heavy stream of full units: f64 against
    unit_tiles_plain in f64 to 1e-12 of the grid maximum; f32 against
    unit_tiles_plain on the same f32 stream to 1e-5, since past 64 the f32
    taps themselves (the ES kernel's beta (sqrt(1 - nu^2) - 1) loses about
    beta x 2^-24 to cancellation, which the plain version and the JAX
    package evaluate alike) lie 1.15e-5 of the maximum from the f64 grids
    at support 128; two launches give the same bits."""
    f64 = int(dtype == torch.float64)
    assert kernels.query("ska_unit_tiles_route", support, tile, f64) == 4
    npix = 2 * tile
    rng = np.random.default_rng(support + tile)
    n = 6000
    core = rng.normal(npix / 2, tile / 3, (2, n - 600))
    wide = rng.uniform(0, npix, (2, 600))
    u64, v64 = np.concatenate([core, wide], axis=1)
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, npix, 1024, with_lo)
    if dtype == torch.float32:
        streams = (streams[0], streams[0])
    _k9_check(streams, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_unit_tiles_at_support_1_gives_zero_grids(dev, dtype):
    """Support 1: the ES kernel of half width 0 is zero everywhere, so K9's
    route 4 and its plain version give zero grids; the
    launch is counted."""
    f64 = int(dtype == torch.float64)
    assert kernels.query("ska_unit_tiles_route", 1, 64, f64) == 4
    rng = np.random.default_rng(73)
    u64, v64 = rng.uniform(0, 256, (2, 3000))
    (stream, ref_stream), kw = _k9_streams(dev, u64, v64, dtype, 1, 64, 256, 1024, False)
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["unit_tiles"].launches == before + 1
    assert not out.abs().max() and not ref_stream.grid(plain=True, **kw).abs().max()


def _long_plan(dev, case, support, mode, npix, tile):
    """A plan on 3 planes of npix^2: "straddle", 20,000 entries in a core
    of sigma npix / 12, so that a piece of K3's walk takes several corner
    rows and its box several bands, whose edges the windows straddle;
    "sparse", 3,000 entries spread over the grid, so that nearly every
    walk position moves the window corner."""
    rng = np.random.default_rng(support + 7 * (case == "sparse"))
    if case == "straddle":
        u, v = rng.normal(npix / 2, npix / 12, (2, 20000))
    else:
        u, v = rng.uniform(-10, npix + 10, (2, 3000))
    n = u.size
    p0 = torch.as_tensor(rng.integers(0, 2, n)).to(dev)
    frac = torch.as_tensor(rng.uniform(0, 1, n)).to(dev) if mode == "linear" else None
    return make_grid_plan(torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, frac,
                          npixel=npix, support=support, nplanes=3, tile=tile)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support", [72, 97, 128, 160])
@pytest.mark.parametrize("case", ["straddle", "sparse"])
def test_degrid_long_windows_in_bands_match_plain(dev, case, support, mode):
    """K3's long-window kernel (``ska_degrid_route`` 4), which stages each
    piece's window rows in bands of shared memory: windows that straddle a
    band's edge (a dense core; at 128 cells a window on a plane pair is
    larger than a band by itself, and past a span of 144 a run takes its
    columns in two chunks) and a sparse stream on which nearly every entry
    moves the window corner, linear and nearest. Against degrid_plain to
    1e-5 of the maximum; two launches give the same bits."""
    npix, tile = (512, 256) if case == "straddle" else (1024, 256)
    plan = _long_plan(dev, case, support, mode, npix, tile)
    assert kernels.query("ska_degrid_route", plan.span) == 4
    cells = kernels.query("ska_degrid_long_geometry", plan.span, 5)
    cols = kernels.query("ska_degrid_long_geometry", plan.span, 3)
    assert cells > 0 and 32 * cols >= min(plan.span + 16, 160)
    if support >= 128 and mode == "linear":
        assert 2 * plan.span ** 2 > cells  # a window alone takes two bands
    assert kernels.query("ska_degrid_long_geometry", plan.span, 4) == (2 if support == 160 else 1)
    g = torch.Generator(device=dev).manual_seed(support)
    grids = torch.randn((plan.nplanes, npix, npix), generator=g, device=dev,
                        dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    before = kernels.KERNELS["degrid"].launches
    out = degrid(plan, grids)
    assert torch.equal(degrid(plan, grids), out)
    torch.cuda.synchronize()
    assert kernels.KERNELS["degrid"].launches == before + 2
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _route4_streams(dev, case, support, tile, dtype):
    """K9's entry streams (``_k9_streams``, with split coordinates) for
    route 4 on 4 planes of npix^2 (twice the tile, the tile itself from
    2048): "straddle", 8,000 entries in a core of sigma tile / 4 over
    units of at most 1024, so that a run's windows straddle its turns'
    band edges; "sparse", 3,000 entries spread over the grid, so that
    nearly every entry moves the window corner."""
    npix = tile if tile >= 2048 else 2 * tile
    rng = np.random.default_rng(support + tile + 3 * (case == "sparse"))
    if case == "straddle":
        u64, v64 = np.clip(rng.normal(npix / 2, tile / 4, (2, 8000)), 0, npix - 1)
    else:
        u64, v64 = rng.uniform(0, npix, (2, 3000))
    return _k9_streams(dev, u64, v64, dtype, support, tile, npix, 1024, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support,tile", [(96, 256), (128, 256), (64, 2048), (128, 2048)])
@pytest.mark.parametrize("case", ["straddle", "sparse"])
def test_unit_tiles_route4_bands_match_plain(dev, case, support, tile, dtype):
    """K9's route 4 (``ska_unit_tiles_route`` 4), which serves a run a
    sub-tile of window corners after another, each with its halo held in
    shared memory over a cluster: windows that straddle the sub-tiles'
    edges and the CTAs' bands (a dense core) and a sparse stream on which
    nearly every entry moves the corner, past 64 (a walk's classes over
    several CTAs, stage 1's taps shared through distributed shared memory)
    and on tile 2048 at supports 64 and 128 (where the whole tile's rows
    held by a cluster are fewer than a window's). f64 against
    unit_tiles_plain in f64 to 1e-12 of the grid maximum; f32 against the
    plain version accumulated in f64 at 64 and in f32 past it (its taps
    are the plain version's) to 1e-5; two launches give the same bits."""
    f64 = int(dtype == torch.float64)
    assert kernels.query("ska_unit_tiles_route", support, tile, f64) == 4
    geo = [kernels.query("ska_unit_tiles_band_geometry", support, tile, f64, w)
           for w in range(11)]
    cs, threads, smem, walks, k, stage, tr, tc, nsl, npass, nbuf = geo
    assert threads > 0 and smem <= 232448 and npass == 1 and cs % nsl == 0
    assert 1 <= tr <= tile and 1 <= tc <= tile and tr * tc < tile * tile  # sub-tiles
    if support <= 64:
        assert cs == 1  # one CTA holds a sub-tile: every flush into its own band
    else:
        assert nsl > 1  # a walk spans CTAs, which share stage 1's taps
    streams, kw = _route4_streams(dev, case, support, tile, dtype)
    if dtype == torch.float32 and support > 64:
        streams = (streams[0], streams[0])
    _k9_check(streams, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_unit_tiles_past_the_largest_window_a_cluster_holds(dev, dtype):
    """A support of 384 on tile 512: no cluster holds one window and its
    halo (386 x 386 int64 pairs), so K9's route 4 serves each sub-tile's
    held cells in blocks over the cluster, windows clipped to each
    (``ska_unit_tiles_band_geometry`` 11 and 12 the block's rows and
    columns): f64 against unit_tiles_plain in f64 to 1e-12 of the grid
    maximum; f32 against unit_tiles_plain on the same f32 stream to beta x
    2^-24 = 5.3e-5 of it: the f32 ES taps' beta (sqrt(1 - nu^2) - 1)
    cancels that much away, so taps that the kernel and the plain version
    round an ulp of sqrt(1 - nu^2) apart differ by up to that (2.1e-5 of
    the maximum on this stream, for the device-memory walk that served this
    support before as for the blocks), and both lie 5.8e-5 from the f64
    grids; two launches give the same bits."""
    support, tile = 384, 512
    f64 = int(dtype == torch.float64)
    assert kernels.query("ska_unit_tiles_route", support, tile, f64) == 4
    geo = [kernels.query("ska_unit_tiles_band_geometry", support, tile, f64, w)
           for w in range(13)]
    assert geo[0] == 8 and geo[1] > 0 and geo[2] <= 232448
    hb, wb = geo[11], geo[12]
    assert 0 < hb < geo[6] + support + 1  # the held rows in bands
    assert 0 < wb <= geo[7] + support + 1
    assert kernels.query("ska_unit_tiles_band_geometry", 256, tile, f64, 11) == 0
    rng = np.random.default_rng(79)
    u64, v64 = rng.normal(512, 120, (2, 1500))
    streams, kw = _k9_streams(dev, u64, v64, dtype, support, tile, 1024, 1024, True)
    if dtype == torch.float32:
        streams = (streams[0], streams[0])
    _k9_check(streams, kw, dtype, tol=kw["beta"] * 2.0**-24 if dtype == torch.float32 else None)


def test_unit_tiles_support_as_wide_as_the_tile(dev):
    """A support equal to the tile (1024): K9's route 4 in blocks, each
    window clipped to every block it meets, on 300 positions (600 entries
    over two planes) whose windows lie in a 2048^2 grid of 1024^2 tiles:
    f64 against unit_tiles_plain in f64 to 1e-12 of the grid maximum, two
    launches to the same bits."""
    support = tile = 1024
    assert kernels.query("ska_unit_tiles_route", support, tile, 1) == 4
    assert kernels.query("ska_unit_tiles_band_geometry", support, tile, 1, 11) > 0
    rng = np.random.default_rng(83)
    u64, v64 = rng.uniform(520, 1530, (2, 300))
    streams, kw = _k9_streams(dev, u64, v64, torch.float64, support, tile, 2048, 1024, True)
    _k9_check(streams, kw, torch.float64)


# The tiles that divide a 1024^2, 1344^2, 2048^2 or 4096^2 grid, and the
# digests of the route tables and of route 4's geometry taken from the
# library before route 4's device-memory walks were replaced: K1's and
# K9's routes at every span or support up to 512 on those tiles, and K9's
# route-4 geometry (fields 0-10) wherever a cluster held a sub-tile whole
_TILES = sorted({t for n in (1024, 1344, 2048, 4096) for t in range(1, n + 1) if n % t == 0})
_BEFORE_ROUTE4 = {
    "grid_route": "89d01d4783ccd21cc05b68001ec280648be76078ec4ef005edff450f46be54db",
    "unit_tiles_route": "981336621ada2661f67e26872c59bf6e225f8aef7decf24f2714010d23bb2617",
    "unit_tiles_band": "af811a964c3cef5762d09c221b13b79f5d4280b5ce45140a06dac38f95cf536e",
}


def _digest(rows):
    import hashlib

    return hashlib.sha256(np.asarray(rows, np.int64).tobytes()).hexdigest()


def route4_tables(query):
    """The rows of _BEFORE_ROUTE4's digests from ``query(symbol, *args)``:
    ``ska_grid_route`` at even spans 2-512 (nacc 4 then 2) and
    ``ska_unit_tiles_route`` at supports 1-512 (f32 then f64) on every tile
    of _TILES that holds them; ``ska_unit_tiles_band_geometry`` fields 0-10
    at supports 2-400 on those tiles and at (t, t) from 512 to 4096,
    wherever field 0 is non-zero and 11 is zero (a cluster holds the
    sub-tile whole), each with its case."""
    grid_route = [query("ska_grid_route", s, t, nacc) for nacc in (4, 2)
                  for s in range(2, 513, 2) for t in _TILES if t >= s]
    unit_route = [query("ska_unit_tiles_route", s, t, f64) for f64 in (0, 1)
                  for s in range(1, 513) for t in _TILES if t >= s]
    cases = [(s, t) for s in range(2, 401) for t in _TILES if t >= s]
    cases += [(t, t) for t in _TILES if 400 < t <= 4096]
    band = []
    for f64 in (0, 1):
        for s, t in cases:
            if (query("ska_unit_tiles_band_geometry", s, t, f64, 0)
                    and not query("ska_unit_tiles_band_geometry", s, t, f64, 11)):
                band += [f64, s, t] + [query("ska_unit_tiles_band_geometry", s, t, f64, w)
                                       for w in range(11)]
    return {"grid_route": grid_route, "unit_tiles_route": unit_route, "unit_tiles_band": band}


def test_route4_keeps_every_route_and_whole_geometry(dev):
    """Replacing route 4's device-memory walks moved no geometry: K1 and
    K9 take every span and support up to 512 on every tile of _TILES by the
    same route as before (route 4 exactly where it was), and K9's route 4
    keeps its launch geometry wherever a cluster held a sub-tile whole, so
    that only the geometries the walk served are new."""
    tables = route4_tables(kernels.query)
    for name, digest in _BEFORE_ROUTE4.items():
        assert _digest(tables[name]) == digest, name


def _route4_plan(dev, case, support, mode, npix, tile, n):
    """A plan on 3 planes of npix^2 at ``support``: "dense", ``n`` entries in
    a core of sigma 12 cells at the grid's centre (a tile corner), many a
    window corner, windows straddling the sub-tiles' and tiles' edges;
    "sparse", ``n`` entries spread over the grid and past its edges."""
    rng = np.random.default_rng(support + 5 * (case == "sparse"))
    if case == "dense":
        u, v = rng.normal(npix / 2, 12, (2, n))
    else:
        u, v = rng.uniform(-10, npix + 10, (2, n))
    p0 = torch.as_tensor(rng.integers(0, 2, n)).to(dev)
    frac = torch.as_tensor(rng.uniform(0, 1, n)).to(dev) if mode == "linear" else None
    return make_grid_plan(torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, frac,
                          npixel=npix, support=support, nplanes=3, tile=tile)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("support,tile,n", [(65, 96, 12000), (72, 96, 12000),
                                            (97, 256, 8000), (128, 256, 6000),
                                            (256, 512, 1500)])
@pytest.mark.parametrize("case", ["dense", "sparse"])
def test_grid_route4_sub_tiles_match_plain(dev, case, support, tile, n, mode):
    """K1's route 4 (``ska_grid_route`` 4): sub-tiles of window corners
    with their halo in shared int64 over a cluster, at spans 66, 72, 98
    and 128 (a walk's classes over 2-4 CTAs past 72) and at 256 on tile 512
    on a linear plan, where no cluster holds a window whole and the held
    cells go in blocks, windows clipped to each; linear (4 words a cell)
    and nearest (2) plans, dense and sparse streams. Against the plain
    version accumulated in f64 to 1e-5 of the maximum; two launches give
    the same bits, one launch a call."""
    npix = 2 * tile
    plan = _route4_plan(dev, case, support, mode, npix, tile, n)
    nacc = 4 if mode == "linear" else 2
    assert kernels.query("ska_grid_route", plan.span, tile, nacc) == 4
    geo = [kernels.query("ska_grid_band_geometry", plan.span, tile, nacc, w) for w in range(13)]
    cs, threads, smem, walks, k, stage, tr, tc, nsl, npass, nbuf, hb, wb = geo
    assert threads > 0 and smem <= 232448 and cs % nsl == 0
    assert 1 <= tr <= tile and 1 <= tc <= tile
    assert (nsl > 1) == (plan.span > 72 and hb == 0)
    assert (hb > 0) == (plan.span == 256 and nacc == 4)
    g = torch.Generator(device=dev).manual_seed(support + tile)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    before = kernels.KERNELS["grid"].launches
    out = grid(plan, vals)
    assert torch.equal(grid(plan, vals), out)
    torch.cuda.synchronize()
    assert kernels.KERNELS["grid"].launches == before + 2
    assert ref.abs().max() > 0
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("support,tile", [(72, 96), (256, 512)])
def test_grid_route4_of_a_nan_and_raw_shards(dev, support, tile):
    """K1's route 4, whole sub-tiles (72) and blocks (256): a NaN value
    gives NaN in every cell and zeros give zeros; on the sharded route the
    raw int64 planes converted on their own give the launch's own grids bit
    for bit, and the values split over two shards, each gridded at the
    global bound, sum in int64 to the same bits in either order, within
    1e-5 of the whole stream's grids."""
    plan = _route4_plan(dev, "sparse", support, "linear", 2 * tile, tile, 1500)
    assert kernels.query("ska_grid_route", plan.span, tile, 4) == 4
    g = torch.Generator(device=dev).manual_seed(support + 4)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    own = (grid_vsum(vals), plan.tap_bound)
    whole = grid(plan, vals)
    assert torch.equal(grid_convert(grid(plan, vals, raw=True, bound=own), own), whole)
    shard = torch.arange(plan.n, device=dev) % 2
    parts = [torch.where(shard == d, vals, 0) for d in range(2)]
    bound = (grid_vsum(parts[0]) + grid_vsum(parts[1]), plan.tap_bound)
    raws = [grid(plan, p, raw=True, bound=bound) for p in parts]
    assert torch.equal(raws[0] + raws[1], raws[1] + raws[0])
    out = grid_convert(raws[0] + raws[1], bound)
    assert (out - whole).abs().max() <= 1e-5 * whole.abs().max()
    zeros = torch.zeros_like(vals)
    assert not grid(plan, zeros).abs().max()
    zeros[plan.n // 2] = float("nan")
    assert torch.isnan(grid(plan, zeros)).all()


@pytest.mark.parametrize("support,tile", [(48, 2048), (96, 256)])
def test_unit_tiles_route4_f64_low_words_carry(dev, support, tile):
    """K9's route 4 in f64 on a stream whose cells lie near the launch's
    bound and gather the flushes of many turns and clusters: 6,000 values
    of one sign on a few window corners, over units of at most 64, so that
    the 128-bit sums' low words overflow and carry into the high words
    again and again. Against unit_tiles_plain in f64 to 1e-12 of the grid
    maximum; two launches give the same bits."""
    assert kernels.query("ska_unit_tiles_route", support, tile, 1) == 4
    npix = tile if tile >= 2048 else 2 * tile
    rng = np.random.default_rng(support)
    n = 6000
    corners = rng.uniform(npix / 4, 3 * npix / 4, (2, 5))
    pick = rng.integers(0, 5, n)
    u64 = corners[0][pick] + rng.uniform(0, 0.999, n)
    v64 = corners[1][pick] + rng.uniform(0, 0.999, n)
    vals = rng.uniform(0.9, 1.0, n) * (1.0 + 1.0j)
    streams, kw = _k9_streams(dev, u64, v64, torch.float64, support, tile, npix, 64, False,
                              vals=vals)
    _k9_check(streams, kw, torch.float64)


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
