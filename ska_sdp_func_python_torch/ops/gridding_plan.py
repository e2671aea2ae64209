"""Reusable gridding plans: one geometry sort shared by every call.

Counterpart of ``ska_sdp_func_python_tpu/ops/gridding_plan.py``. A plan is
built once per set of coordinates with one stable ``torch.argsort`` on the
(lower w-plane, v-tile, u-tile) segment key, so the port's plan order is
the JAX plan's order for the same tile. It keeps the permutation (sorted
position -> original index), the per-entry window corners, plane indices,
plane fractions and separable ES taps in plan order, and the segment
bounds in the form the grid kernel's CTAs take them: every segment cut
into chunks of at most ``chunk`` entries, and the grid kernel's own walk
order within each segment (``korder``: by window corner, so that
consecutive entries share cells). Values move between natural and plan
order through ``permute.permute_apply`` (kernel K4) with the stored
permutation, in place of the JAX package's rank-keyed sorts.

A plan takes any support from 1 to its tile (the JAX plan path's limit,
on the card too: past a window of 64 cells, or on a tile of which no
cluster holds one window's rows, K1 and K3 take their route 4 and
long-window routes), and linear (a
plane pair an entry) or nearest-plane (one plane an entry, ``plane_idx``
without ``plane_frac``) w-stacking, as the JAX plan path does. An odd
support follows the JAX kernels, which evaluate the ES kernel densely
over each segment's tile buffer: where the fractional position is below
one half, the cell before the window (``floor(pix) - (S//2 - 1)``) lies
within S/2 of the position and is weighted too, unless it falls before
the entry's tile. So an odd-support plan's windows are ``span = S + 1``
cells wide, starting one cell early where that cell is in the tile.

A :class:`GridPlanStack` holds the per-entry arrays that the degrid (K3)
and permute (K4) kernels read for one plan per channel, stacked
``[nchan, n]``, so that one launch serves every channel of a cube (the
JAX package vmaps over channel-stacked plans); each channel's
:class:`GridPlan` holds views into the stack, so nothing is stored twice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .gridding_fused import _es_taps, degrid, grid, window_span
from .permute import permute_apply

__all__ = [
    "GridPlan",
    "GridPlanStack",
    "STACKED",
    "default_chunk",
    "stack_views",
    "make_grid_plan",
    "grid_with_plan",
    "degrid_with_plan",
    "sort_values",
    "unsort_values",
]


@dataclass(frozen=True)
class GridPlan:
    """Precomputed geometry for the plan gridder/degridder. Per-entry
    arrays are in plan order; entries ``[n_in, n)`` lie outside the grid
    (the TPU plan's trash segment)."""

    perm: torch.Tensor  # int32 [n]: original index of each sorted entry
    iperm: torch.Tensor  # int32 [n]: sorted position of each original entry
    iu0: torch.Tensor  # int32 [n] clipped window corner (u)
    iv0: torch.Tensor  # int32 [n] clipped window corner (v)
    plane: torch.Tensor  # int32 [n] lower (nearest: the only) w-plane
    frac: torch.Tensor  # f32 [n] fraction to the upper plane (nearest: 0)
    # f32 [n, tap_width(span)] u taps, zero past span (past a span of 64
    # the rows are the span rounded up to a multiple of 8 floats)
    ku: torch.Tensor
    kv: torch.Tensor  # f32 [n, tap_width(span)] v taps
    chunk_seg: torch.Tensor  # int32 [nchunks]
    chunk_start: torch.Tensor  # int32 [nchunks]
    chunk_count: torch.Tensor  # int32 [nchunks]
    korder: torch.Tensor  # int32 [n_in]: the grid kernel's walk order
    # f32 [1]: the most one entry adds to one cell per unit of |re| + |im|
    # (largest u tap times largest v tap times largest plane weight), the
    # grid kernel's fixed-point bound
    tap_bound: torch.Tensor
    n: int
    n_in: int
    npixel: int
    support: int
    nplanes: int
    tile: int
    wstacked: bool
    beta: float | None = None
    nearest: bool = False  # one plane an entry (w_interp="nearest")

    @property
    def span(self) -> int:
        """Cells of each window: the support, one more for an odd one."""
        return window_span(self.support)


# the per-entry arrays of a plan that K3 and K4 read, stacked over channels
# (korder, [n_in] a channel, in rows of n)
STACKED = ("perm", "iperm", "iu0", "iv0", "plane", "frac", "ku", "kv", "korder")


def stack_views(store: dict, nchan: int, c: int, n: int | None = None, **arrays) -> dict:
    """Copies each named array into row ``c`` of the stacked array of the
    same name in ``store`` (zero-filled ``[nchan, n, ...]`` at its first
    row, ``n`` the array's length if None; a shorter array fills the head
    of its row) and returns the filled rows, views of the stack, by name."""
    rows = {}
    for name, a in arrays.items():
        if name not in store:
            shape = (nchan, a.shape[0] if n is None else n, *a.shape[1:])
            store[name] = torch.zeros(shape, dtype=a.dtype, device=a.device)
        row = store[name][c]
        if a.shape[0] > row.shape[0] or a.shape[1:] != row.shape[1:] or a.dtype != row.dtype:
            raise ValueError(
                f"{name}: channel {c} has {tuple(a.shape)} {a.dtype}, the stack "
                f"rows {tuple(row.shape)} {row.dtype}"
            )
        rows[name] = row[: a.shape[0]].copy_(a)
    return rows


@dataclass(frozen=True)
class GridPlanStack:
    """The :data:`STACKED` arrays of one plan per channel, ``[nchan, n]``
    (``[nchan, n, tap_width]`` for the taps; ``korder``, the walk order of the
    grid and degrid kernels, ragged in ``n_in``, fills the head of its
    row), and the channel plans, whose arrays of those names are views
    into them. Every channel has the same ``n`` entries, grid size and
    w-planes; ``n_in`` is an int32 ``[nchan]`` tensor on the plans'
    device. Every channel has the same support and plane mode. The chunk
    tables, ragged and read only by the grid kernel, stay per channel."""

    perm: torch.Tensor
    iperm: torch.Tensor
    iu0: torch.Tensor
    iv0: torch.Tensor
    plane: torch.Tensor
    frac: torch.Tensor
    ku: torch.Tensor
    kv: torch.Tensor
    korder: torch.Tensor
    n_in: torch.Tensor
    plans: tuple
    n: int
    npixel: int
    nplanes: int
    wstacked: bool
    support: int
    nearest: bool

    @property
    def span(self) -> int:
        return window_span(self.support)

    @property
    def nchan(self) -> int:
        return len(self.plans)

    @classmethod
    def of(cls, store: dict, plans) -> "GridPlanStack":
        """The stack of ``plans``, whose :data:`STACKED` arrays are the rows
        of ``store`` (filled by :func:`stack_views`)."""
        plans = tuple(plans)
        p0 = plans[0]
        for c, gp in enumerate(plans):
            if (gp.n, gp.npixel, gp.nplanes, gp.wstacked, gp.support, gp.nearest) != (
                p0.n, p0.npixel, p0.nplanes, p0.wstacked, p0.support, p0.nearest
            ):
                raise ValueError(f"channel {c}: plan geometry differs from channel 0")
            for name in STACKED:
                view = getattr(gp, name)
                if view.numel() and view.data_ptr() != store[name][c].data_ptr():
                    raise ValueError(f"channel {c}: {name} is not a view of the stack")
        n_in = torch.tensor(
            [gp.n_in for gp in plans], dtype=torch.int32, device=p0.perm.device
        )
        return cls(
            **{name: store[name] for name in STACKED},
            n_in=n_in,
            plans=plans,
            n=p0.n,
            npixel=p0.npixel,
            nplanes=p0.nplanes,
            wstacked=p0.wstacked,
            support=p0.support,
            nearest=p0.nearest,
        )


# The default chunk: the largest power of two in [_CHUNK_MIN, _CHUNK_MAX]
# that cuts the segments into at least _GRID_CTAS chunks, a few waves of
# the grid kernel's 3 resident CTAs on each of an H100's 132 SMs. The
# flagship (9.9M entries) keeps 2048; a config-4 cube channel (~294k
# entries) gets 256 in place of ~150 CTAs at 2048.
_CHUNK_MAX = 2048
_CHUNK_MIN = 256
_GRID_CTAS = 1024


def default_chunk(counts: torch.Tensor) -> int:
    """The default ``chunk`` for segments of ``counts`` entries."""
    sizes = []
    size = _CHUNK_MAX
    while size >= _CHUNK_MIN:
        sizes.append(size)
        size //= 2
    c = torch.tensor(sizes, device=counts.device, dtype=counts.dtype)
    nchunks = ((counts[None, :] + c[:, None] - 1) // c[:, None]).sum(1)
    for size, n in zip(sizes, nchunks.tolist()):
        if n >= _GRID_CTAS:
            return size
    return _CHUNK_MIN


def make_grid_plan(
    u_pix,
    v_pix,
    plane_idx=None,
    plane_frac=None,
    *,
    npixel: int,
    support: int = 8,
    nplanes: int = 1,
    tile: int = 64,
    chunk: int | None = None,
    beta: float | None = None,
    u_lo=None,
    v_lo=None,
    taps_scale=None,
) -> GridPlan:
    """Build a plan from fractional grid coordinates (same contract as the
    JAX package's ``make_grid_plan``): ``plane_idx`` and ``plane_frac``
    give linear w-stacking over ``nplanes`` planes, ``plane_idx`` alone a
    nearest-plane plan (each entry on its one plane, ``nplanes`` segments
    of tiles). ``support`` is 1 to ``tile``, as in the JAX package, and
    the card takes every such support on every tile (a larger one raises
    ``ValueError``: its windows would reach past the next tile's, where
    the JAX package fails on a negative index). ``chunk`` is the most
    entries one grid CTA takes (None: :func:`default_chunk`); it changes only how the
    work is partitioned.
    ``u_lo``/``v_lo``: residuals of split (hi, lo) coordinates.
    ``taps_scale``: optional [n] per-entry factor folded into the stored
    u taps (the ES pair weight of an eskernel plan's entry copy), at no
    cost to the kernels."""
    if support > tile:
        raise ValueError(
            f"support {support} is wider than the tile {tile}: a plan takes "
            f"supports 1 to its tile"
        )
    if support < 1:
        raise ValueError(f"support {support}: a plan takes supports 1 to its tile")
    odd = support % 2
    if odd and support % tile == 0:
        # the spare cell past a window at the tile's start would leave the grid
        raise ValueError(f"tile {tile} divides the odd support {support}")
    device = u_pix.device
    if u_pix.dtype != torch.float64:
        u_pix = u_pix.to(torch.float32)
        v_pix = v_pix.to(torch.float32)
    half = support // 2
    nta = npixel // tile
    if nta * tile != npixel:
        raise ValueError(f"tile {tile} must divide npixel {npixel}")
    ntiles = nta * nta
    wstacked = plane_idx is not None and plane_frac is not None and nplanes > 1
    nearest = plane_idx is not None and plane_frac is None and nplanes > 1

    iu0 = torch.floor(u_pix).to(torch.int32) - (half - 1)
    iv0 = torch.floor(v_pix).to(torch.int32) - (half - 1)
    in_grid = (
        (iu0 >= 0)
        & (iu0 + support <= npixel)
        & (iv0 >= 0)
        & (iv0 + support <= npixel)
    )
    iu0c = torch.clamp(iu0, 0, npixel - support)
    iv0c = torch.clamp(iv0, 0, npixel - support)
    base = (iv0c // tile) * nta + (iu0c // tile)
    if wstacked:
        p0 = torch.clamp(plane_idx.to(torch.int32), 0, nplanes - 2)
        frac = plane_frac.to(torch.float32)
        nseg = ntiles * (nplanes - 1)
    elif nearest:
        p0 = torch.clamp(plane_idx.to(torch.int32), 0, nplanes - 1)
        frac = torch.zeros(u_pix.shape, dtype=torch.float32, device=device)
        nseg = ntiles * nplanes
    else:
        p0 = torch.zeros_like(iu0c)
        frac = torch.zeros(u_pix.shape, dtype=torch.float32, device=device)
        nseg = ntiles
    seg = torch.where(in_grid, p0 * ntiles + base, nseg)
    if odd:
        # the cell before the window counts where it is in the entry's tile
        iu0c = iu0c - (iu0c % tile != 0).to(iu0c.dtype)
        iv0c = iv0c - (iv0c % tile != 0).to(iv0c.dtype)

    perm = torch.argsort(seg, stable=True)
    seg_s = seg[perm]
    n = int(u_pix.shape[0])
    n_in = int(in_grid.sum())
    u_s, v_s = u_pix[perm], v_pix[perm]
    iu0_s, iv0_s = iu0c[perm], iv0c[perm]
    ku = _es_taps(
        u_s, iu0_s, support, support + odd, beta,
        lo=None if u_lo is None else u_lo[perm],
    )
    kv = _es_taps(
        v_s, iv0_s, support, support + odd, beta,
        lo=None if v_lo is None else v_lo[perm],
    )
    if taps_scale is not None:
        ku = (ku * taps_scale[perm].to(torch.float32)[:, None]).contiguous()

    counts = torch.bincount(seg_s[:n_in], minlength=nseg)[:nseg]
    starts = torch.cumsum(counts, 0) - counts
    if chunk is None:
        chunk = default_chunk(counts)
    nch = (counts + chunk - 1) // chunk  # chunks per segment (0 if empty)
    chunk_seg = torch.repeat_interleave(
        torch.arange(nseg, device=device), nch
    )
    first = torch.cumsum(nch, 0) - nch
    k = torch.arange(chunk_seg.shape[0], device=device) - first[chunk_seg]
    chunk_start = starts[chunk_seg] + k * chunk
    chunk_count = torch.clamp(counts[chunk_seg] - k * chunk, max=chunk)

    # the grid kernel walks each segment by window corner (row, then
    # column): one stable argsort, segments stay where they are
    key = (seg_s[:n_in].to(torch.int64) * npixel + iv0_s[:n_in]) * npixel
    korder = torch.argsort(key + iu0_s[:n_in], stable=True)

    def i32(x):
        return x.to(torch.int32).contiguous()

    def amax(x):
        return x.abs().amax() if x.numel() else torch.zeros((), device=device)

    weight = torch.clamp(torch.maximum(amax(frac), amax(1.0 - frac)), min=1.0)
    tap_bound = (amax(ku) * amax(kv) * weight).to(torch.float32).reshape(1)

    # plan -> natural order is a gather through the inverse permutation:
    # on the card a gather with coalesced writes is faster than the
    # scatter (K4 at the flagship, PERF.md)
    iperm = torch.empty_like(perm)
    iperm[perm] = torch.arange(n, device=device, dtype=perm.dtype)
    return GridPlan(
        perm=i32(perm),
        iperm=i32(iperm),
        iu0=i32(iu0_s),
        iv0=i32(iv0_s),
        plane=i32(p0[perm]),
        frac=frac[perm].contiguous(),
        ku=ku,
        kv=kv,
        chunk_seg=i32(chunk_seg),
        chunk_start=i32(chunk_start),
        chunk_count=i32(chunk_count),
        korder=i32(korder),
        tap_bound=tap_bound,
        n=n,
        n_in=n_in,
        npixel=npixel,
        support=support,
        nplanes=nplanes,
        tile=tile,
        wstacked=wstacked,
        beta=beta,
        nearest=nearest,
    )


def sort_values(plan: GridPlan, vals: torch.Tensor) -> torch.Tensor:
    """Natural order -> plan order, as complex64."""
    return permute_apply(plan.perm, vals.to(torch.complex64))


def unsort_values(plan: GridPlan, vals_sorted: torch.Tensor) -> torch.Tensor:
    """Plan order -> natural order, as complex64."""
    return permute_apply(plan.iperm, vals_sorted.to(torch.complex64))


def grid_with_plan(
    plan: GridPlan,
    vals: torch.Tensor,
    *,
    values_sorted: bool = False,
    raw: bool = False,
    bound=None,
) -> torch.Tensor:
    """Grid (weighted) values; ``[nplanes, npix, npix]`` complex64 grids
    (``[npix, npix]`` for a single-plane plan). ``values_sorted=True``
    takes values already in plan order. ``raw``/``bound``: the sharded
    invert's route (``gridding_fused.grid``): the planes before the
    conversion, gridded at a bound shared by every shard."""
    vals = vals.to(torch.complex64).contiguous()
    if not values_sorted:
        vals = sort_values(plan, vals)
    grids = grid(plan, vals, raw=raw, bound=bound)
    return grids if plan.wstacked or plan.nearest else grids[0]


def degrid_with_plan(
    plan: GridPlan, grids: torch.Tensor, *, to_sorted: bool = False
) -> torch.Tensor:
    """Degrid values from (w-stacked) grids; ``to_sorted=True`` returns
    them in plan order."""
    if grids.ndim == 2:
        grids = grids[None]
    vals = degrid(plan, grids.to(torch.complex64).contiguous())
    return vals if to_sorted else unsort_values(plan, vals)
