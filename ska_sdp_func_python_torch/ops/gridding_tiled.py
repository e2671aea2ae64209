"""Tiled gridding: the gridder of the epsilon contract's core path.

Counterpart of ``ska_sdp_func_python_tpu/ops/gridding_tiled.py``. Each
visibility becomes one entry per w-plane it feeds (none, nearest, linear,
quadratic or ES-kernel w-weights), the entries are keyed on their (plane,
v-tile, u-tile) segment and, within a segment, window corner (which K9's
register sums need) and sorted once with a stable ``torch.argsort``, and
the sorted stream is cut into units of at most ``unit`` entries of one
segment. The JAX package carries the payloads through ``lax.sort`` and
gathers them into padded ``[units, C]`` copies; here the payloads are
gathered once through the permutation and read in place.

Gridding runs kernel K9 (``csrc/unit_tiles.cu``) through
:func:`unit_tiles`: the unit compute, the reduction of units onto tiles and
the overlap-add into the plane grids in one launch, summed in fixed point
(the same bits on every run), at every support from 1 to the tile and on
every tile, as the JAX package's: even supports to 16 through a shared
tile where one block holds it, odd ones and supports to 64, and larger
tiles, through K9's wide variant, whose tile is held in bands over a
cluster of CTAs (in turns where the bands hold fewer rows than the tile);
supports past 64 and tiles of which no cluster holds one window's rows
through K9's route 4, which serves the tile a sub-tile of window corners
after another, each with its halo held in shared memory over a cluster,
and whose walks past 64 span the CTAs of a cluster, sharing each batch's
taps through distributed shared memory (past the largest window a
cluster holds, the held cells in blocks, each window clipped to them);
support 1, whose taps are zero,
launches only the conversion (``ska_unit_tiles_route`` names the route
of a geometry, ``ska_unit_tiles_band_geometry`` route 4's launch). Its
plain version
:func:`unit_tiles_plain` is the XLA formulation written in PyTorch: the
dense ES factors over each unit's tile, ``(kv * val) @ ku^T`` as a batched
matmul, and an ``index_add_`` of the tiles into the grids. Degridding
(:func:`tiled_degrid`) reaches no TPU kernel in the JAX package; its unit
values stay batched ``torch.bmm`` over chunks of units, and one scatter
through the permutation restores the natural order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from .gridding import es_kernel

__all__ = [
    "EntryStream",
    "entry_stream",
    "sorted_seg_bounds",
    "tiled_grid",
    "tiled_degrid",
    "unit_tiles",
    "unit_tiles_plain",
]

# elements of one [units, buf, C] temporary of the plain unit compute and
# of the degrid's unit values
_CHUNK_ELEMS = 1 << 24


def sorted_seg_bounds(seg_s: torch.Tensor, nbins: int):
    """(starts, counts) of each bin ``[0, nbins)`` in a sorted key array."""
    bins = torch.arange(nbins + 1, device=seg_s.device, dtype=seg_s.dtype)
    edges = torch.searchsorted(seg_s, bins).to(torch.int64)
    return edges[:-1], edges[1:] - edges[:-1]


def _unit_table(seg_s: torch.Tensor, nseg: int, unit: int):
    """(start, count, segment) int32 of every unit: each segment's run of
    the sorted stream cut into pieces of at most ``unit`` entries."""
    starts, counts = sorted_seg_bounds(seg_s, nseg)
    nunits = (counts + unit - 1) // unit
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=seg_s.device), nunits
    )
    first = torch.cumsum(nunits, 0) - nunits
    k = torch.arange(seg.shape[0], device=seg_s.device) - first[seg]
    start = starts[seg] + k * unit
    count = torch.clamp(counts[seg] - k * unit, max=unit)

    def i32(x):
        return x.to(torch.int32).contiguous()

    return i32(start), i32(count), i32(seg)


def _entries(
    u_pix, v_pix, plane_idx, plane_frac, *, npixel, support, nplanes, tile,
    w_order,
):
    """The entry stream of the tiled gridder before the sort.

    Returns (segment id of every entry ``[ncop * n]`` int64, with ``ntot``
    for entries outside the grid; the entry weights ``[ncop * n]`` real or
    None; ncop; ntot; the window corner of every entry within its segment
    ``[ncop * n]`` int64, ``iv0 * npixel + iu0``). Entry ``k * n + i`` is
    copy ``k`` of visibility ``i``."""
    if w_order == 2 and plane_idx is not None and nplanes < 3:
        # the 3-plane stencil clips the centre plane to [1, nplanes-2]
        raise ValueError(f"w_order=2 needs nplanes >= 3, got {nplanes}")
    if w_order >= 4 and plane_idx is not None and nplanes < w_order + 1:
        raise ValueError(
            f"w_order={w_order} (ES w-kernel) needs nplanes >= "
            f"{w_order + 1}, got {nplanes}"
        )
    half = support // 2
    nta = npixel // tile
    if nta * tile != npixel:
        raise ValueError(f"tile {tile} must divide npixel {npixel}")
    ntiles = nta * nta
    iu0 = torch.floor(u_pix).to(torch.int64) - (half - 1)
    iv0 = torch.floor(v_pix).to(torch.int64) - (half - 1)
    in_grid = (
        (iu0 >= 0)
        & (iu0 + support <= npixel)
        & (iv0 >= 0)
        & (iv0 + support <= npixel)
    )
    iu0c = torch.clamp(iu0, 0, npixel - support)
    iv0c = torch.clamp(iv0, 0, npixel - support)
    base = (iv0c // tile) * nta + iu0c // tile
    corner = iv0c * npixel + iu0c
    if plane_idx is None:
        ntot = ntiles
        return torch.where(in_grid, base, ntot), None, 1, ntot, corner
    ntot = ntiles * nplanes
    p = plane_idx.to(torch.int64)
    rdtype = u_pix.dtype
    if plane_frac is None:
        # nearest plane: one entry per visibility
        return torch.where(in_grid, p * ntiles + base, ntot), None, 1, ntot, corner
    if w_order == 2:
        # quadratic 3-plane Lagrange stencil: plane_idx is the centre plane
        # and plane_frac the signed offset x in [-0.5, 0.5]
        x = plane_frac.to(rdtype)
        offs = (-1, 0, 1)
        wts = [0.5 * x * (x - 1.0), 1.0 - x * x, 0.5 * x * (x + 1.0)]
    elif w_order >= 4:
        # ES-kernel w-gridding: w_order planes from the first tap plane
        # plane_idx, with ES weights at the continuous plane offsets
        tf = plane_frac.to(rdtype)
        offs = tuple(range(w_order))
        wts = [
            es_kernel((k - tf) / (w_order / 2.0), w_order)
            for k in offs
        ]
    else:
        # linear: the two neighbouring planes
        f = plane_frac.to(rdtype)
        offs = (0, 1)
        wts = [1.0 - f, f]
    tid = torch.cat(
        [torch.where(in_grid, (p + dj) * ntiles + base, ntot) for dj in offs]
    )
    return tid, torch.cat(wts), len(offs), ntot, corner.repeat(len(offs))


def _sorted_stream(tid_all, ntot, corner_all, npixel: int):
    """(permutation of the in-grid entries in segment order and, within a
    segment, in window-corner order (row, then column: consecutive entries
    then share most cells of their windows, which K9's register sums
    need), their sorted segment ids): one stable argsort of the keys of
    :func:`_entries`; out-of-grid entries (segment ntot) sort last and are
    dropped."""
    perm = torch.argsort(tid_all * (npixel * npixel) + corner_all, stable=True)
    n_in = int((tid_all < ntot).sum())
    perm = perm[:n_in]
    return perm, tid_all[perm].contiguous()


def _es_dense(t0, pix, lo, length: int, support: int, beta):
    """k[u, r, c] = es(((t0_u - pix_uc) + r) - lo_uc) over ``length``
    cells (the JAX package's order: the small hi difference first)."""
    r = torch.arange(length, device=pix.device, dtype=pix.dtype)
    offs = (t0[:, None, None] - pix[:, None, :]) + r[None, :, None]
    if lo is not None:
        offs = offs - lo[:, None, :]
    return es_kernel(offs / (support // 2), support, beta)


def _tile_origins(seg, nta: int, tile: int, dtype):
    t = seg.to(torch.int64) % (nta * nta)
    return (
        ((t // nta) * tile).to(dtype),
        ((t % nta) * tile).to(dtype),
    )


def unit_tiles_plain(
    u_s, v_s, vals_s, unit_start, unit_count, unit_seg, *, npixel: int,
    nplanes: int, tile: int, support: int, beta=None, u_lo=None, v_lo=None,
) -> torch.Tensor:
    """Plain version of :func:`unit_tiles`: per unit the dense ES factors
    ``kv, ku [buf, C]`` over the unit's tile (``buf = tile + support``),
    the tile ``(kv * val) @ ku^T`` (re and im) as a batched matmul, and
    the tiles added, halo included, into the plane grids with
    ``index_add_``. Computes in the dtype of ``u_s`` (f64 fields give the
    f64-accumulated reference)."""
    rdtype = u_s.dtype
    dev = u_s.device
    buf = tile + support
    nta = npixel // tile
    npp = npixel * npixel
    out = torch.zeros(nplanes * npp + 1, dtype=vals_s.dtype, device=dev)
    nunits = unit_start.shape[0]
    if nunits == 0:
        return out[:-1].reshape(nplanes, npixel, npixel)
    cmax = int(unit_count.max())
    step = max(1, _CHUNK_ELEMS // (buf * max(buf, cmax)))
    cells = torch.arange(buf, device=dev)
    for a in range(0, nunits, step):
        start = unit_start[a : a + step].to(torch.int64)
        count = unit_count[a : a + step].to(torch.int64)
        seg = unit_seg[a : a + step].to(torch.int64)
        cols = torch.arange(cmax, device=dev)
        valid = cols[None, :] < count[:, None]
        take = torch.where(valid, start[:, None] + cols[None, :], 0)
        tv0, tu0 = _tile_origins(seg, nta, tile, rdtype)
        kv = _es_dense(
            tv0, v_s[take], None if v_lo is None else v_lo[take], buf,
            support, beta,
        )
        ku = _es_dense(
            tu0, u_s[take], None if u_lo is None else u_lo[take], buf,
            support, beta,
        )
        val = torch.where(valid, vals_s[take], 0)
        kut = ku.transpose(1, 2)
        tr = torch.bmm(kv * val.real.to(rdtype)[:, None, :], kut)
        ti = torch.bmm(kv * val.imag.to(rdtype)[:, None, :], kut)
        tiles = torch.complex(tr, ti).to(vals_s.dtype)
        # overlap-add: cell (y, x) of a tile lands at (tv0 + y, tu0 + x) of
        # its plane; cells past the grid edge go to a discarded slot
        gy = tv0.to(torch.int64)[:, None] + cells[None, :]
        gx = tu0.to(torch.int64)[:, None] + cells[None, :]
        plane = seg // (nta * nta)
        idx = (plane[:, None, None] * npp + gy[:, :, None] * npixel
               + gx[:, None, :])
        inside = (gy[:, :, None] < npixel) & (gx[:, None, :] < npixel)
        idx = torch.where(inside, idx, nplanes * npp)
        out.index_add_(0, idx.reshape(-1), tiles.reshape(-1))
    return out[:-1].reshape(nplanes, npixel, npixel)


def unit_tiles(
    u_s, v_s, vals_s, unit_start, unit_count, unit_seg, *, npixel: int,
    nplanes: int, tile: int, support: int, beta=None, u_lo=None, v_lo=None,
) -> torch.Tensor:
    """Grid a segment-sorted entry stream onto ``[nplanes, npixel,
    npixel]`` complex grids (kernel K9 on CUDA).

    ``u_s, v_s``: [n] fractional grid coordinates (f32 or f64) of the
    entries in segment order; ``vals_s``: [n] their weighted values
    (complex64 with f32 coordinates, complex128 with f64); ``u_lo,
    v_lo``: optional [n] residuals of split (hi, lo) coordinates;
    ``unit_start, unit_count, unit_seg``: [units] int32, each unit at most
    ``unit`` entries of one (plane, tile) segment, ``segment = plane *
    ntiles + v_tile * ntiles_axis + u_tile``. Every entry of a unit lies in
    the grid. ``beta``: the ES shape parameter (None: 2.3 * support)."""
    if beta is None:
        beta = 2.3 * support
    if u_s.device.type == "cpu":
        return unit_tiles_plain(
            u_s, v_s, vals_s, unit_start, unit_count, unit_seg,
            npixel=npixel, nplanes=nplanes, tile=tile, support=support,
            beta=beta, u_lo=u_lo, v_lo=v_lo,
        )
    dev = u_s.device
    rdtype = u_s.dtype
    if rdtype not in (torch.float32, torch.float64):
        raise TypeError(f"u_s: dtype {rdtype}, expected float32 or float64")
    cdtype = torch.complex128 if rdtype == torch.float64 else torch.complex64
    if not 1 <= support <= tile:
        raise ValueError(
            f"support {support}: the kernel takes 1 to the tile ({tile}), as "
            f"the JAX package's tiled gridder does"
        )
    if npixel % tile:
        raise ValueError(f"tile {tile} must divide npixel {npixel}")
    if (u_lo is None) != (v_lo is None):
        raise ValueError("u_lo and v_lo: give both or neither")
    f64 = rdtype == torch.float64
    k = kernels.KERNELS["unit_tiles"]
    chk = kernels.check_cuda_tensor
    n = u_s.shape[0]
    for name, t in (("v_s", v_s), ("vals_s", vals_s), ("u_lo", u_lo),
                    ("v_lo", v_lo)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected ({n},)")
    nunits = int(unit_start.shape[0])
    if nunits == 0:
        return torch.zeros((nplanes, npixel, npixel), dtype=cdtype, device=dev)
    out = torch.empty((nplanes, npixel, npixel), dtype=cdtype, device=dev)
    # the kernel sums in fixed point (one int64 word a value in f32, a
    # 128-bit pair in f64), scaled by the stream's bound: the sum of |re| +
    # |im| over the values (every tap product is at most 1)
    vsum = torch.view_as_real(vals_s).abs().sum(dtype=torch.float64).reshape(1)
    words = 2 if f64 else 1
    grid64 = torch.empty(
        (nplanes, npixel, npixel, 2, words), dtype=torch.int64, device=dev
    )
    k.launch(
        chk("u_s", u_s, rdtype, dev),
        chk("v_s", v_s, rdtype, dev),
        chk("vals_s", vals_s, cdtype, dev),
        None if u_lo is None else chk("u_lo", u_lo, rdtype, dev),
        None if v_lo is None else chk("v_lo", v_lo, rdtype, dev),
        chk("unit_seg", unit_seg, torch.int32, dev),
        chk("unit_start", unit_start, torch.int32, dev),
        chk("unit_count", unit_count, torch.int32, dev),
        vsum.data_ptr(),
        grid64.data_ptr(),
        out.data_ptr(),
        nunits,
        nplanes,
        npixel,
        tile,
        npixel // tile,
        support,
        float(beta),
        int(f64),
    )
    return out


@dataclass(frozen=True)
class EntryStream:
    """The segment-sorted entry stream of :func:`tiled_grid` and its unit
    table: the arguments of :func:`unit_tiles`."""

    u: torch.Tensor  # [n] sorted u pixel coordinates
    v: torch.Tensor  # [n] sorted v pixel coordinates
    vals: torch.Tensor  # [n] sorted weighted values
    u_lo: torch.Tensor | None  # [n] sorted residuals of split coordinates
    v_lo: torch.Tensor | None
    unit_start: torch.Tensor  # [units] int32
    unit_count: torch.Tensor  # [units] int32
    unit_seg: torch.Tensor  # [units] int32
    nplanes: int

    def grid(self, *, npixel: int, tile: int, support: int, beta=None,
             plain: bool = False) -> torch.Tensor:
        """The plane grids of this stream through :func:`unit_tiles` (or
        its plain version)."""
        fn = unit_tiles_plain if plain else unit_tiles
        return fn(
            self.u, self.v, self.vals, self.unit_start, self.unit_count,
            self.unit_seg, npixel=npixel, nplanes=self.nplanes, tile=tile,
            support=support, beta=beta, u_lo=self.u_lo, v_lo=self.v_lo,
        )


def entry_stream(
    u_pix,
    v_pix,
    vals,
    plane_idx=None,
    plane_frac=None,
    u_lo=None,
    v_lo=None,
    *,
    npixel: int,
    support: int = 8,
    nplanes: int = 1,
    tile: int = 56,
    unit: int = 1024,
    w_order: int = 1,
) -> EntryStream:
    """Sort the entries of (optionally w-stacked) visibilities by (plane,
    v-tile, u-tile) segment and window corner (:func:`_sorted_stream`) and
    cut them into units of at most ``unit`` entries (arguments as
    :func:`tiled_grid`)."""
    n = u_pix.shape[0]
    tid, wts, _, ntot, corner = _entries(
        u_pix, v_pix, plane_idx, plane_frac, npixel=npixel, support=support,
        nplanes=nplanes, tile=tile, w_order=w_order,
    )
    perm, seg_s = _sorted_stream(tid, ntot, corner, npixel)
    src = perm % n  # the visibility of each sorted entry
    vals_s = vals[src]
    if wts is not None:
        vals_s = vals_s * wts[perm].to(vals_s.dtype)
    start, count, seg = _unit_table(seg_s, ntot, unit)

    def gather(x):
        return None if x is None else x[src].to(u_pix.dtype).contiguous()

    return EntryStream(
        gather(u_pix), gather(v_pix), vals_s.contiguous(), gather(u_lo),
        gather(v_lo), start, count, seg, ntot // (npixel // tile) ** 2,
    )


def tiled_grid(
    u_pix,
    v_pix,
    vals,
    plane_idx=None,
    plane_frac=None,
    u_lo=None,
    v_lo=None,
    *,
    npixel: int,
    support: int = 8,
    nplanes: int = 1,
    tile: int = 56,
    unit: int = 1024,
    beta: float | None = None,
    w_order: int = 1,
):
    """Grid (optionally w-stacked) visibilities onto ``[nplanes, npixel,
    npixel]`` (same contract as the JAX package's ``tiled_grid``).

    :param u_pix, v_pix: [N] fractional grid coordinates
    :param vals: [N] complex weighted visibilities
    :param plane_idx: [N] plane index per vis (or None): the lower plane
        (linear, ``w_order=1``), the centre plane (``w_order=2``), the
        first tap plane (ES, ``w_order >= 4``) or, with ``plane_frac``
        None, the nearest plane
    :param plane_frac: [N] the matching fraction or offset (or None)
    :param u_lo, v_lo: optional [N] residuals of split (hi, lo) coordinates
    :param unit: the most entries one unit (one CTA of K9) takes; it
        changes only how the work is partitioned
    :return: complex grids (squeezed to [npixel, npixel] without planes)
    """
    stream = entry_stream(
        u_pix, v_pix, vals, plane_idx, plane_frac, u_lo, v_lo,
        npixel=npixel, support=support, nplanes=nplanes, tile=tile,
        unit=unit, w_order=w_order,
    )
    grids = stream.grid(npixel=npixel, tile=tile, support=support, beta=beta)
    return grids[0] if nplanes == 1 and plane_idx is None else grids


def _extract_tiles(grid: torch.Tensor, ts: int, support: int) -> torch.Tensor:
    """Inverse of the overlap-add: all (ts + S)^2 tiles of ``[..., n, n]``
    grids as ``[..., ntv, ntu, buf, buf]``, by reshapes and rolls."""
    n = grid.shape[-1]
    ntv = n // ts
    lead = grid.shape[:-2]

    def blocks(g):
        return g.reshape(*lead, ntv, ts, ntv, ts).transpose(-3, -2)

    a = blocks(grid)
    b = blocks(torch.roll(grid, -ts, dims=-1))[..., :, :support]
    c = blocks(torch.roll(grid, -ts, dims=-2))[..., :support, :]
    d = blocks(torch.roll(grid, (-ts, -ts), dims=(-2, -1)))[
        ..., :support, :support
    ]
    top = torch.cat([a, b], dim=-1)
    bottom = torch.cat([c, d], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def tiled_degrid(
    u_pix,
    v_pix,
    grids,
    plane_idx=None,
    plane_frac=None,
    u_lo=None,
    v_lo=None,
    *,
    support: int = 8,
    nplanes: int = 1,
    tile: int = 56,
    unit: int = 1024,
    beta: float | None = None,
    w_order: int = 1,
):
    """Degrid visibilities from (optionally w-stacked) grids: the adjoint
    of :func:`tiled_grid` (same contract as the JAX package's
    ``tiled_degrid``).

    Per unit, the unit's whole tile and the dense ES factors give
    ``val[c] = w_c sum_r kv[r, c] (T @ ku)[r, c]`` as a batched matmul;
    the unit values are scattered back to their entries through the
    sort's permutation (out-of-grid entries stay zero) and the copies of
    each visibility are summed.

    :param grids: [nplanes, npixel, npixel] complex (or [npixel, npixel])
    :return: [N] complex visibilities in the real dtype of ``u_pix``
    """
    if grids.ndim == 2:
        grids = grids[None]
    npixel = grids.shape[-1]
    nvis = u_pix.shape[0]
    rdtype = u_pix.dtype
    cdtype = torch.complex128 if rdtype == torch.float64 else torch.complex64
    tid, wts, ncop, ntot, corner = _entries(
        u_pix, v_pix, plane_idx, plane_frac, npixel=npixel, support=support,
        nplanes=nplanes, tile=tile, w_order=w_order,
    )
    perm, seg_s = _sorted_stream(tid, ntot, corner, npixel)
    src = perm % nvis
    start, count, seg = _unit_table(seg_s, ntot, unit)
    buf = tile + support
    nta = npixel // tile
    tiles = _extract_tiles(grids, tile, support).reshape(-1, buf, buf)
    tiles_r = tiles.real.to(rdtype)
    tiles_i = tiles.imag.to(rdtype)
    vals_s = torch.zeros(perm.shape[0], dtype=cdtype, device=u_pix.device)
    nunits = start.shape[0]
    if nunits:
        cmax = int(count.max())
        step = max(1, _CHUNK_ELEMS // (buf * max(buf, cmax)))
        cols = torch.arange(cmax, device=u_pix.device)
        for a in range(0, nunits, step):
            st = start[a : a + step].to(torch.int64)
            sg = seg[a : a + step].to(torch.int64)
            valid = cols[None, :] < count[a : a + step, None]
            take = torch.where(valid, st[:, None] + cols[None, :], 0)
            s = src[take]
            tv0, tu0 = _tile_origins(sg, nta, tile, rdtype)
            kv = _es_dense(
                tv0, v_pix[s].to(rdtype),
                None if v_lo is None else v_lo[s].to(rdtype), buf, support,
                beta,
            )
            ku = _es_dense(
                tu0, u_pix[s].to(rdtype),
                None if u_lo is None else u_lo[s].to(rdtype), buf, support,
                beta,
            )
            # vals[c] = sum_{r,x} kv[r,c] T[r,x] ku[x,c]
            vr = (kv * torch.bmm(tiles_r[sg], ku)).sum(1)
            vi = (kv * torch.bmm(tiles_i[sg], ku)).sum(1)
            if wts is not None:
                w = wts[perm[take]].to(rdtype)
                vr, vi = vr * w, vi * w
            vals_s[take[valid]] = torch.complex(vr, vi)[valid]
    vals = torch.zeros(ncop * nvis, dtype=cdtype, device=u_pix.device)
    vals[perm] = vals_s
    out = vals[:nvis]
    for k in range(1, ncop):
        out = out + vals[k * nvis : (k + 1) * nvis]
    return out
