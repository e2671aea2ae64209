"""Invert, predict and gain solve with visibility rows over a mesh.

Counterpart of ``ska_sdp_func_python_tpu/parallel/distributed.py``. The
flattened rows of each image channel are zero-padded to a multiple of the
shard count and shard d takes block d; this process runs its shards one
after another:

* invert: each shard grids its rows through ``ops.imaging.invert_core``
  (the core path, kernel K9's tiled gridder) and the dirty images and sums
  of weights are summed over the mesh;
* predict: each shard degrids its rows (``predict_core``); the image is
  the same everywhere, so no reduction is needed (a run of several
  processes gathers the rows each returns);
* gain solve: baselines are padded as antenna pair (0, 0) with zero
  weight, each shard assembles the normal equations of its baselines,
  they are summed over the mesh and StefCal runs once on the sum.
"""

from __future__ import annotations

import torch

from ..models.gaintable import GainTable, create_gaintable_from_visibility
from ..models.image import Image
from ..models.visibility import Visibility
from ..ops.imaging import invert_core, normalise_sumwt, predict_core
from ..ops.solvers import assemble_normal_equations, baseline_sums, ne_index_map, solve_gains_core
from ..ops.visibility_ops import divide_visibility
from .collectives import all_gather, psum
from .mesh import Mesh

__all__ = [
    "distributed_invert",
    "distributed_predict",
    "distributed_solve_gaintable",
]


def _pad_rows(n: int, nshards: int) -> int:
    return (-n) % nshards


def _flatten_rows(vis: Visibility, imchan_mfs: bool, ichan: int):
    """The flattened (time, baseline[, chan]) rows of one image channel."""
    uvw_l = vis.uvw_lambda
    fsel = slice(None) if imchan_mfs else slice(ichan, ichan + 1)
    return (*(uvw_l[:, :, fsel, i].reshape(-1) for i in range(3)), fsel)


def _local_rows(mesh: Mesh, x: torch.Tensor, pad: int) -> list:
    """This process's shards' blocks of ``x`` zero-padded by ``pad`` rows,
    each on its shard's device."""
    x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
    m = x.shape[0] // mesh.nshards
    return [x[d * m : (d + 1) * m].to(dev) for d, dev in zip(mesh.local, mesh.devices)]


def distributed_invert(
    vis: Visibility,
    model: Image,
    mesh: Mesh,
    axis: str = "data",
    dopsf: bool = False,
    normalise: bool = True,
    support: int = 8,
    nw: int = 1,
    do_wstacking: bool = False,
    **kwargs,
):
    """Invert with visibility rows sharded over ``axis`` and the dirty
    image summed over the mesh. Returns (Image, sumwt)."""
    nchan_img, npol_img = model.nchan, model.npol
    mfs = nchan_img == 1 and vis.nchan > 1
    ms = vis.flagged_vis
    if dopsf:
        ms = torch.zeros_like(ms)
        ms[..., 0] = 1.0
    wgt = vis.flagged_imaging_weight
    pixels = torch.zeros_like(model.pixels)
    sumwt = torch.zeros((nchan_img, npol_img), dtype=wgt.dtype, device=wgt.device)
    for ichan in range(nchan_img):
        uu, vv, ww, fsel = _flatten_rows(vis, mfs, ichan)
        pad = _pad_rows(uu.shape[0], mesh.nshards)
        rows = [_local_rows(mesh, x, pad) for x in (uu, vv, ww)]
        for pol in range(npol_img):
            vals = _local_rows(mesh, ms[:, :, fsel, pol].reshape(-1), pad)
            wv = _local_rows(mesh, wgt[:, :, fsel, pol].reshape(-1), pad)
            dirty, swt = psum(mesh, [
                invert_core(
                    u, v, w, x, y, npixel=model.npixel, cellsize=model.cellsize,
                    support=support, nw=nw, do_wstacking=do_wstacking, gridder="tiled",
                )
                for u, v, w, x, y in zip(*rows, vals, wv)
            ])
            pixels[ichan, pol] = dirty.to(pixels.dtype)
            sumwt[ichan, pol] = swt
    out = model.replace(pixels=pixels)
    if normalise:
        out = normalise_sumwt(out, sumwt)
    return out, sumwt


def distributed_predict(
    vis: Visibility,
    model: Image,
    mesh: Mesh,
    axis: str = "data",
    support: int = 8,
    nw: int = 1,
    do_wstacking: bool = False,
    **kwargs,
) -> Visibility:
    """Predict with rows sharded over ``axis``: each shard degrids its rows
    from the whole image, without a shift to the image's phase centre (as
    the JAX package's)."""
    nchan_img, npol_img = model.nchan, model.npol
    mfs = nchan_img == 1 and vis.nchan > 1
    newvis = torch.zeros(vis.vis.shape[:3] + (npol_img,), dtype=vis.vis.dtype, device=vis.device)
    for ichan in range(nchan_img):
        uu, vv, ww, fsel = _flatten_rows(vis, mfs, ichan)
        n = uu.shape[0]
        pad = _pad_rows(n, mesh.nshards)
        rows = [_local_rows(mesh, x, pad) for x in (uu, vv, ww)]
        nf = vis.uvw_lambda[:, :, fsel, 0].shape
        for pol in range(npol_img):
            parts = [
                predict_core(
                    u, v, w, model.pixels[ichan, pol].to(u.device), cellsize=model.cellsize,
                    support=support, nw=nw, do_wstacking=do_wstacking, gridder="tiled",
                )
                for u, v, w in zip(*rows)
            ]
            if mesh.multiprocess:
                parts = all_gather(mesh, parts)
            vals = torch.cat([p.to(vis.device) for p in parts])
            newvis[:, :, fsel, pol] += vals[:n].reshape(nf).to(newvis.dtype)
    return vis.replace(vis=newvis)


def distributed_solve_gaintable(
    vis: Visibility,
    modelvis: Visibility | None,
    mesh: Mesh,
    axis: str = "data",
    phase_only: bool = True,
    niter: int = 200,
    tol: float = 1e-6,
    crosspol: bool = False,
    jones_type: str = "T",
    timeslice=None,
) -> GainTable:
    """Gain solve with the baseline axis sharded over ``axis``: each shard
    assembles the antenna-pair normal equations of its baselines, their
    sum over the mesh feeds one StefCal solve."""
    point_vis = divide_visibility(vis, modelvis) if modelvis is not None else vis
    gain_table = create_gaintable_from_visibility(vis, jones_type=jones_type, timeslice=timeslice)
    nants, nbl = vis.nants, vis.nbaselines
    pad = _pad_rows(nbl, mesh.nshards)
    xb, wb = baseline_sums(point_vis, gain_table)
    # padded baselines: antenna pair (0, 0), zero weight, on the diagonal
    # the solver masks
    xb = torch.cat([xb, torch.zeros_like(xb[:, :1]).expand(-1, pad, -1, -1)], dim=1)
    wb = torch.cat([wb, torch.zeros_like(wb[:, :1]).expand(-1, pad, -1, -1)], dim=1)
    a1 = torch.cat([vis.antenna1.cpu(), torch.zeros(pad, dtype=vis.antenna1.dtype)]).numpy()
    a2 = torch.cat([vis.antenna2.cpu(), torch.zeros(pad, dtype=vis.antenna2.dtype)]).numpy()
    m = (nbl + pad) // mesh.nshards
    parts = []
    for d, dev in zip(mesh.local, mesh.devices):
        sl = slice(d * m, (d + 1) * m)
        ne_idx = torch.as_tensor(ne_index_map(a1[sl], a2[sl], nants), device=dev).long()
        parts.append(assemble_normal_equations(xb[:, sl].to(dev), wb[:, sl].to(dev), ne_idx, nants))
    x, xwt = psum(mesh, parts)
    gain, gwt, residual = solve_gains_core(
        x, xwt, gain_table.gain.to(x.device), niter=niter, tol=tol,
        phase_only=phase_only, crosspol=crosspol, npol=vis.npol,
    )
    return gain_table.replace(gain=gain, weight=gwt, residual=residual)
