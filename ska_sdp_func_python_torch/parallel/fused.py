"""Sharded fused self-cal over a mesh (baseline or channel shards).

Counterpart of ``ska_sdp_func_python_tpu/parallel/fused.py``: the fused
major cycle (``pipeline._fused_selfcal_cycle``) over this process's shard
workspaces, joined by the collectives the JAX package's ``shard_map``
programs hold (:mod:`.collectives`).

``shard="baseline"``: visibility baselines sharded. Each shard degrids
the (same) model for its rows, assembles the normal equations of its
baselines (one psum a term assembles the whole system, and StefCal runs
once on it), applies its inverse factors, and grids its residual in
int64 fixed point at a bound shared by all shards; the w-plane grids
reduce-scatter over the mesh, each shard runs the FFT and w-beam tail of
its block of planes, and the partial images are summed. CLEAN then runs
once on the whole residual, the same on every process. Per cycle the
collectives move O(nants^2 + nw npad^2) bytes, whatever the number of
visibilities.

``shard="channel"``: image and visibility channels sharded (a cube). The
gridding, FFT and CLEAN of a channel are the shard's own; the normal
equations (the gains are solved over the band) and, for MSMFS, the
channel -> moment transforms are summed over the mesh. One process only,
as in the JAX package.

Each shard carries its own plan on the global w range and plane count,
so that the baseline shards' planes coincide.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ..models.components import SkyComponents
from ..models.image import Image
from ..models.visibility import Visibility
from ..ops.calibration_chain import create_calibration_controls
from ..ops.deconvolution import bound_psf
from ..ops.imaging import _nw_for, make_visibility_plan
from ..ops.taylor import moment_weights
from . import collectives
from .mesh import Mesh
from .multihost import local_shard_indices

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["sharded_ical"]

_WINDOW_FUSABLE = ("hogbom", "msclean", "msmfsclean", "mfsmsclean", "mmclean")


def _pad_baselines(vis: Visibility, nshards: int) -> Visibility:
    """Pad the baseline axis to a multiple of the shard count with
    zero-weight flagged rows (antenna pair (0, 0), zero uvw)."""
    pad = (-vis.nbaselines) % nshards
    if pad == 0:
        return vis

    def padbl(x, value=0):
        shape = list(x.shape)
        shape[1] = pad
        return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=1)

    def pad1(x):
        return torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])

    return vis.replace(
        uvw=padbl(vis.uvw),
        vis=padbl(vis.vis),
        weight=padbl(vis.weight),
        imaging_weight=padbl(vis.imaging_weight),
        flags=padbl(vis.flags, 1),
        antenna1=pad1(vis.antenna1),
        antenna2=pad1(vis.antenna2),
    )


def _shard_slice(vis: Visibility, d: int, nbl_loc: int) -> Visibility:
    sl = slice(d * nbl_loc, (d + 1) * nbl_loc)
    return vis.replace(
        uvw=vis.uvw[:, sl],
        vis=vis.vis[:, sl],
        weight=vis.weight[:, sl],
        imaging_weight=vis.imaging_weight[:, sl],
        flags=vis.flags[:, sl],
        antenna1=vis.antenna1[sl],
        antenna2=vis.antenna2[sl],
    )


def _shard_slice_chan(vis: Visibility, d: int, nch_loc: int) -> Visibility:
    sl = slice(d * nch_loc, (d + 1) * nch_loc)
    return vis.replace(
        vis=vis.vis[:, :, sl],
        weight=vis.weight[:, :, sl],
        imaging_weight=vis.imaging_weight[:, :, sl],
        flags=vis.flags[:, :, sl],
        frequency=vis.frequency[sl],
        channel_bandwidth=vis.channel_bandwidth[sl],
    )


def _model_slice_chan(model: Image, d: int, nch_loc: int) -> Image:
    sl = slice(d * nch_loc, (d + 1) * nch_loc)
    return model.replace(
        pixels=model.pixels[sl],
        frequency=model.frequency[sl],
        channel_bandwidth=model.channel_bandwidth[sl],
    )


def _to(x, device):
    """A Visibility's or Image's tensor fields on ``device``."""
    return x.replace(**{
        k: v.to(device) for k, v in vars(x).items() if torch.is_tensor(v)
    })


def _check(vis, model, mesh, calibration_context, controls, shard, clean_kwargs):
    """The JAX package's refusals (``fused.py:166-233``)."""
    if shard not in ("baseline", "channel"):
        raise ValueError(f"unknown shard axis {shard!r}")
    windowed = clean_kwargs.get("window_shape") is not None or clean_kwargs.get("mask") is not None
    if windowed and clean_kwargs.get("algorithm", "msclean") not in _WINDOW_FUSABLE:
        raise ValueError(
            "sharded_ical runs the fused CLEAN, which supports windows for "
            f"hogbom/msclean/msmfs; windowed {clean_kwargs.get('algorithm')!r} "
            "must use the composed pipeline"
        )
    has_matrix = any(controls[c]["shape"] == "matrix" for c in calibration_context)
    if has_matrix and (shard == "channel" or model.nchan > 1):
        raise ValueError(
            "full-Jones (matrix) terms fuse on single-plan npol-4 configs "
            "only; channel-sharded and cube runs must use the composed pipeline"
        )
    if shard == "channel" and "B" in calibration_context:
        raise ValueError(
            "bandpass ('B') solves per global frequency channel; with "
            "channel-sharded data each shard holds a local channel slice, so "
            "the per-channel normal equations cannot assemble by psum; use "
            "shard='baseline' for B contexts"
        )
    if shard == "channel" and mesh.multiprocess:
        raise ValueError(
            "shard='channel' assembles the PSF patch in one process; use "
            "shard='baseline' for multi-process runs (its per-cycle "
            "collectives are O(nants^2 + grid), independent of the "
            "visibility count)"
        )
    if shard == "channel":
        if model.nchan != vis.nchan:
            raise ValueError(
                "shard='channel' requires cube mode (model.nchan == vis.nchan, "
                f"got {model.nchan} vs {vis.nchan})"
            )
        if model.nchan % mesh.nshards:
            raise ValueError(f"nchan {model.nchan} not divisible by mesh size {mesh.nshards}")


def sharded_ical(
    vis: Visibility,
    model: Image,
    mesh: Mesh,
    components: Optional[SkyComponents] = None,
    nmajor: int = 5,
    calibration_context: str = "T",
    controls: Optional[dict] = None,
    axis: str = "data",
    context: str = "ng",
    support: int = 8,
    nw: int | None = None,
    solver_niter: int = 200,
    tol: float = 1e-6,
    shard: str = "baseline",
    hlo_out: list | None = None,
    **clean_kwargs,
):
    """Distributed fused ICAL: the fused major cycle over the mesh's shards.

    ``shard="baseline"`` shards visibility baselines (any nchan);
    ``shard="channel"`` shards image and visibility channels (a cube,
    ``model.nchan == vis.nchan``, divisible by the shard count). Every
    process passes the whole observation and builds only its own shards.
    ``hlo_out`` (a list) receives the first cycle's collectives as (op,
    dtypes, bytes), what the JAX package's audit reads from its HLO.

    :return: (model Image, residual Image, restored Image, gaintables)
    """
    from .. import pipeline

    if controls is None:
        controls = create_calibration_controls()
    _check(vis, model, mesh, calibration_context, controls, shard, clean_kwargs)
    pipeline._check_algorithm(model, clean_kwargs)
    nshards = mesh.nshards
    local = local_shard_indices(mesh, axis)
    # every baseline shard stacks onto the same w planes: the range of the
    # real rows (before the padding) and the plane count are global
    wl = vis.uvw_lambda[..., 2]
    w_range = (float(wl.min()), float(wl.max()))
    nwp = _nw_for(vis, model, context != "2d", nw)
    if shard == "channel":
        nloc = model.nchan // nshards
    else:
        vis = _pad_baselines(vis, nshards)
        nloc = vis.nbaselines // nshards

    wss = []
    for d, dev in zip(local, mesh.devices):
        if shard == "channel":
            svis, smodel = _shard_slice_chan(vis, d, nloc), _model_slice_chan(model, d, nloc)
        else:
            svis, smodel = _shard_slice(vis, d, nloc), model
        svis, smodel = _to(svis, dev), _to(smodel, dev)
        # channel shards never mix grids: each keeps the per-channel w
        # range of the single-device plan, only the plane count is global
        plan = make_visibility_plan(
            svis, smodel, context=context, support=support, nw=nwp,
            w_range=w_range if shard == "baseline" else None,
        )
        w = pipeline._FusedSelfCal(
            svis, smodel, plan,
            None if components is None else _to(components, dev),
            list(calibration_context), controls, "mean", solver_niter, tol,
            own_psf=False, **clean_kwargs,
        )
        if shard == "channel":
            w.chans = slice(d * nloc, (d + 1) * nloc)
        wss.append(w)
    if shard == "baseline":
        # K1's fixed-point bound takes every channel's largest tap bound
        tbs = [
            collectives.pmax(mesh, [w.plan.plans[c].gp.tap_bound for w in wss])
            for c in range(wss[0].plan.nchan)
        ]
        for w in wss:
            w.tap_bound_g = tbs

    # the PSF (unit amplitude in the first polarisation) through the same
    # machinery; the patch support comes from the whole PSF, as in the JAX
    # package, so every shard cleans with the same patch
    model0 = _to(model, mesh.devices[0])
    if shard == "channel":
        psf = model0.replace(pixels=torch.cat([
            pipeline._workspace_psf(w, _to(_model_slice_chan(model, d, nloc), w.obs_s[0].device))
            .pixels.to(mesh.devices[0])
            for d, w in zip(local, wss)
        ]))
    else:
        psf = pipeline._workspace_psf(wss, model0, mesh)
    bpsf = bound_psf(psf, psf, clean_kwargs.get("psf_support", None))
    mom = psf_t = None
    if shard == "channel" and wss[0].cfg.algorithm in pipeline._MMCLEAN:
        # the moment weights about the global reference frequency; each
        # shard takes its rows and the moment PSF sums over the mesh
        nmoment = clean_kwargs.get("nmoment", 3)
        nm_psf = 2 * nmoment if nmoment > 1 else 1
        mom = [
            moment_weights(model0.frequency, None, k).to(device=mesh.devices[0], dtype=torch.float32)
            for k in (nmoment, nm_psf)
        ]
        psf_t = collectives.psum(mesh, [
            torch.einsum("cm,cpyx->mpyx", mom[1][w.chans], bpsf.pixels[w.chans].to(torch.float32))
            for w in wss
        ])
    for d, w in zip(local, wss):
        dev = w.obs_s[0].device
        if shard == "channel":
            w.set_psf(
                _to(_model_slice_chan(psf, d, nloc), dev),
                bpsf.pixels[w.chans].to(dev),
                None if mom is None else tuple(m[w.chans].to(dev) for m in mom),
                None if psf_t is None else psf_t.to(dev),
            )
        else:
            w.set_psf(_to(psf, dev), bpsf.pixels.to(dev))

    cfg = wss[0].cfg
    gains = [gt.gain for gt in wss[0].gt0s]
    gwts = [gt.weight for gt in wss[0].gt0s]
    gress = [gt.residual for gt in wss[0].gt0s]
    model_px = torch.zeros_like(model0.pixels, dtype=torch.float32)
    res_px = None
    log.info(
        "sharded_ical[%s]: %d of %d shards ready, %d visibilities",
        shard, len(wss), nshards, vis.nvis,
    )
    for cycle in range(nmajor):
        do_cal = tuple(cycle >= t.first_selfcal for t in cfg.terms)
        with collectives.recording() as record:
            model_px, gains, gwts, gress, res_px, _, peak = pipeline._fused_selfcal_cycle(
                wss, model_px, gains, gwts, gress,
                do_cal=do_cal, with_model=cycle > 0, mesh=mesh,
            )
        if hlo_out is not None and cycle == 0:
            hlo_out.append(list(record))
        if log.isEnabledFor(logging.INFO):
            log.info("sharded_ical: cycle %d peak residual %.6f", cycle, float(peak))
    current = model0.replace(pixels=model_px.to(model.pixels.dtype))
    residual = model0.replace(pixels=res_px) if res_px is not None else None
    gaintables = wss[0].gaintables(gains, gwts, gress)
    restored = pipeline._restore_with_components(
        current, psf, residual, None if components is None else _to(components, mesh.devices[0])
    )
    return current, residual, restored, gaintables
