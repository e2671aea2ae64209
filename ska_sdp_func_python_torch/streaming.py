"""Out-of-core (streamed) self-calibration major cycles.

Counterpart of ``ska_sdp_func_python_tpu/streaming.py``. A self-cal of
hundreds of millions of visibilities cannot hold them, let alone their
sorted copies and plans, on the card. This module runs the fused cycle's
mathematics as a stream over time slabs of the native visibility store
(:mod:`ska_sdp_func_python_torch.io`, whose reader thread reads the next
slab while the card computes on this one):

* per slab: upload the observed visibilities (one complex tensor) and
  the flagged weights, build the slab's plan on the card, degrid the
  current model (kernel K3 over the channel stack, K4 to natural order,
  every polarisation in one launch) and add the in-stream components'
  DFT, solve the slab's gain intervals for every term of the calibration
  chain (the in-memory cycle's ``pipeline._solve_terms``), correct, move
  the residual into plan order (K4) and grid it (K1 per image channel
  and polarisation);
* across slabs: the uv grids and sums of weights accumulate, so device
  memory follows the slab, not the observation;
* per cycle: one FFT and w-stack tail and one CLEAN
  (``ops.deconvolution.deconvolve_cube``, Hogbom by default) on the
  accumulated grids;
* across processes (``distribute=True`` in a ``torch.distributed`` group
  of W processes): process r streams the slabs k with k % W == r, and the
  accumulated grids and sums of weights (f64 in a group) are summed over
  the processes in process order once a cycle (the JAX package's
  ``_psum_tree``), so the CLEAN and the model are the same on every
  process; at the end each slab's gain rows come from the process that
  solved them.

Gain solutions are interval-local: solution intervals are derived per
slab (``timeslice='auto'`` or any interval that does not straddle a slab
boundary gives the gains of a monolithic solve; longer timeslices clamp
to the slab span). Slabs are not padded: the last one holds only the
integrations left (the JAX package pads it to ``chunk_times`` rows for a
static compiled shape, and its merged tables then carry rows for the
padded times).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time as _time
from typing import Optional

import numpy as np
import torch

from .config import complex_of
from .io.visio import VisStore
from .models.gaintable import GainTable, create_gaintable_from_visibility
from .models.image import Image
from .models.visibility import (
    C_M_S,
    Visibility,
    _default_channel_bandwidth,
    _default_integration_time,
)
from .ops.calibration_chain import create_calibration_controls
from .ops.deconvolution import deconvolve_cube, fit_psf, restore_cube
from .ops.dft import dft_kernel, extract_direction_and_flux
from .ops.gain_ops import _gain_row_of_time
from .ops.gridding_plan import grid_with_plan
from .ops.imaging import (
    _nw_for,
    make_visibility_plan,
    predict_with_stack,
    uv_grids_to_dirty,
)
from .ops.permute import permute_apply
from .ops.solvers import _interval_weights, ne_index_map
from .parallel.collectives import psum
from .parallel.mesh import make_mesh
from .pipeline import (
    _FusedCfg,
    _FusedTermCfg,
    _PlanRows,
    _as_list,
    _mueller_apply,
    _solve_terms,
)

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["streamed_ical", "StreamedICALResult"]

_POL_FRAME_OF_NPOL = {1: "stokesI", 2: "linearnp", 4: "linear"}
# the f16 wire's largest magnitude before a per-slab scale (f16 max 65504)
_F16_LIMIT = 3.0e4


class StreamedICALResult(tuple):
    """(model, residual, restored, gaintable) with attribute access.

    ``gaintable`` is a :class:`GainTable` for single-term runs and a
    ``{term: GainTable}`` dict for multi-term chains.
    """

    @property
    def model(self):
        return self[0]

    @property
    def residual(self):
        return self[1]

    @property
    def restored(self):
        return self[2]

    @property
    def gaintable(self):
        return self[3]


class _Slab(_PlanRows):
    """What ``pipeline._solve_terms`` reads of one slab: the natural-order
    observed visibilities and flagged weights ``[t, b, nchan, npol]``, the
    terms' interval maps, the baselines' antennas and the normal
    equations' index map; and the moves between natural order and the
    slab plan's order."""

    def __init__(self, ms_nat, fw_nat, cal, a1, a2, ne_idx, mfs: bool):
        self.ms_nat, self.fw_nat, self.cal = ms_nat, fw_nat, cal
        self.a1, self.a2, self.ne_idx = a1, a2, ne_idx
        self.mfs = mfs

    def to_plan(self, plan, x: torch.Tensor) -> list:
        """Per polarisation, ``x`` [t, b, nchan, npol] in the plan order of
        every image channel, ``[nchan_img, n]``: one K4 launch for all."""
        rows = [self.rows(x[..., p]).contiguous() for p in range(x.shape[-1])]
        return _as_list(permute_apply(plan.stack.perm, *rows))

    def grid(self, plan, vals_s: list) -> list:
        """K1 on each (image channel, polarisation) of plan-ordered
        values: ``[chan][pol]`` uv grids."""
        return [
            [grid_with_plan(ip.gp, v[c], values_sorted=True) for v in vals_s]
            for c, ip in enumerate(plan.plans)
        ]

    def sumwt(self) -> torch.Tensor:
        """Sums of the flagged weights per (image channel, polarisation)."""
        fw = self.fw_nat
        if self.mfs:
            return fw.sum(dim=(0, 1, 2))[None]
        return fw.sum(dim=(0, 1))


def _process_mesh(device):
    """A mesh of one shard a process over the ``torch.distributed`` group
    (of any size), or None outside a group."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return make_mesh(devices=[device])


def _psum_grids(mesh, acc, swt):
    """The accumulated ``[chan][pol]`` grids and sums of weights (None:
    none) summed over the processes in process order (one collective)."""
    if mesh is None:
        return acc, swt
    flat = [g for row in acc for g in row] + ([] if swt is None else [swt])
    out = list(psum(mesh, [tuple(flat)]))
    if swt is not None:
        swt = out.pop()
    npol = len(acc[0])
    return [out[c * npol : (c + 1) * npol] for c in range(len(acc))], swt


def _store_visibility(store, phasecentre, frame, nants, device):
    """A Visibility template of the whole store: its times (f64) and their
    integration times, its frequencies and bandwidths, and its antennas.
    The data fields and uvw are broadcast views that hold no memory;
    :func:`_slab_of` cuts a slab out of it."""
    time = torch.as_tensor(store.time, dtype=torch.float64, device=device)
    freq = torch.as_tensor(store.frequency, device=device).to(torch.float32)
    shape = (store.ntime, store.nbl, store.nchan, store.npol)
    f32 = torch.float32
    one = torch.ones((), dtype=f32, device=device).expand(shape)
    return Visibility(
        vis=torch.zeros((), dtype=complex_of(f32), device=device).expand(shape),
        weight=one,
        imaging_weight=one,
        flags=torch.zeros((), dtype=torch.int32, device=device).expand(shape),
        uvw=torch.zeros((), dtype=f32, device=device).expand(store.ntime, store.nbl, 3),
        time=time,
        integration_time=_default_integration_time(time),
        frequency=freq,
        channel_bandwidth=_default_channel_bandwidth(freq),
        antenna1=torch.as_tensor(store.antenna1, device=device),
        antenna2=torch.as_tensor(store.antenna2, device=device),
        phasecentre=np.asarray(phasecentre, np.float64),
        polarisation_frame=frame,
        nants=nants,
    )


def _slab_of(whole: Visibility, t0: int, nt: int, uvw=None) -> Visibility:
    """Integrations ``t0 .. t0 + nt`` of a store template, with ``uvw``
    (the template's zeros when None: the gaintable set-up reads no
    coordinates). Integration times are the slab's own time spacing, the
    last one repeated, as the JAX package gives them; a slab of one
    integration takes the spacing to the one before it."""
    sl = slice(t0, t0 + nt)
    lo = max(t0 - 1, 0)
    itime = _default_integration_time(whole.time[lo : t0 + nt])[t0 - lo :]
    return whole.replace(
        vis=whole.vis[sl],
        weight=whole.weight[sl],
        imaging_weight=whole.imaging_weight[sl],
        flags=whole.flags[sl],
        uvw=whole.uvw[sl] if uvw is None else uvw,
        time=whole.time[sl],
        integration_time=itime,
    )


def _w_range(store) -> tuple:
    """The store's w range in wavelengths at its highest frequency, read
    in 2048-row chunks of the memory-mapped uvw so that no
    observation-sized temporary is made."""
    wmin, wmax = np.inf, -np.inf
    for t0 in range(0, store.ntime, 2048):
        wc = np.asarray(store.uvw[t0 : t0 + 2048, :, 2])
        wmin, wmax = min(wmin, float(wc.min())), max(wmax, float(wc.max()))
    scale_w = float(np.max(store.frequency)) / C_M_S
    return (wmin * scale_w, wmax * scale_w)


def _upload(x: np.ndarray, wire_dtype, device) -> torch.Tensor:
    """A host f32 array on the card as f32. The f16 wire ships float16
    with a per-slab scale when the magnitude exceeds the f16 range, and
    dequantises on the card (zeros and the flag mask survive exactly;
    ~5e-4 relative quantisation otherwise)."""
    if wire_dtype != "f16":
        return torch.as_tensor(x).to(device)
    m = float(np.max(np.abs(x))) if x.size else 0.0
    if m > _F16_LIMIT:
        s = m / _F16_LIMIT
        return torch.as_tensor((x / s).astype(np.float16)).to(device).to(torch.float32) * s
    return torch.as_tensor(x.astype(np.float16)).to(device).to(torch.float32)


def streamed_ical(
    store,
    model: Image,
    phasecentre,
    nmajor: int = 5,
    chunk_times: int = 16,
    calibration_context: str = "T",
    controls: Optional[dict] = None,
    context: str = "ng",
    support: int = 8,
    nw: int | None = None,
    solver_niter: int = 200,
    tol: float = 1e-6,
    first_selfcal: int = 0,
    components=None,
    polarisation_frame: str | None = None,
    normalise_gains: str | None = None,
    cache_slabs: bool | None = None,
    slab_cache_bytes: float = 8e9,
    distribute: bool = True,
    on_cycle=None,
    model_init: Image | None = None,
    wire_dtype: str | None = None,
    uvw_compute=None,
    **clean_kwargs,
):
    """Streamed ICAL over a native visibility store, on the model image's
    device (``model.pixels.device``).

    :param store: :class:`io.VisStore` or a path to one
    :param model: image template: ``nchan == 1`` for MFS imaging of the
        store's channels, ``nchan == store.nchan`` for a spectral cube;
        ``npol`` must match the store
    :param phasecentre: (ra, dec) rad of the store's phase centre
    :param chunk_times: time rows per slab (device memory follows it);
        gain solution intervals are slab-local
    :param calibration_context: Jones chain, e.g. "T", "TG", "TB", each
        letter solved in turn per slab with the others applied, per
        channel for "B"
    :param components: optional SkyComponents predicted in-stream by the
        DFT and calibrated against together with the image model (CLEAN
        updates the image only)
    :param polarisation_frame: the store's visibility frame (default by
        npol: stokesI / linearnp / linear)
    :param wire_dtype: "f16" ships the observed visibilities and weights
        to the card as float16 with a per-slab scale guard, dequantised on
        the card (~5e-4 relative); None ships f32
    :param uvw_compute: optional callable ``times -> uvw [nt, nbl, 3]``
        computing a slab's uvw on the card from its times, given as an
        f64 tensor on the card (absolute epochs keep their resolution),
        in place of uploading the store's uvw
    :param cache_slabs: keep each slab's uploaded visibilities, weights
        and uvw on the card across cycles (~36 B/vis); None caches when
        the estimate fits ``slab_cache_bytes``
    :param distribute: shard slabs across the processes of the
        ``torch.distributed`` group (``parallel.multihost.initialize``):
        process r streams slabs k with k % W == r from its own store
        handle, and once a cycle the accumulated grids and sums of weights
        (at the end the gain tables) go through the process-ordered sum of
        ``parallel.collectives``, so every process holds the same result.
        In a group (of any size, one process too) the grids accumulate in
        f64, so that the result does not depend on the number of
        processes; outside a group, in f32
    :param on_cycle: ``on_cycle(cycle, seconds)`` after each cycle's
        model update has reached the host
    :param model_init: warm-start model image: a previous run's returned
        model continues the major-cycle iteration
    :return: (model, residual, restored, gaintable); ``gaintable``
        concatenates every slab's solution intervals per term, a dict
        ``{term: GainTable}`` for multi-term chains
    """
    with contextlib.ExitStack() as stack:
        if isinstance(store, (str, bytes)):
            store = stack.enter_context(VisStore(os.fsdecode(store)))
        device = model.pixels.device
        npol, nchan, nbl = store.npol, store.nchan, store.nbl
        if npol not in (1, 2, 4):
            raise ValueError(f"streamed_ical: npol {npol} not in (1,2,4)")
        if model.npol != npol:
            raise ValueError(
                f"model npol {model.npol} != store npol {npol}; convert the "
                "model to the store's frame first"
            )
        if model.nchan not in (1, nchan):
            raise ValueError(
                f"model nchan {model.nchan} must be 1 (MFS) or the store's "
                f"nchan {nchan} (cube)"
            )
        nchan_img = model.nchan
        mfs = nchan_img == 1 and nchan > 1
        frame = polarisation_frame or _POL_FRAME_OF_NPOL[npol]
        if controls is None:
            controls = create_calibration_controls()
        terms = list(calibration_context)
        steps = [
            (t0, min(chunk_times, store.ntime - t0))
            for t0 in range(0, store.ntime, chunk_times)
        ]
        nslab = len(steps)
        nants = int(max(store.antenna1.max(), store.antenna2.max())) + 1
        # one shard a process; None: this process streams every slab
        mesh = _process_mesh(device) if distribute else None
        nproc, pid = (1, 0) if mesh is None else (mesh.nshards, mesh.local[0])
        if nslab < nproc:
            raise ValueError(
                f"streamed_ical: {nslab} time slabs cannot shard across "
                f"{nproc} processes; reduce chunk_times"
            )
        my_slabs = [k for k in range(nslab) if k % nproc == pid]

        # the global w range and plane count: every slab's grids must stack
        # onto the same planes to accumulate
        w_range = _w_range(store)

        if cache_slabs is None:
            est_bytes = nslab * chunk_times * nbl * nchan * npol * 36
            cache_slabs = est_bytes <= slab_cache_bytes
        uvw_cache: dict = {}
        data_cache: dict = {}

        whole = _store_visibility(store, phasecentre, frame, nants, device)

        def template(k, uvw=None):
            return _slab_of(whole, *steps[k], uvw)

        def slab_visibility(k):
            uvw = uvw_cache.get(k)
            if uvw is None:
                t0, nt = steps[k]
                if uvw_compute is not None:
                    # nt times up the wire in place of nt * nbl * 3 coordinates
                    uvw = uvw_compute(whole.time[t0 : t0 + nt])
                else:
                    uvw = torch.from_numpy(np.asarray(store.uvw[t0 : t0 + nt], np.float32))
                uvw = uvw.to(device=device, dtype=torch.float32)
                if cache_slabs:
                    uvw_cache[k] = uvw
            return template(k, uvw)

        # per slab and term: the unit gaintable and the interval maps
        gt0s, cals, term_cfgs = [], [], []
        for k in range(nslab):
            cv = template(k)
            gts, cal = [], []
            for name in terms:
                gt0 = create_gaintable_from_visibility(
                    cv, jones_type=name, timeslice=controls[name]["timeslice"]
                )
                row_idx, has_row = _gain_row_of_time(cv.time, gt0.time, gt0.interval)
                gts.append(gt0)
                cal.append({
                    "w_t": _interval_weights(cv.time, gt0.time, gt0.interval, torch.float32),
                    "row_idx": row_idx,
                    "has_row": has_row,
                })
                if k == 0:
                    crosspol = controls[name].get("shape") == "matrix"
                    if crosspol and npol != 4:
                        raise ValueError(
                            f"streamed_ical: full-Jones term {name!r} needs npol=4 "
                            f"data (store has {npol})"
                        )
                    term_cfgs.append(_FusedTermCfg(
                        name=name,
                        phase_only=bool(controls[name]["phase_only"]),
                        first_selfcal=int(controls[name].get("first_selfcal", 0) or 0),
                        per_chan=gt0.gain.shape[2] > 1,
                        crosspol=crosspol,
                    ))
            gt0s.append(gts)
            cals.append(cal)
        a1 = torch.as_tensor(store.antenna1, device=device).long()
        a2 = torch.as_tensor(store.antenna2, device=device).long()
        ne_idx = torch.as_tensor(
            ne_index_map(store.antenna1, store.antenna2, nants), device=device
        ).long()
        do_wstacking = context != "2d"
        nwp = _nw_for(
            template(0), model, do_wstacking, nw,
            wmax=max(abs(w_range[0]), abs(w_range[1])),
        )
        cfg = _FusedCfg(
            nchan=nchan,
            npol=npol,
            terms=tuple(term_cfgs),
            normalise_gains=normalise_gains,
            solver_niter=solver_niter,
            solver_tol=tol,
            algorithm=clean_kwargs.get("algorithm", "hogbom"),
            clean_gain=clean_kwargs.get("gain", 0.1),
            clean_niter=clean_kwargs.get("niter", 100),
            clean_thresh=clean_kwargs.get("threshold", 0.0),
            clean_frac=clean_kwargs.get("fractional_threshold", 0.01),
            scales=tuple(clean_kwargs.get("scales", (0, 3, 10, 30))),
            findpeak=clean_kwargs.get("findpeak", "RASCIL"),
        )

        def build_plan(cv):
            return make_visibility_plan(
                cv, model, context=context, support=support, nw=nwp, w_range=w_range
            )

        # in-stream components: the direction cosines and the (channel,
        # polarisation) fluxes hold for every slab; only uvw varies
        comp_static = None
        if components is not None and components.ncomp > 0:
            comp_static = extract_direction_and_flux(components, template(0))

        def stream_slabs():
            """(k, observed visibilities, flagged weights) per slab on the
            card, with the reader thread prefetching the next slab; with
            ``cache_slabs`` the card's copies serve the later passes."""
            if cache_slabs and len(data_cache) == len(my_slabs):
                for k in my_slabs:
                    yield (k, *data_cache[k])
                return
            store.prefetch(*steps[my_slabs[0]])
            t_pass = _time.time()
            for i, k in enumerate(my_slabs):
                re, im, wt, fl = store.wait(steps[k][1])
                if i + 1 < len(my_slabs):
                    store.prefetch(*steps[my_slabs[i + 1]])
                if i % 16 == 0 and log.isEnabledFor(logging.INFO):
                    log.info(
                        "streamed_ical: slab %d/%d (%.0fs into pass)",
                        i + 1, len(my_slabs), _time.time() - t_pass,
                    )
                obs = torch.view_as_complex(
                    _upload(np.stack([re, im], axis=-1), wire_dtype, device)
                )
                item = (obs, _upload(wt * (1 - fl), wire_dtype, device))
                if cache_slabs:
                    data_cache[k] = item
                yield (k, *item)

        def slab(k, obs, fw):
            return _Slab(obs, fw, cals[k], a1, a2, ne_idx, mfs)

        # in a process group the slabs' grids and sums of weights add in
        # f64: W processes add them in another order than one, and in f64
        # that order leaves the f32 image as it is; outside a group they
        # add in f32, slab after slab
        acc_dtype, swt_dtype = (
            (torch.complex64, torch.float32) if mesh is None else (torch.complex128, torch.float64)
        )

        def accumulate(acc, grids):
            if acc is None:
                return [[g.to(acc_dtype) for g in row] for row in grids]
            for c in range(nchan_img):
                for p in range(npol):
                    acc[c][p] += grids[c][p]
            return acc

        # the PSF pass (once): unit visibilities at the flagged weights,
        # every polarisation; the sums of weights serve every cycle
        acc, swt, tails = None, None, None
        for k, obs, fw in stream_slabs():
            plan = build_plan(slab_visibility(k))
            if tails is None:
                # the image-side arrays only (the w planes are global, so every
                # slab's are the same); the first slab's entries are not held
                tails = [dataclasses.replace(ip, gp=None) for ip in plan.plans]
            s = slab(k, obs, fw)
            acc = accumulate(acc, s.grid(plan, s.to_plan(plan, fw)))
            swt = s.sumwt().to(swt_dtype) if swt is None else swt + s.sumwt()
            del plan, s
        acc, swt = _psum_grids(mesh, acc, swt)

        ny = nx = model.npixel

        def grids_to_cube(acc, swt):
            cube = torch.zeros((nchan_img, npol, ny, nx), dtype=torch.float32, device=device)
            for c in range(nchan_img):
                for p in range(npol):
                    d = uv_grids_to_dirty(tails[c], acc[c][p].to(torch.complex64))
                    cube[c, p] = (d / torch.clamp(swt[c, p], min=1e-30)).to(torch.float32)
            return cube

        psf = model.replace(pixels=grids_to_cube(acc, swt))
        del acc

        gains = [[gt.gain for gt in gts] for gts in gt0s]
        gwts = [[gt.weight for gt in gts] for gts in gt0s]
        gress = [[gt.residual for gt in gts] for gts in gt0s]
        if model_init is not None:
            model_px = (
                torch.as_tensor(model_init.pixels)
                .to(device=device, dtype=torch.float32)
                .reshape(nchan_img, npol, ny, nx)
            )
        else:
            model_px = torch.zeros((nchan_img, npol, ny, nx), dtype=torch.float32, device=device)
        residual = None
        ck = dict(clean_kwargs)
        ck.setdefault("algorithm", "hogbom")

        for cycle in range(nmajor):
            t_cycle = _time.time()
            do_cal = tuple(cycle >= max(first_selfcal, t.first_selfcal) for t in term_cfgs)
            # the model is zero until a CLEAN (or the warm start) has added to it
            with_model = cycle > 0 or model_init is not None
            acc = None
            for k, obs, fw in stream_slabs():
                cv = slab_visibility(k)
                plan = build_plan(cv)
                s = slab(k, obs, fw)
                mvis = torch.zeros_like(obs)
                if with_model:
                    model_s = [
                        predict_with_stack(plan, model_px[:, p], to_sorted=True)
                        for p in range(npol)
                    ]
                    nat = _as_list(permute_apply(plan.stack.iperm, *model_s))
                    mvis = torch.stack([s.natural(m, *obs.shape[:2]) for m in nat], dim=-1)
                if comp_static is not None:
                    mvis = mvis + dft_kernel(*comp_static, cv.uvw_lambda).to(mvis.dtype)
                gains[k], gwts[k], gress[k], inv_tot = _solve_terms(
                    s, cfg, gains[k], gwts[k], gress[k], do_cal, mvis
                )
                corrected = obs
                if inv_tot is not None and inv_tot.ndim == 5:
                    # a full-Jones term: the Mueller correction mixes the
                    # polarisation columns
                    corrected = _mueller_apply(inv_tot, obs)
                elif inv_tot is not None:
                    corrected = obs * inv_tot
                resid = (corrected - mvis) * fw
                del mvis, corrected, inv_tot
                acc = accumulate(acc, s.grid(plan, s.to_plan(plan, resid)))
                del plan, s, resid
            acc, _ = _psum_grids(mesh, acc, None)
            residual = model.replace(pixels=grids_to_cube(acc, swt))
            del acc
            comp_img, _ = deconvolve_cube(residual, psf, **ck)
            model_px = model_px + comp_img.pixels.to(torch.float32)
            if on_cycle is not None:
                # a fetch, so the cycle's work has finished on the card
                model_px[0, 0, :1, :1].cpu()
                on_cycle(cycle, _time.time() - t_cycle)
            if log.isEnabledFor(logging.INFO):
                log.info(
                    "streamed_ical: cycle %d peak residual %.6f",
                    cycle, float(residual.pixels.abs().max()),
                )

        current = model.replace(pixels=model_px.to(model.pixels.dtype))
        restored = restore_cube(current, psf=psf, residual=residual, clean_beam=fit_psf(psf))
        if mesh is not None:
            # each slab's solutions from the process that streamed it: the
            # others hold zeros, and one ordered sum gives every process all
            tables = [gains, gwts, gress]
            for tab in tables:
                for k in range(nslab):
                    if k % nproc != pid:
                        tab[k] = [torch.zeros_like(x) for x in tab[k]]
            flat = psum(mesh, [tuple(x for tab in tables for k in range(nslab) for x in tab[k])])
            it = iter(flat)
            for tab in tables:
                for k in range(nslab):
                    tab[k] = [next(it) for _ in tab[k]]
        # each term's slab tables merged (disjoint, time-ordered intervals)
        gaintables = {}
        for it, name in enumerate(terms):
            gaintables[name] = GainTable(
                gain=torch.cat([gains[k][it] for k in range(nslab)]),
                weight=torch.cat([gwts[k][it] for k in range(nslab)]),
                residual=torch.cat([gress[k][it] for k in range(nslab)]),
                time=torch.cat([gt0s[k][it].time for k in range(nslab)]),
                interval=torch.cat([gt0s[k][it].interval for k in range(nslab)]),
                frequency=gt0s[0][it].frequency,
                jones_type=name,
                receptor_frame=gt0s[0][it].receptor_frame,
            )
        gaintable = gaintables[terms[0]] if len(terms) == 1 else gaintables
        return StreamedICALResult((current, residual, restored, gaintable))
