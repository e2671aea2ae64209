"""The fused self-calibration and continuum-imaging major cycles.

Counterpart of the fused path of ``ska_sdp_func_python_tpu/pipeline.py``:
``ical`` and ``continuum_imaging`` build one imaging plan per image
channel, take the PSF through them, build a plan-sorted workspace and run
:func:`_fused_selfcal_cycle` once per major cycle. One cycle, for every
image channel in turn:

1. degrids the model image in that channel's plan order (kernel K3);
2. moves the model into natural order (kernel K4, inverse);
3. (all channels together) forms the product-form normal equations and
   runs the StefCal solve; ``continuum_imaging`` leaves this out;
4. moves the inverse gain factors into plan order (kernel K4, forward);
5. inverts the residual in plan order (kernels K1+K2, FFT tail);
6. CLEANs the residual cube: msclean (kernel K7, the default) or Hogbom
   (K5) per (channel, polarisation) plane, or MSMFS (``algorithm=
   "mmclean"``, kernel K8) on the cube's frequency moments, with an
   optional clean window.

The port covers stokesI, one or more image channels (one per visibility
channel), a single "T" (phase-only, scalar) term, and no sky components.
Every other branch raises and names the ROADMAP slice that brings it.
"""

from __future__ import annotations

import logging
import typing
from typing import Optional

import torch

from .config import not_ported
from .models.gaintable import create_gaintable_from_visibility
from .models.image import Image
from .models.polarisation import convert_pol_frame
from .models.visibility import Visibility
from .ops.calibration_chain import create_calibration_controls
from .ops.cleaners import (
    hogbom_lanes,
    msclean_psf_stacks,
    msclean_with_stacks,
    msmfs_psf_stacks,
    msmfs_with_stacks,
)
from .ops.deconvolution import (
    _lane_psfs,
    bound_psf,
    common_arguments,
    find_window,
    fit_psf,
    restore_cube,
)
from .ops.gain_ops import _gain_row_of_time
from .ops.imaging import (
    invert_visibility,
    invert_with_plan,
    make_visibility_plan,
    predict_with_plan,
    shift_vis_to_image,
)
from .ops.permute import permute_apply
from .ops.solvers import ne_index_map, solve_gains_core
from .ops.taylor import moment_weights

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["ical", "continuum_imaging"]

_MMCLEAN = ("msmfsclean", "mfsmsclean", "mmclean")


class _SortedWorkspace:
    """Image-frame, plan-sorted visibility workspace: the observed values
    and weights of every (channel, polarisation) are moved into that
    channel plan's order once, so a major cycle never sorts them again."""

    def __init__(self, vis, model, plan, components=None):
        if components is not None and components.ncomp > 0:
            raise not_ported("sky components in the fused cycle", "S7x")
        if plan.nchan != vis.nchan:
            raise ValueError(
                f"the fused cycle images every visibility channel: {vis.nchan} "
                f"channels, {plan.nchan} image channels"
            )
        svis = shift_vis_to_image(vis, model)
        ms = convert_pol_frame(
            svis.flagged_vis, vis.polarisation_frame, model.polarisation_frame
        )
        wgt = svis.flagged_imaging_weight
        self.plan = plan
        self.npol = ms.shape[-1]
        # natural-order arrays for the solver leg (V_obs / V_model is
        # invariant under the phase shift, so gains solve in the image frame)
        self.ms_nat = ms
        self.fw_nat = svis.flagged_weight
        # obs_s[chan][pol], wgt_s[chan][pol]: each stream's values and
        # weights move in one launch, by its channel plan's permutation
        self.obs_s, self.wgt_s = [], []
        for c, cplan in enumerate(plan.plans):
            moved = [
                permute_apply(
                    cplan.gp.perm,
                    ms[:, :, c, p].reshape(-1).to(torch.complex64).contiguous(),
                    wgt[:, :, c, p].reshape(-1).to(torch.float32).contiguous(),
                )
                for p in range(self.npol)
            ]
            self.obs_s.append([m[0] for m in moved])
            self.wgt_s.append([m[1] for m in moved])


class _FusedTermCfg(typing.NamedTuple):
    name: str
    phase_only: bool
    first_selfcal: int


class _FusedCfg(typing.NamedTuple):
    nchan: int
    npol: int
    terms: tuple
    normalise_gains: str | None
    solver_niter: int
    solver_tol: float
    algorithm: str
    clean_gain: float
    clean_niter: int
    clean_thresh: float
    clean_frac: float
    scales: tuple
    findpeak: str


class _FusedSelfCal(_SortedWorkspace):
    """Device-resident workspace of :func:`_fused_selfcal_cycle` for the
    ported configuration: one "T" term, stokesI, one or more channels,
    msclean, Hogbom or MSMFS with an optional clean window. What CLEAN
    derives from the PSF alone (the msclean scale stacks per plane; the
    MSMFS moment weights, moment-PSF peak and moment stacks) is built here
    once, not in every cycle."""

    def __init__(
        self,
        vis,
        model,
        plan,
        components,
        terms,
        controls,
        normalise_gains,
        solver_niter: int,
        solver_tol: float,
        psf: Image,
        **clean_kwargs,
    ):
        super().__init__(vis, model, plan, components)
        if list(terms) != ["T"]:
            raise not_ported(f"calibration terms {terms!r} (only 'T')", "S7x")
        if controls["T"].get("shape") != "scalar":
            raise not_ported("non-scalar 'T' controls", "S7x")
        algorithm = clean_kwargs.get("algorithm", "msclean")
        _check_algorithm(model, clean_kwargs)
        win = find_window(
            model,
            clean_kwargs.get("window_shape"),
            **{k: clean_kwargs[k] for k in ("mask", "window_edge") if k in clean_kwargs},
        )
        self.clean_window = (
            None
            if win is None
            else torch.broadcast_to(win.to(torch.float32), model.pixels.shape)
        )
        device = vis.device
        self.gt0s, self.cal = [], []
        gt0 = create_gaintable_from_visibility(
            vis, jones_type="T", timeslice=controls["T"]["timeslice"]
        )
        t = vis.time[None, :]
        lo = (gt0.time - gt0.interval / 2)[:, None]
        hi = (gt0.time + gt0.interval / 2)[:, None]
        row_idx, has_row = _gain_row_of_time(vis.time, gt0.time, gt0.interval)
        self.gt0s.append(gt0)
        self.cal.append(
            {
                "w_t": ((t >= lo) & (t <= hi)).to(vis.weight.dtype),
                "row_idx": row_idx,
                "has_row": has_row,
            }
        )
        self.a1 = vis.antenna1.long()
        self.a2 = vis.antenna2.long()
        self.ne_idx = torch.as_tensor(
            ne_index_map(
                vis.antenna1.cpu().numpy(), vis.antenna2.cpu().numpy(), vis.nants
            ),
            device=device,
        ).long()
        bpsf = bound_psf(psf, psf, clean_kwargs.get("psf_support", None))
        self.psf_patch = bpsf.pixels.to(torch.float32)
        frac, cgain, cniter, cthresh, scales = common_arguments(**clean_kwargs)
        ny, nx = model.pixels.shape[-2:]
        self.ms_stacks = (
            [
                [msclean_psf_stacks(pp, ny, nx, scales) for pp in pc]
                for pc in self.psf_patch
            ]
            if algorithm == "msclean"
            else None
        )
        self.mom_w = self.psf_peak = self.mm_stacks = None
        if algorithm in _MMCLEAN:
            # mmclean's default loop gain is 0.7, as in deconvolve_cube
            cgain = clean_kwargs.get("gain", 0.7)
            nmoment = clean_kwargs.get("nmoment", 3)
            nm_psf = 2 * nmoment if nmoment > 1 else 1
            self.mom_w = tuple(
                moment_weights(model.frequency, None, k).to(
                    device=device, dtype=torch.float32
                )
                for k in (nmoment, nm_psf)
            )
            psf_t = torch.einsum("cm,cpyx->mpyx", self.mom_w[1], self.psf_patch)
            self.psf_peak = psf_t.max()
            self.mm_stacks = msmfs_psf_stacks(
                psf_t[:, 0] / self.psf_peak, ny, nx, scales
            )
        self.cfg = _FusedCfg(
            nchan=plan.nchan,
            npol=self.npol,
            terms=(
                _FusedTermCfg(
                    name="T",
                    phase_only=controls["T"]["phase_only"],
                    first_selfcal=controls["T"]["first_selfcal"],
                ),
            ),
            normalise_gains=normalise_gains,
            solver_niter=solver_niter,
            solver_tol=solver_tol,
            algorithm=algorithm,
            clean_gain=cgain,
            clean_niter=cniter,
            clean_thresh=cthresh,
            clean_frac=frac,
            scales=tuple(scales),
            findpeak=clean_kwargs.get("findpeak", "RASCIL"),
        )

    def gaintables(self, gains, gwts, gress) -> dict:
        return {
            t.name: gt0.replace(gain=g, weight=w, residual=r)
            for t, gt0, g, w, r in zip(
                self.cfg.terms, self.gt0s, gains, gwts, gress
            )
        }


def _solve_terms(ws: _FusedSelfCal, cfg: _FusedCfg, gains, mvis):
    """The diagonal lane of the term solves for the one scalar term:
    product-form normal equations ``x*w = V conj(V_model) w``,
    ``xwt = |V_model|^2 w`` from the natural-order visibilities, the
    batched StefCal solve, and the per-(time, baseline, pol) inverse
    factors V' = V / (g1 conj(g2)). Returns (gains, gain weights,
    residuals, inverse factors [ntime, nbl, 1, npol])."""
    term = cfg.terms[0]
    npol = cfg.npol
    cal = ws.cal[0]
    fw, corrected = ws.fw_nat, ws.ms_nat
    xe = corrected * mvis.conj() * fw
    we = (mvis.real**2 + mvis.imag**2) * fw
    w_t = cal["w_t"]
    xb = torch.einsum("st,tbfp->sbp", w_t.to(xe.dtype), xe)[:, :, None, :]
    wb = torch.einsum("st,tbfp->sbp", w_t.to(we.dtype), we)[:, :, None, :]
    nsol = w_t.shape[0]
    nants = gains[0].shape[1]
    # antenna-pair assembly as one gather per array (ne_index_map)
    ext = torch.cat([xb.conj(), xb, torch.zeros_like(xb[:, :1])], dim=1)
    x = ext[:, ws.ne_idx].reshape(nsol, nants, nants, 1, npol)
    extw = torch.cat([wb, wb, torch.zeros_like(wb[:, :1])], dim=1)
    xwt = extw[:, ws.ne_idx].reshape(nsol, nants, nants, 1, npol)
    has_data = torch.sum(xwt.abs(), dim=(1, 2, 3, 4)) > 0.0

    gain_new, gwt, gres = solve_gains_core(
        x,
        xwt,
        gains[0],
        niter=cfg.solver_niter,
        tol=cfg.solver_tol,
        phase_only=term.phase_only,
        npol=npol,
    )
    hd = has_data[:, None, None, None, None]
    gain_new = torch.where(hd, gain_new, torch.ones_like(gain_new))
    gwt = torch.where(hd, gwt, torch.zeros_like(gwt))
    gres = torch.where(has_data[:, None, None, None], gres, 0.0)
    if cfg.normalise_gains in ("mean", "median") and not term.phase_only:
        gabs = (
            gain_new.abs().mean()
            if cfg.normalise_gains == "mean"
            else gain_new.abs().median()
        )
        gain_new = gain_new / gabs

    gg = gain_new[cal["row_idx"]]  # [ntime, nants, 1, 1, 1]
    hr = cal["has_row"][:, None, None]
    g1 = gg[:, ws.a1, :, 0, 0]
    g2 = gg[:, ws.a2, :, 0, 0]
    sm = g1 * g2.conj()  # [ntime, nbl, 1]
    m2 = sm.real**2 + sm.imag**2
    ok = m2 > 0.0
    inv_p = torch.where(ok, sm.conj() / torch.where(ok, m2, 1.0), 0.0)
    # rows outside every solution interval stay uncorrected
    inv = torch.where(hr, inv_p, torch.ones_like(inv_p))
    return [gain_new], [gwt], [gres], inv[..., None]


def _fused_clean(residual, ws: _FusedSelfCal, cfg: _FusedCfg):
    """The CLEAN lane of the cycle; returns the component cube.

    Hogbom: every (chan, pol) plane cleans independently in one batch;
    lanes with an empty PSF get a unit delta and their components are
    dropped. msclean: each plane in turn, with the workspace's scale
    stacks. Both search within the clean window when there is one.

    MSMFS: the residual cube becomes ``nmoment`` moment images over the
    peak of the moment PSFs; each polarisation is cleaned with the
    workspace's moment stacks, searching within the clean window of
    channel 0 (windows do not depend on frequency); the moment model goes
    back onto the channels as it is (with unit-peak channel PSFs the
    normalised moment components are in per-channel flux units)."""
    nchan, npol, ny, nx = residual.shape
    window = ws.clean_window
    clean = dict(
        gain=cfg.clean_gain,
        thresh=cfg.clean_thresh,
        niter=cfg.clean_niter,
        fracthresh=cfg.clean_frac,
    )
    if cfg.algorithm in _MMCLEAN:
        w_m = ws.mom_w[0]
        dpix = torch.einsum("cm,cpyx->mpyx", w_m, residual) / ws.psf_peak
        comp_t = torch.zeros_like(dpix)
        for p in range(npol):
            comp_t[:, p], _ = msmfs_with_stacks(
                ws.mm_stacks,
                dpix[:, p],
                None if window is None else window[0, p],
                findpeak=cfg.findpeak,
                **clean,
            )
        return torch.einsum("cm,mpyx->cpyx", w_m, comp_t)
    if cfg.algorithm == "msclean":
        comp = torch.zeros_like(residual)
        for c in range(nchan):
            for p in range(npol):
                comp[c, p], _ = msclean_with_stacks(
                    ws.ms_stacks[c][p],
                    residual[c, p],
                    None if window is None else window[c, p],
                    **clean,
                )
        return comp
    d2 = residual.reshape(-1, ny, nx).contiguous()
    p2 = ws.psf_patch.reshape(-1, *ws.psf_patch.shape[-2:])
    p2_safe, ok = _lane_psfs(p2)
    cb, _ = hogbom_lanes(
        d2,
        p2_safe,
        None if window is None else window.reshape(-1, ny, nx),
        **clean,
    )
    cb = torch.where(ok[:, None, None], cb, 0.0)
    return cb.reshape(residual.shape)


def _fused_selfcal_cycle(
    ws: _FusedSelfCal,
    model_pixels: torch.Tensor,
    gains,
    gwts,
    gress,
    *,
    do_cal: tuple,
    with_model: bool,
):
    """One self-cal major cycle in the plan-sorted domain: model degrid,
    back-permute, normal equations and StefCal solve, factor permute,
    residual invert, CLEAN. Returns (model_pixels, gains, gwts, gress,
    residual, sumwt, peak).

    It serves one image channel (the JAX package's
    ``_fused_selfcal_cycle``) and a cube (``_fused_selfcal_cycle_cube``)
    alike: each channel's legs run on that channel's plan in turn, the
    solve takes the model visibilities of all channels as ``[time,
    baseline, chan, pol]``, and the "T" factors, one per (time, baseline),
    serve every channel."""
    cfg = ws.cfg
    plans = ws.plan.plans
    nchan, npol = cfg.nchan, cfg.npol
    model_s = [
        [
            predict_with_plan(plans[c], model_pixels[c, p], to_sorted=True)
            if with_model
            else ws.obs_s[c][p] * 0.0
            for p in range(npol)
        ]
        for c in range(nchan)
    ]

    any_cal = any(do_cal)
    if any_cal:
        ntime, nbl = ws.cal[0]["w_t"].shape[1], ws.a1.shape[0]
        chans = [
            torch.stack(
                [
                    permute_apply(
                        plans[c].gp.perm, model_s[c][p], inverse=True
                    ).reshape(ntime, nbl)
                    for p in range(npol)
                ],
                dim=-1,
            )
            for c in range(nchan)
        ]
        mvis = torch.stack(chans, dim=2)  # [t, b, nchan, npol]
        gains, gwts, gress, inv_tot = _solve_terms(ws, cfg, gains, mvis)

    ny = nx = plans[0].npixel
    device = model_pixels.device
    pixels = torch.zeros((nchan, npol, ny, nx), dtype=torch.float32, device=device)
    sumwt = torch.zeros((nchan, npol), dtype=torch.float32, device=device)
    for c in range(nchan):
        perm = plans[c].gp.perm
        for p in range(npol):
            if any_cal:
                f_p = inv_tot[:, :, 0, p].reshape(-1)
                corr = ws.obs_s[c][p] * permute_apply(perm, f_p.contiguous())
            else:
                corr = ws.obs_s[c][p]
            resid_s = corr - model_s[c][p]
            dirty, swt = invert_with_plan(
                plans[c], resid_s, ws.wgt_s[c][p], values_sorted=True
            )
            pixels[c, p] = dirty.to(torch.float32)
            sumwt[c, p] = swt
    okw = sumwt > 0.0
    scale = torch.where(okw, 1.0 / torch.where(okw, sumwt, 1.0), 0.0)
    residual = pixels * scale[:, :, None, None]

    comp_pixels = _fused_clean(residual, ws, cfg)
    model_pixels = model_pixels + comp_pixels
    peak = residual.abs().max()
    return model_pixels, gains, gwts, gress, residual, sumwt, peak


def ical(
    vis: Visibility,
    model: Image,
    components=None,
    nmajor: int = 5,
    calibration_context: str = "T",
    controls: Optional[dict] = None,
    context: str = "ng",
    checkpoint_path: Optional[str] = None,
    state=None,
    **kwargs,
):
    """ICAL: iterative calibration + imaging self-cal loop, fused path, on
    one image channel or a cube (one image channel per visibility
    channel). ``algorithm`` is "msclean" (the default), "hogbom" or
    "mmclean" (MSMFS, which needs ``nchan > 2 (nmoment - 1)``).

    :return: (model Image, residual Image, restored Image, gaintables dict)
    """
    if controls is None:
        controls = create_calibration_controls()
    if checkpoint_path is not None or state is not None:
        raise not_ported("ical checkpoints (SelfCalState)", "S7x")
    plan, psf = _plan_and_psf("ical", vis, model, context, kwargs)
    return _ical_fused(
        vis, model, components, nmajor, calibration_context, controls,
        plan, psf, **kwargs,
    )


def _ical_fused(
    vis,
    model,
    components,
    nmajor,
    terms: str,
    controls,
    plan,
    psf,
    solver_niter: int = 200,
    tol: float = 1e-6,
    **kwargs,
):
    """Fused-cycle ICAL driver: one :func:`_fused_selfcal_cycle` per major
    cycle, with a host fetch of the peak residual only for logging."""
    ws = _FusedSelfCal(
        vis, model, plan, components, list(terms), controls, "mean",
        solver_niter, tol, psf, **kwargs,
    )
    gains = [gt.gain for gt in ws.gt0s]
    gwts = [gt.weight for gt in ws.gt0s]
    gress = [gt.residual for gt in ws.gt0s]
    model_px = torch.zeros_like(model.pixels, dtype=torch.float32)
    res_px = None
    log.info("ical[fused]: workspace ready, %d visibilities", vis.nvis)
    for cycle in range(nmajor):
        do_cal = tuple(cycle >= t.first_selfcal for t in ws.cfg.terms)
        model_px, gains, gwts, gress, res_px, _, peak = _fused_selfcal_cycle(
            ws, model_px, gains, gwts, gress,
            do_cal=do_cal, with_model=cycle > 0,
        )
        if log.isEnabledFor(logging.INFO):
            log.info("ical[fused]: cycle %d peak residual %.6f", cycle, float(peak))
    current = model.replace(pixels=model_px.to(model.pixels.dtype))
    residual = model.replace(pixels=res_px) if res_px is not None else None
    gaintables = ws.gaintables(gains, gwts, gress)
    restored = _restore_with_components(current, psf, residual, components)
    return current, residual, restored, gaintables


def continuum_imaging(
    vis: Visibility,
    model: Image,
    nmajor: int = 5,
    context: str = "ng",
    components=None,
    **kwargs,
):
    """Major/minor-cycle CLEAN imaging without self-calibration, fused
    path: :func:`_fused_selfcal_cycle` with the calibration leg left out,
    on one image channel or a cube. ``algorithm`` as for :func:`ical`;
    "mmclean" on a cube is MSMFS continuum imaging.

    :return: (model Image, residual Image, restored Image)
    """
    plan, psf = _plan_and_psf("continuum_imaging", vis, model, context, kwargs)
    ws = _FusedSelfCal(
        vis, model, plan, components, ["T"], create_calibration_controls(),
        None, 1, 1e-6, psf, **kwargs,
    )
    gains = [ws.gt0s[0].gain]
    gwts = [ws.gt0s[0].weight]
    gress = [ws.gt0s[0].residual]
    model_px = torch.zeros_like(model.pixels, dtype=torch.float32)
    res_px = None
    log.info("continuum_imaging[fused]: workspace ready, %d visibilities", vis.nvis)
    for cycle in range(nmajor):
        model_px, _, _, _, res_px, _, peak = _fused_selfcal_cycle(
            ws, model_px, gains, gwts, gress, do_cal=(False,), with_model=cycle > 0
        )
        if log.isEnabledFor(logging.INFO):
            log.info(
                "continuum_imaging[fused]: cycle %d peak residual %.6f",
                cycle, float(peak),
            )
    current = model.replace(pixels=model_px.to(model.pixels.dtype))
    residual = model.replace(pixels=res_px) if res_px is not None else None
    restored = _restore_with_components(current, psf, residual, components)
    return current, residual, restored


def _check_algorithm(model: Image, kwargs: dict) -> None:
    """The fused cycle's CLEAN algorithms: msclean, Hogbom, and MSMFS,
    which needs more image channels than its moments' polynomial order
    (``nchan > 2 (nmoment - 1)``, as in ``deconvolve_cube``)."""
    algorithm = kwargs.get("algorithm", "msclean")
    if algorithm in _MMCLEAN:
        nmoment = kwargs.get("nmoment", 3)
        if not model.nchan > 2 * (nmoment - 1):
            raise ValueError(
                f"{algorithm} requires nchan > 2*(nmoment-1) "
                f"({model.nchan} > {2 * (nmoment - 1)})"
            )
    elif algorithm not in ("hogbom", "msclean"):
        raise ValueError(f"fused clean: unsupported algorithm {algorithm}")


def _plan_and_psf(name: str, vis, model, context: str, kwargs: dict):
    """What ``ical`` and ``continuum_imaging`` share before their cycles:
    the checks of the ported configuration (the workspace checks the
    CLEAN algorithm), one plan per image channel and the PSF through
    them. Takes the imaging keywords out of
    ``kwargs``. Returns (plan, psf)."""
    if kwargs.pop("fused", True) is False:
        raise not_ported(f"the composed (fused=False) {name} path", "S7x")
    if kwargs.pop("use_plan", True) is False:
        # without a plan the JAX package runs the composed path
        raise not_ported(f"the composed (use_plan=False) {name} path", "S7x")
    if kwargs.get("epsilon") is not None:
        # the JAX pipelines do not pass epsilon to their plan
        raise not_ported(f"{name}(epsilon=...)", "S7x")
    if vis.npol != 1 or model.npol != 1:
        raise not_ported(f"polarised {name} (npol > 1)", "S7x")
    ikw = {k: kwargs.pop(k) for k in ("support", "nw", "do_wstacking") if k in kwargs}
    plan = make_visibility_plan(vis, model, context=context, **ikw)
    psf, _ = invert_visibility(
        vis, model, dopsf=True, context=context, plan=plan, **ikw
    )
    return plan, psf


def _restore_with_components(current, psf, residual, components):
    """Restore the model with the fitted clean beam and add the residual
    (sky components are not ported yet)."""
    if components is not None and components.ncomp > 0:
        raise not_ported("restoring sky components", "S7x")
    clean_beam = fit_psf(psf)
    return restore_cube(
        current, psf=psf, residual=residual, clean_beam=clean_beam
    )
