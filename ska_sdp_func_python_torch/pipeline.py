"""The fused ICAL self-calibration major cycle.

Counterpart of the fused path of ``ska_sdp_func_python_tpu/pipeline.py``:
``ical`` builds one imaging plan, takes the PSF through it, builds a
plan-sorted workspace and runs :func:`_fused_selfcal_cycle` once per major
cycle. One cycle:

1. degrids the model image in plan order (kernel K3);
2. moves the model into natural order (kernel K4, inverse);
3. forms the product-form normal equations and runs the StefCal solve;
4. moves the inverse gain factors into plan order (kernel K4, forward);
5. inverts the residual in plan order (kernels K1+K2, FFT tail);
6. runs Hogbom CLEAN on the residual (kernel K5).

The slice ports the branches the flagship configuration takes: stokesI,
one channel, a single "T" (phase-only, scalar) term, Hogbom, no sky
components, no clean window. Every other branch raises and names the
ROADMAP slice that brings it.
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
from .ops.cleaners import hogbom_lanes
from .ops.deconvolution import (
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

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["ical"]


class _SortedWorkspace:
    """Image-frame, plan-sorted visibility workspace: observed values and
    weights are moved into plan order once, so a major cycle never sorts
    them again."""

    def __init__(self, vis, model, plan, components=None):
        if components is not None and components.ncomp > 0:
            raise not_ported("sky components in the fused cycle", "S7x")
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
        perm = plan.plans[0].gp.perm
        # each polarisation's values and weights move in one launch
        moved = [
            permute_apply(
                perm,
                ms[:, :, 0, p].reshape(-1).to(torch.complex64).contiguous(),
                wgt[:, :, 0, p].reshape(-1).to(torch.float32).contiguous(),
            )
            for p in range(self.npol)
        ]
        self.obs_s = [m[0] for m in moved]
        self.wgt_s = [m[1] for m in moved]


class _FusedTermCfg(typing.NamedTuple):
    name: str
    phase_only: bool
    first_selfcal: int


class _FusedCfg(typing.NamedTuple):
    npol: int
    terms: tuple
    normalise_gains: str | None
    solver_niter: int
    solver_tol: float
    clean_gain: float
    clean_niter: int
    clean_thresh: float
    clean_frac: float


class _FusedSelfCal(_SortedWorkspace):
    """Device-resident workspace of :func:`_fused_selfcal_cycle` for the
    ported configuration: one "T" term, stokesI, windowless Hogbom."""

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
        if algorithm != "hogbom":
            raise not_ported(f"algorithm {algorithm!r} in the fused cycle", "S9")
        find_window(
            model,
            clean_kwargs.get("window_shape"),
            mask=clean_kwargs.get("mask"),
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
        frac, cgain, cniter, cthresh, _ = common_arguments(**clean_kwargs)
        self.cfg = _FusedCfg(
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
            clean_gain=cgain,
            clean_niter=cniter,
            clean_thresh=cthresh,
            clean_frac=frac,
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


def _fused_clean(residual, psf_patch, cfg: _FusedCfg):
    """The Hogbom lane: every (chan, pol) plane cleans independently;
    lanes with an empty PSF get a unit delta and their components are
    dropped."""
    nchan, npol, ny, nx = residual.shape
    d2 = residual.reshape(-1, ny, nx).contiguous()
    p2 = psf_patch.reshape(-1, *psf_patch.shape[-2:])
    ok = p2.amax(dim=(-2, -1)) > 0.0
    delta = torch.zeros_like(p2)
    delta[:, p2.shape[-2] // 2, p2.shape[-1] // 2] = 1.0
    p2_safe = torch.where(ok[:, None, None], p2, delta).contiguous()
    cb, _ = hogbom_lanes(
        d2,
        p2_safe,
        gain=cfg.clean_gain,
        thresh=cfg.clean_thresh,
        niter=cfg.clean_niter,
        fracthresh=cfg.clean_frac,
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
    residual invert, Hogbom. Returns (model_pixels, gains, gwts, gress,
    residual, sumwt, peak)."""
    cfg = ws.cfg
    plan = ws.plan.plans[0]
    perm = plan.gp.perm
    npol = cfg.npol
    model_s = []
    for p in range(npol):
        if with_model:
            model_s.append(
                predict_with_plan(plan, model_pixels[0, p], to_sorted=True)
            )
        else:
            model_s.append(ws.obs_s[p] * 0.0)

    any_cal = any(do_cal)
    if any_cal:
        ntime, nbl = ws.cal[0]["w_t"].shape[1], ws.a1.shape[0]
        pols = [
            permute_apply(perm, model_s[p], inverse=True).reshape(ntime, nbl, 1)
            for p in range(npol)
        ]
        mvis = torch.stack(pols, dim=-1)  # [t, b, 1, npol]
        gains, gwts, gress, inv_tot = _solve_terms(ws, cfg, gains, mvis)

    ny = nx = plan.npixel
    device = model_pixels.device
    pixels = torch.zeros((1, npol, ny, nx), dtype=torch.float32, device=device)
    sumwt = torch.zeros((1, npol), dtype=torch.float32, device=device)
    for p in range(npol):
        if any_cal:
            f_p = inv_tot[:, :, 0, p].reshape(-1)
            corr = ws.obs_s[p] * permute_apply(perm, f_p.contiguous())
        else:
            corr = ws.obs_s[p]
        resid_s = corr - model_s[p]
        dirty, swt = invert_with_plan(
            plan, resid_s, ws.wgt_s[p], values_sorted=True
        )
        pixels[0, p] = dirty.to(torch.float32)
        sumwt[0, p] = swt
    okw = sumwt > 0.0
    scale = torch.where(okw, 1.0 / torch.where(okw, sumwt, 1.0), 0.0)
    residual = pixels * scale[:, :, None, None]

    comp_pixels = _fused_clean(residual, ws.psf_patch, cfg)
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
    """ICAL: iterative calibration + imaging self-cal loop, fused path.

    :return: (model Image, residual Image, restored Image, gaintables dict)
    """
    if controls is None:
        controls = create_calibration_controls()
    if kwargs.pop("fused", True) is False:
        raise not_ported("the composed (fused=False) ical path", "S7x")
    if kwargs.pop("use_plan", True) is False:
        raise not_ported("ical without an imaging plan", "S8")
    if checkpoint_path is not None or state is not None:
        raise not_ported("ical checkpoints (SelfCalState)", "S7x")
    if kwargs.get("epsilon") is not None:
        raise not_ported("ical(epsilon=...)", "S8")
    if vis.npol != 1 or model.npol != 1:
        raise not_ported("polarised ical (npol > 1)", "S7x")
    ikw = {k: kwargs.pop(k) for k in ("support", "nw", "do_wstacking") if k in kwargs}
    plan = make_visibility_plan(vis, model, context=context, **ikw)
    psf, _ = invert_visibility(
        vis, model, dopsf=True, context=context, plan=plan, **ikw
    )
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


def _restore_with_components(current, psf, residual, components):
    """Restore the model with the fitted clean beam and add the residual
    (sky components are not ported yet)."""
    if components is not None and components.ncomp > 0:
        raise not_ported("restoring sky components", "S7x")
    clean_beam = fit_psf(psf)
    return restore_cube(
        current, psf=psf, residual=residual, clean_beam=clean_beam
    )
