"""The self-calibration and continuum-imaging major cycles.

Counterpart of ``ska_sdp_func_python_tpu/pipeline.py``. ``ical`` and
``continuum_imaging`` run one of two device paths, both through the
card's kernels:

- the fused cycle (the default wherever it applies): one plan per image
  channel (one over every channel for MFS), the PSF through them, a
  plan-sorted workspace, and
  :func:`_fused_selfcal_cycle` once per major cycle. One cycle:

  1. degrids the model image of every channel in that channel's plan
     order (one batched FFT head and one launch of kernel K3 for all
     channels) and adds the sky components' visibilities;
  2. moves the model into natural order (one launch of kernel K4, a
     gather through the inverse permutations);
  3. solves the calibration context's terms in turn ("T", "G", "B"):
     product-form normal equations over the running corrected
     visibilities and the StefCal solve; ``continuum_imaging`` leaves
     this out;
  4. moves the inverse gain factors of every polarisation into every
     channel's plan order (one launch of kernel K4: from shared sources
     while every term has one solution channel, else per channel), or,
     with a full-Jones term, the residual formed in natural order through
     the Mueller correction;
  5. inverts each channel's residual in plan order in turn (kernels
     K1+K2, FFT tail);
  6. CLEANs the residual cube: msclean (kernel K7, the default) or Hogbom
     (K5) per (channel, polarisation) plane, or MSMFS (``algorithm=
     "mmclean"``, kernel K8) on the cube's frequency moments, with an
     optional clean window;

- the composed cycle (``fused=False``, frames or ``"matrix"`` controls
  the fused cycle does not take, or no plan): predict,
  ``calibrate_chain`` warm-started from the previous cycle's tables,
  subtract, invert and ``deconvolve_cube``, each a call of the public
  API. With a plan (the default) predict and invert run
  K3, K4 and K1 on it; with ``use_plan=False`` the imaging API serves
  them (its plan cache on the card, the core path on the CPU).

The port covers npol 1, 2 and 4 (visibilities converted to the model's
frame), one image channel per visibility channel or one image channel
from all of them (multi-frequency synthesis), diagonal Jones terms and
full-Jones ``"matrix"`` terms (a Mueller chain in the fused cycle), and
sky components in the model. ``epsilon=`` raises: the JAX pipelines
accept it and ignore it, so there is no reference behaviour to port.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
import typing
from typing import Optional

import torch

from .config import resolve_device
from .io.gainio import load_gaintables, save_gaintables
from .models.components import SkyComponents
from .models.gaintable import GainTable, create_gaintable_from_visibility
from .models.image import Image
from .models.polarisation import convert_pol_frame
from .models.visibility import Visibility
from .ops.calibration_chain import calibrate_chain, create_calibration_controls
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
    deconvolve_cube,
    find_window,
    fit_psf,
    restore_cube,
)
from .ops.dft import dft_skycomponent_visibility
from .ops.gain_ops import _gain_row_of_time, _inv2x2
from .ops.imaging import (
    invert_visibility,
    invert_with_plan,
    make_visibility_plan,
    normalise_sumwt,
    predict_visibility,
    predict_with_stack,
    shift_vis_to_image,
)
from .ops.permute import permute_apply
from .ops.skycomponent_ops import restore_skycomponent
from .ops.solvers import (
    _interval_weights,
    assemble_normal_equations,
    finish_solution,
    ne_index_map,
    solve_gains_core,
)
from .ops.taylor import moment_weights
from .ops.visibility_ops import subtract_visibility

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["ical", "continuum_imaging", "SelfCalState"]

_MMCLEAN = ("msmfsclean", "mfsmsclean", "mmclean")


def _to_host(obj) -> dict:
    """A dataclass's fields with every tensor as a numpy copy, and the
    names of those fields."""
    fields, tensors = {}, []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
            tensors.append(f.name)
        fields[f.name] = v
    return {"fields": fields, "tensors": tensors}


def _from_host(cls, blob: dict, device):
    fields = dict(blob["fields"])
    for name in blob["tensors"]:
        fields[name] = torch.as_tensor(fields[name], device=device)
    return cls(**fields)


@dataclasses.dataclass
class SelfCalState:
    """Checkpointable self-cal state: (model, gaintables, cycle index).

    The file holds numpy copies of the model and the gaintables, in the
    port's own format (a JAX package checkpoint pickles that package's
    classes)."""

    model: Image
    gaintables: dict
    cycle: int

    def save(self, path: str) -> None:
        blob = {
            "model": _to_host(self.model),
            "gaintables": {k: _to_host(v) for k, v in self.gaintables.items()},
            "cycle": int(self.cycle),
        }
        with open(path, "wb") as fh:
            pickle.dump(blob, fh)

    @classmethod
    def load(cls, path: str, device=None) -> "SelfCalState":
        """The state saved at ``path``, its tensors on ``device`` (None:
        the CUDA card)."""
        device = resolve_device(device)
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        return cls(
            model=_from_host(Image, blob["model"], device),
            gaintables={
                k: _from_host(GainTable, v, device)
                for k, v in blob["gaintables"].items()
            },
            cycle=blob["cycle"],
        )

    def export_gaintables(self, path: str) -> None:
        """Write the solutions to a standalone HDF5 or npz file (see
        :mod:`ska_sdp_func_python_torch.io.gainio`), which either package
        reads without the pickled state."""
        save_gaintables(self.gaintables, path)

    @classmethod
    def import_gaintables(cls, model, path: str, cycle: int = 0):
        """A state from a standalone solution file and a model image; the
        tables go to the model's device."""
        return cls(
            model=model,
            gaintables=load_gaintables(path, device=model.pixels.device),
            cycle=cycle,
        )


class _PlanRows:
    """The payload-row layout of a plan stack (``mfs``: one plan over every
    visibility channel), shared by the in-memory workspaces and the
    streamed cycle's slabs."""

    mfs: bool = False

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """[time, baseline, chan] -> the payload rows of the plan stack:
        ``[nchan, time * baseline]``, each channel in natural order, or
        for an MFS plan one row of every channel in (time, baseline,
        channel) order."""
        if self.mfs:
            return x.reshape(1, -1)
        return x.permute(2, 0, 1).reshape(x.shape[2], -1)

    def natural(self, rows: torch.Tensor, ntime: int, nbl: int) -> torch.Tensor:
        """The inverse of :meth:`rows`: ``[nchan, n]`` -> [time, baseline,
        chan]."""
        if self.mfs:
            return rows.reshape(ntime, nbl, -1)
        return rows.reshape(-1, ntime, nbl).permute(1, 2, 0)


class _SortedWorkspace(_PlanRows):
    """Image-frame, plan-sorted visibility workspace: the observed values
    and weights of every (channel, polarisation), and the visibilities of
    the sky components, are moved into that channel plan's order once, so
    a major cycle never sorts them again."""

    def __init__(self, vis, model, plan, components=None):
        if not plan.mfs and plan.nchan != vis.nchan:
            raise ValueError(
                f"the sorted workspace images every visibility channel: "
                f"{vis.nchan} channels, {plan.nchan} image channels"
            )
        svis = shift_vis_to_image(vis, model)
        ms = convert_pol_frame(
            svis.flagged_vis, vis.polarisation_frame, model.polarisation_frame,
            polaxis=3,
        )
        wgt, fw = svis.flagged_imaging_weight, svis.flagged_weight
        if wgt.shape[-1] != ms.shape[-1]:
            # the conversion changed the polarisation count: the first
            # polarisation's weights serve every one
            wgt = wgt[..., :1].expand(ms.shape)
            fw = fw[..., :1].expand(ms.shape)
        comp_ms = None
        if components is not None and components.ncomp > 0:
            cvis = dft_skycomponent_visibility(
                vis.replace(vis=torch.zeros_like(vis.vis)), components
            )
            comp_ms = convert_pol_frame(
                shift_vis_to_image(cvis, model).vis,
                vis.polarisation_frame,
                model.polarisation_frame,
                polaxis=3,
            )
        self.plan = plan
        self.mfs = plan.mfs
        self.npol = ms.shape[-1]
        # natural-order arrays for the solver leg (V_obs / V_model is
        # invariant under the phase shift, so gains solve in the image frame)
        self.ms_nat = ms
        self.fw_nat = fw
        # each (image channel, polarisation)'s sum of imaging weights
        self.sumwt = wgt.sum(dim=(0, 1, 2))[None] if self.mfs else wgt.sum(dim=(0, 1))
        # obs_s[pol], wgt_s[pol], comp_s[pol]: [nchan, n], each image
        # channel in its plan's order; a polarisation's payloads of every
        # channel move in one launch, by the plan stack's permutations
        self.obs_s, self.wgt_s = [], []
        self.comp_s = None if comp_ms is None else []
        for p in range(self.npol):
            rows = [
                self.rows(ms[..., p]).to(torch.complex64).contiguous(),
                self.rows(wgt[..., p]).to(torch.float32).contiguous(),
            ]
            if comp_ms is not None:
                rows.append(self.rows(comp_ms[..., p]).to(torch.complex64).contiguous())
            moved = permute_apply(plan.stack.perm, *rows)
            self.obs_s.append(moved[0])
            self.wgt_s.append(moved[1])
            if comp_ms is not None:
                self.comp_s.append(moved[2])

    def model_sorted(self, pixels: torch.Tensor, with_model: bool) -> list:
        """Per polarisation, the plan-ordered model visibilities ``[nchan,
        n]``: the degrid of ``pixels`` ``[nchan, npol, ny, nx]`` (when
        ``with_model``) plus the components'. None where both are absent."""
        out = []
        for p in range(self.npol):
            m = (
                predict_with_stack(self.plan, pixels[:, p], to_sorted=True)
                if with_model
                else None
            )
            if self.comp_s is not None:
                m = self.comp_s[p] if m is None else m + self.comp_s[p]
            out.append(m)
        return out

    def invert_sorted(self, resid_s: list, dtype) -> tuple:
        """The invert leg on each channel's plan in turn: plan-ordered
        residuals ``[nchan, n]`` per polarisation -> (dirty pixels
        ``[nchan, npol, ny, nx]`` in ``dtype``, sums of weights ``[nchan,
        npol]``)."""
        plan = self.plan
        nchan, ny = plan.nchan, plan.npixel
        device = resid_s[0].device
        pixels = torch.zeros((nchan, self.npol, ny, ny), dtype=dtype, device=device)
        sumwt = torch.zeros((nchan, self.npol), dtype=torch.float32, device=device)
        for p in range(self.npol):
            for c in range(nchan):
                dirty, swt = invert_with_plan(
                    plan.plans[c], resid_s[p][c], self.wgt_s[p][c], values_sorted=True
                )
                pixels[c, p] = dirty.to(dtype)
                sumwt[c, p] = swt
        return pixels, sumwt

    def residual_invert(self, template: Image, pixels, with_model: bool):
        """One sort-free leg of the composed continuum cycle: predict in
        plan order, subtract, invert. Returns (normalised residual Image,
        sumwt)."""
        model_s = self.model_sorted(pixels, with_model)
        resid_s = [
            o if m is None else o - m for o, m in zip(self.obs_s, model_s)
        ]
        dirty, sumwt = self.invert_sorted(resid_s, template.pixels.dtype)
        return normalise_sumwt(template.replace(pixels=dirty), sumwt), sumwt


def _workspace_psf(ws: _SortedWorkspace, model: Image) -> Image:
    """The PSF (unit amplitude in the first polarisation) that
    ``invert_visibility(dopsf=True)`` gives on the workspace's plans: the
    invert leg on its plan-ordered weights as the values, which need no
    second sort, normalised by the workspace's sums of weights."""
    pixels = torch.zeros_like(model.pixels)
    for c, ip in enumerate(ws.plan.plans):
        dirty, _ = invert_with_plan(ip, ws.wgt_s[0][c], values_sorted=True)
        pixels[c, 0] = dirty.to(pixels.dtype)
    return normalise_sumwt(model.replace(pixels=pixels), ws.sumwt)


class _FusedTermCfg(typing.NamedTuple):
    """One letter of the calibration context."""

    name: str
    phase_only: bool
    first_selfcal: int
    # one solution channel per visibility channel ("B"): the normal
    # equations keep the channel axis, the inverse factors are per channel
    per_chan: bool = False
    # a "matrix" control: the matrix lane, which needs npol 4 (the scalar
    # lane runs at npol 1, as in solve_gains_core)
    crosspol: bool = False


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
    """Device-resident workspace of :func:`_fused_selfcal_cycle`: npol 1,
    2 or 4, one or more image channels or one MFS channel, sky
    components, a chain of diagonal ("T", "G", "B") and full-Jones
    ("matrix") terms, msclean, Hogbom or MSMFS with an optional clean
    window. Per term it holds the unit gaintable and the interval
    membership of each integration; what CLEAN derives from the PSF alone
    (the msclean scale stacks per plane, none for a plane without PSF;
    the MSMFS moment weights, moment-PSF peak and moment stacks) is built
    here once, not in every cycle."""

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
        **clean_kwargs,
    ):
        super().__init__(vis, model, plan, components)
        psf = self.psf = _workspace_psf(self, model)
        algorithm = clean_kwargs.get("algorithm", "msclean")
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
        self.gt0s, self.cal, term_cfgs = [], [], []
        for name in terms:
            gt0 = create_gaintable_from_visibility(
                vis, jones_type=name, timeslice=controls[name]["timeslice"]
            )
            row_idx, has_row = _gain_row_of_time(vis.time, gt0.time, gt0.interval)
            self.gt0s.append(gt0)
            self.cal.append(
                {
                    "w_t": _interval_weights(
                        vis.time, gt0.time, gt0.interval, vis.weight.dtype
                    ),
                    "row_idx": row_idx,
                    "has_row": has_row,
                }
            )
            term_cfgs.append(
                _FusedTermCfg(
                    name=name,
                    phase_only=controls[name]["phase_only"],
                    first_selfcal=controls[name]["first_selfcal"],
                    per_chan=gt0.gain.shape[2] > 1,
                    crosspol=controls[name].get("shape") == "matrix",
                )
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
        # a plane without PSF (every polarisation but the first) cleans
        # nothing: the JAX package's msclean turns it into NaN components
        self.ms_stacks = (
            [
                [
                    msclean_psf_stacks(pp, ny, nx, scales)
                    if float(pp.max()) > 0.0
                    else None
                    for pp in pc
                ]
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
            terms=tuple(term_cfgs),
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


# the receptor pair (r1, r2) of each polarisation column of a diagonal
# Jones term: V'_p = V_p / (g1[r1, r1] conj(g2[r2, r2]))
_POL_RECS = {1: ((0, 0),), 2: ((0, 0), (1, 1)), 4: ((0, 0), (0, 1), (1, 0), (1, 1))}


def _mueller_apply(mm, v):
    """sum_q mm[..., p, q] v[..., q]: Muellers ``[t, b, Fc, n, n]`` on
    visibilities ``[t, b, nf, n]`` (Fc 1 broadcasts over the channels),
    as a sum of broadcast products, one per column."""
    out = None
    for q in range(mm.shape[-1]):
        term = mm[..., :, q] * v[..., q : q + 1]
        out = term if out is None else out + term
    return out


def _mueller_product(a, b):
    """a @ b for Muellers ``[t, b, Fc, n, n]`` (Fc broadcasts), as a sum of
    broadcast products over the inner index."""
    out = None
    for q in range(a.shape[-1]):
        term = a[..., :, q, None] * b[..., None, q, :]
        out = term if out is None else out + term
    return out


def _crosspol_inverse(ws, gg, hr):
    """The Mueller inverse of a full-Jones term, kron(J1^-1, conj(J2^-1)):
    M[(i, l), (j, k)] = J1inv[i, j] conj(J2inv[l, k]) per (time,
    baseline, Fc), ``[t, b, Fc, 4, 4]``; the identity where either Jones
    is singular (|det| <= 1e-30) or the integration has no solution."""
    gi, okd = _inv2x2(gg, min_det=1e-30)
    g1i, g2i = gi[:, ws.a1], gi[:, ws.a2]  # [t, b, Fc, 2, 2]
    mm = g1i[..., :, None, :, None] * g2i.conj()[..., None, :, None, :]
    mm = mm.reshape(mm.shape[:3] + (4, 4))
    okb = (okd[:, ws.a1] & okd[:, ws.a2]) & hr
    eye4 = torch.eye(4, dtype=mm.dtype, device=mm.device)
    return torch.where(okb[..., None, None], mm, eye4)


def _diagonal_inverse(ws, gg, hr, npol):
    """The inverse factors of a diagonal Jones term per (time, baseline,
    Fc, polarisation), ``[t, b, Fc, npol]``: 1 / (g1[r1, r1] conj(g2[r2,
    r2])), zero where that product is zero, one where the integration has
    no solution."""
    recs = _POL_RECS[npol]
    d = torch.diagonal(gg, dim1=-2, dim2=-1)  # [t, nants, Fc, nrec]
    g1 = d[:, ws.a1][..., [r for r, _ in recs]]
    g2 = d[:, ws.a2][..., [r for _, r in recs]]
    sm = g1 * g2.conj()  # [t, b, Fc, npol]
    m2 = sm.real**2 + sm.imag**2
    ok = m2 > 0.0
    inv_p = torch.where(ok, sm.conj() / torch.where(ok, m2, 1.0), 0.0)
    return torch.where(hr[..., None], inv_p, torch.ones_like(inv_p))


def _solve_terms(ws: _FusedSelfCal, cfg: _FusedCfg, gains, gwts, gress, do_cal, mvis):
    """The term solves, term after term of the context: product-form
    normal equations ``x*w = V conj(V_model) w``, ``xwt = |V_model|^2 w``
    from the running corrected natural-order visibilities (summed over
    the channels, or per channel for a "B" term), the batched StefCal
    solve (the scalar lane at npol 1, the matrix lane at npol 2 and 4),
    and the inverse correction of each term, which corrects the
    visibilities before the next term and composes into the total.

    Diagonal mode (no "matrix" term): the total is per-(time, baseline,
    Fc, polarisation) factors ``[t, b, Fc, npol]``. Matrix mode (any
    "matrix" term, npol 4): a full-Jones term's correction is its Mueller
    inverse, a diagonal term's the diagonal Mueller of its factors, and
    the total ``[t, b, Fc, 4, 4]`` is their product, Fc 1 (T, G)
    broadcast to nchan where a "B" term joins the chain. Returns (gains,
    gain weights, residuals, total)."""
    npol = cfg.npol
    fw, corrected = ws.fw_nat, ws.ms_nat
    gains, gwts, gress = list(gains), list(gwts), list(gress)
    matrix_mode = any(t.crosspol for t in cfg.terms)
    we = (mvis.real**2 + mvis.imag**2) * fw
    inv_tot = None
    for it, term in enumerate(cfg.terms):
        if not do_cal[it]:
            continue
        cal = ws.cal[it]
        xe = corrected * mvis.conj() * fw
        w_t = cal["w_t"]
        if term.per_chan:
            xb = torch.einsum("st,tbfp->sbfp", w_t.to(xe.dtype), xe)
            wb = torch.einsum("st,tbfp->sbfp", w_t.to(we.dtype), we)
        else:
            xb = torch.einsum("st,tbfp->sbp", w_t.to(xe.dtype), xe)[:, :, None, :]
            wb = torch.einsum("st,tbfp->sbp", w_t.to(we.dtype), we)[:, :, None, :]
        x, xwt = assemble_normal_equations(xb, wb, ws.ne_idx, gains[it].shape[1])
        del xe, xb, wb  # [t, b, ...] sized: not held through the solve
        gain_new, gwt, gres = solve_gains_core(
            x,
            xwt,
            gains[it],
            niter=cfg.solver_niter,
            tol=cfg.solver_tol,
            phase_only=term.phase_only,
            crosspol=term.crosspol,
            npol=npol,
        )
        gains[it], gwts[it], gress[it] = finish_solution(
            gain_new, gwt, gres, xwt, term.phase_only, cfg.normalise_gains, eye=True
        )
        # [ntime, nants, Fc, nrec, nrec], Fc 1 (T, G) or nchan (B)
        gg = gains[it][cal["row_idx"]]
        hr = cal["has_row"][:, None, None]  # rows outside every interval
        if term.crosspol:
            inv = _crosspol_inverse(ws, gg, hr)
            corrected = _mueller_apply(inv, corrected)
        else:
            inv = _diagonal_inverse(ws, gg, hr, npol)
            corrected = corrected * inv
            if matrix_mode:
                inv = inv[..., None] * torch.eye(npol, dtype=inv.dtype, device=inv.device)
        if inv_tot is None:
            inv_tot = inv
        elif matrix_mode:
            inv_tot = _mueller_product(inv, inv_tot)
        else:
            inv_tot = inv_tot * inv
    return gains, gwts, gress, inv_tot


def _fused_clean(residual, ws: _FusedSelfCal, cfg: _FusedCfg):
    """The CLEAN lane of the cycle; returns the component cube.

    Hogbom: every (chan, pol) plane cleans independently in one batch;
    lanes with an empty PSF get a unit delta and their components are
    dropped. msclean: each plane in turn, with the workspace's scale
    stacks; a plane with an empty PSF gets no components. Both search
    within the clean window when there is one.

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
                if ws.ms_stacks[c][p] is None:
                    continue
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
    """One self-cal major cycle in the plan-sorted domain: model degrid
    plus the components, back-permute, normal equations and StefCal solve
    of each active term, the correction's permute, residual invert,
    CLEAN. Returns (model_pixels, gains, gwts, gress, residual, sumwt,
    peak).

    It serves one image channel (the JAX package's
    ``_fused_selfcal_cycle``), a cube (``_fused_selfcal_cycle_cube``) and
    an MFS plan alike: the predict and permute legs run over the plan
    stack of all channels at once (the JAX package vmaps them over the
    channel-stacked plans), each K4 launch moves every polarisation, the
    solve takes the model visibilities as ``[time, baseline, chan, pol]``
    (an MFS plan's one row reshaped), and the invert leg runs on each
    channel's plan in turn. With diagonal terms the inverse factors go
    to plan order and multiply the sorted observations; with a "matrix"
    term the Mueller correction mixes polarisations, so the residual is
    formed in natural order and goes to plan order instead."""
    cfg = ws.cfg
    perm = ws.plan.stack.perm
    npol = cfg.npol
    # [nchan, n] per polarisation, each channel in its plan's order
    model_s = [
        ws.obs_s[p] * 0.0 if m is None else m
        for p, m in enumerate(ws.model_sorted(model_pixels, with_model))
    ]

    any_cal = any(do_cal)
    if not any_cal:
        resid_s = [o - m for o, m in zip(ws.obs_s, model_s)]
    else:
        ntime, nbl = ws.cal[0]["w_t"].shape[1], ws.a1.shape[0]
        nat = _as_list(permute_apply(ws.plan.stack.iperm, *model_s))
        mvis = torch.stack([ws.natural(m, ntime, nbl) for m in nat], dim=-1)
        gains, gwts, gress, inv_tot = _solve_terms(
            ws, cfg, gains, gwts, gress, do_cal, mvis
        )
        if inv_tot.ndim == 5:
            resid_nat = _mueller_apply(inv_tot, ws.ms_nat) - mvis
            rows = [ws.rows(resid_nat[..., p]).contiguous() for p in range(npol)]
            resid_s = _as_list(permute_apply(perm, *rows))
        else:
            if inv_tot.shape[2] == 1 and not ws.mfs:
                # one (time, baseline) factor serves every channel: shared
                # sources of the stacked permute
                rows = [inv_tot[:, :, 0, p].reshape(-1).contiguous() for p in range(npol)]
                shared = tuple(range(npol))
            else:
                # a "B" term (or an MFS plan's channels in one row) spreads
                # the factors over the channels
                f = inv_tot.expand(-1, -1, ws.ms_nat.shape[2], -1)
                rows = [ws.rows(f[..., p]).contiguous() for p in range(npol)]
                shared = ()
            inv_s = _as_list(permute_apply(perm, *rows, shared=shared))
            resid_s = [o * g - m for o, g, m in zip(ws.obs_s, inv_s, model_s)]
    pixels, sumwt = ws.invert_sorted(resid_s, torch.float32)
    okw = sumwt > 0.0
    scale = torch.where(okw, 1.0 / torch.where(okw, sumwt, 1.0), 0.0)
    residual = pixels * scale[:, :, None, None]

    comp_pixels = _fused_clean(residual, ws, cfg)
    model_pixels = model_pixels + comp_pixels
    peak = residual.abs().max()
    return model_pixels, gains, gwts, gress, residual, sumwt, peak


def _as_list(moved) -> list:
    """permute_apply's result (one tensor or a tuple) as a list."""
    return list(moved) if isinstance(moved, tuple) else [moved]


def ical(
    vis: Visibility,
    model: Image,
    components: Optional[SkyComponents] = None,
    nmajor: int = 5,
    calibration_context: str = "T",
    controls: Optional[dict] = None,
    context: str = "ng",
    checkpoint_path: Optional[str] = None,
    state: Optional[SelfCalState] = None,
    **kwargs,
):
    """ICAL: iterative calibration + imaging self-cal loop, on one image
    channel, a cube (one image channel per visibility channel) or one
    MFS channel from many, at npol 1, 2 or 4.
    ``algorithm`` is "msclean" (the default), "hogbom" or "mmclean"
    (MSMFS, which needs ``nchan > 2 (nmoment - 1)``).
    ``calibration_context`` orders the terms of ``controls`` ("T", "G",
    "B"). ``fused`` (default: wherever it applies) chooses the fused
    cycle, ``use_plan=False`` the composed cycle on the imaging API's own
    routes. With ``checkpoint_path`` each cycle saves a
    :class:`SelfCalState`; ``state`` resumes from one.

    :return: (model Image, residual Image, restored Image, gaintables dict)
    """
    if controls is None:
        controls = create_calibration_controls()
    fused, plan, ikw = _setup("ical", vis, model, context, kwargs)
    # the JAX package's gate: the solve runs in the model's frame, so the
    # frames agree; full-Jones terms fuse at npol 4 on one image channel
    can_fuse = (
        plan is not None
        and vis.npol == model.npol
        and (vis.npol == 1 or vis.polarisation_frame == model.polarisation_frame)
        and all(
            controls[c]["shape"] in ("scalar", "vector")
            or (controls[c]["shape"] == "matrix" and vis.npol == 4 and model.nchan == 1)
            for c in calibration_context
        )
    )
    if _fuse(fused, can_fuse):
        return _ical_fused(
            vis, model, components, nmajor, calibration_context, controls,
            plan, checkpoint_path, state, **kwargs,
        )
    if fused:
        log.warning(
            "ical: fused=True requested but this configuration is not "
            "fusable (plan=%s, algorithm=%r, window=%r, context=%r, "
            "npol=%d/%d) — falling back to the composed path",
            plan is not None,
            kwargs.get("algorithm", "msclean"),
            kwargs.get("window_shape"),
            calibration_context,
            vis.npol,
            model.npol,
        )
    psf, _ = invert_visibility(vis, model, dopsf=True, context=context, plan=plan, **ikw)
    log.info("ical[composed]: PSF ready, %d visibilities", vis.nvis)
    if state is not None:
        current, gaintables, start = state.model, state.gaintables, state.cycle
    else:
        current = model.replace(pixels=torch.zeros_like(model.pixels))
        gaintables, start = None, 0
    residual = None
    for cycle in range(start, nmajor):
        # the model is non-zero once a minor cycle has added components
        mvis = _predict_model(
            vis, current, components, context, cycle > 0, plan=plan, **ikw
        )
        cvis, gaintables = calibrate_chain(
            vis,
            mvis,
            gaintables=gaintables,
            calibration_context=calibration_context,
            controls=controls,
            iteration=cycle,
        )
        rvis = subtract_visibility(cvis, mvis)
        residual, _ = invert_visibility(rvis, model, context=context, plan=plan, **ikw)
        comp, _ = deconvolve_cube(residual, psf, **kwargs)
        current = current.replace(pixels=current.pixels + comp.pixels)
        if log.isEnabledFor(logging.INFO):
            log.info(
                "ical[composed]: cycle %d peak residual %.6f",
                cycle, float(residual.pixels.abs().max()),
            )
        if checkpoint_path is not None:
            SelfCalState(current, gaintables, cycle + 1).save(checkpoint_path)
    restored = _restore_with_components(current, psf, residual, components)
    return current, residual, restored, gaintables


def _ical_fused(
    vis,
    model,
    components,
    nmajor,
    terms: str,
    controls,
    plan,
    checkpoint_path,
    state,
    solver_niter: int = 200,
    tol: float = 1e-6,
    **kwargs,
):
    """Fused-cycle ICAL driver: one :func:`_fused_selfcal_cycle` per major
    cycle, with a host fetch of the peak residual only for logging."""
    ws = _FusedSelfCal(
        vis, model, plan, components, list(terms), controls, "mean",
        solver_niter, tol, **kwargs,
    )
    if state is None:
        start, tables = 0, ws.gt0s
        model_px = torch.zeros_like(model.pixels, dtype=torch.float32)
    else:
        start, tables = state.cycle, [state.gaintables[t] for t in terms]
        model_px = state.model.pixels.to(torch.float32)
    gains = [gt.gain for gt in tables]
    gwts = [gt.weight for gt in tables]
    gress = [gt.residual for gt in tables]
    res_px = None
    log.info("ical[fused]: workspace ready, %d visibilities", vis.nvis)
    for cycle in range(start, nmajor):
        do_cal = tuple(cycle >= t.first_selfcal for t in ws.cfg.terms)
        model_px, gains, gwts, gress, res_px, _, peak = _fused_selfcal_cycle(
            ws, model_px, gains, gwts, gress,
            do_cal=do_cal, with_model=cycle > 0,
        )
        if log.isEnabledFor(logging.INFO):
            log.info("ical[fused]: cycle %d peak residual %.6f", cycle, float(peak))
        if checkpoint_path is not None:
            SelfCalState(
                model.replace(pixels=model_px.to(model.pixels.dtype)),
                ws.gaintables(gains, gwts, gress),
                cycle + 1,
            ).save(checkpoint_path)
    current = model.replace(pixels=model_px.to(model.pixels.dtype))
    residual = model.replace(pixels=res_px) if res_px is not None else None
    gaintables = ws.gaintables(gains, gwts, gress)
    restored = _restore_with_components(current, ws.psf, residual, components)
    return current, residual, restored, gaintables


def continuum_imaging(
    vis: Visibility,
    model: Image,
    nmajor: int = 5,
    context: str = "ng",
    components: Optional[SkyComponents] = None,
    **kwargs,
):
    """Major/minor-cycle CLEAN imaging without self-calibration, on one
    image channel or a cube: :func:`_fused_selfcal_cycle` with the
    calibration leg left out, or (``fused=False``) the composed cycle on
    the sorted workspace, or (``use_plan=False``) on the imaging API's own
    routes. ``algorithm`` as for :func:`ical`; "mmclean" on a cube is
    MSMFS continuum imaging.

    :return: (model Image, residual Image, restored Image)
    """
    fused, plan, ikw = _setup("continuum_imaging", vis, model, context, kwargs)
    if _fuse(fused, plan is not None):
        return _continuum_fused(vis, model, nmajor, components, plan, **kwargs)
    if fused:
        log.warning(
            "continuum_imaging: fused=True requested but this "
            "configuration is not fusable (plan=%s, algorithm=%r, "
            "window=%r) — falling back to the composed path",
            plan is not None,
            kwargs.get("algorithm", "msclean"),
            kwargs.get("window_shape"),
        )
    psf, _ = invert_visibility(vis, model, dopsf=True, context=context, plan=plan, **ikw)
    ws = None if plan is None else _SortedWorkspace(vis, model, plan, components)
    log.info("continuum_imaging[composed]: PSF ready, %d visibilities", vis.nvis)
    current = model.replace(pixels=torch.zeros_like(model.pixels))
    residual = None
    for cycle in range(nmajor):
        if ws is not None:
            residual, _ = ws.residual_invert(model, current.pixels, cycle > 0)
        else:
            mvis = _predict_model(
                vis, current, components, context, cycle > 0, plan=None, **ikw
            )
            residual, _ = invert_visibility(
                subtract_visibility(vis, mvis), model, context=context, **ikw
            )
        comp, _ = deconvolve_cube(residual, psf, **kwargs)
        current = current.replace(pixels=current.pixels + comp.pixels)
        if log.isEnabledFor(logging.INFO):
            log.info(
                "continuum_imaging[composed]: cycle %d peak residual %.6f",
                cycle, float(residual.pixels.abs().max()),
            )
    restored = _restore_with_components(current, psf, residual, components)
    return current, residual, restored


def _continuum_fused(vis, model, nmajor, components, plan, **kwargs):
    ws = _FusedSelfCal(
        vis, model, plan, components, ["T"], create_calibration_controls(),
        None, 1, 1e-6, **kwargs,
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
    restored = _restore_with_components(current, ws.psf, residual, components)
    return current, residual, restored


def _fuse(fused, can_fuse: bool) -> bool:
    """Whether the fused cycle runs: by default wherever it can; asked for
    where it cannot, the caller warns and the composed cycle runs. Both
    are device paths."""
    return can_fuse if fused is None else bool(fused) and can_fuse


def _check_algorithm(model: Image, kwargs: dict) -> None:
    """The pipelines' CLEAN algorithms: msclean, Hogbom, and MSMFS,
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
        raise ValueError(f"unsupported algorithm {algorithm}")


def _setup(name: str, vis, model, context: str, kwargs: dict):
    """What ``ical`` and ``continuum_imaging`` share before their cycles:
    the checks of the ported configuration and of the CLEAN algorithm,
    and, unless ``use_plan=False``, one plan per image channel on either
    device (on the CPU the kernels' plain versions run on it). Takes the
    path and imaging keywords out of ``kwargs``. Returns (fused, plan or
    None, imaging keywords)."""
    fused = kwargs.pop("fused", None)
    use_plan = kwargs.pop("use_plan", None)
    if kwargs.get("epsilon") is not None:
        # ignoring an accuracy request silently would be worse than refusing
        raise NotImplementedError(
            f"{name}(epsilon=...) has no reference behaviour: the JAX "
            "pipelines accept epsilon= and ignore it (their plans never see "
            "it); invert_visibility and predict_visibility serve the epsilon "
            "contract"
        )
    _check_algorithm(model, kwargs)
    ikw = {k: kwargs.pop(k) for k in ("support", "nw", "do_wstacking") if k in kwargs}
    plan = (
        None
        if use_plan is False
        else make_visibility_plan(vis, model, context=context, **ikw)
    )
    return fused, plan, ikw


def _predict_model(vis, model, components, context, model_nonzero, **ikw):
    """Model visibilities: the predict of ``model`` when it is non-zero
    (``model_nonzero``, tracked on the host) plus the components' DFT."""
    mvis = vis.replace(vis=torch.zeros_like(vis.vis))
    if model_nonzero:
        mvis = predict_visibility(mvis, model, context=context, **ikw)
    if components is not None and components.ncomp > 0:
        cvis = dft_skycomponent_visibility(
            vis.replace(vis=torch.zeros_like(vis.vis)), components
        )
        mvis = mvis.replace(vis=mvis.vis + cvis.vis)
    return mvis


def _restore_with_components(current, psf, residual, components):
    """Restore the model with the fitted clean beam, add the residual and
    the components as clean-beam Gaussians."""
    clean_beam = fit_psf(psf)
    restored = restore_cube(current, psf=psf, residual=residual, clean_beam=clean_beam)
    if components is not None and components.ncomp > 0:
        restored = restore_skycomponent(restored, components, clean_beam)
    return restored
