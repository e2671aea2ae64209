"""Imaging on a plan: invert and predict between visibilities and images.

Counterpart of the plan path of ``ska_sdp_func_python_tpu/ops/imaging.py``:
linear w-stacking on a reusable plan (``gridding_plan``), an FFT tail on
``torch.fft`` with the w-beam multiply and plane sum over the central
``npixel^2`` only, and the ES grid correction. Sign conventions as in the
JAX package::

    u_pix = -u * npad * cellsize + npad//2
    v_pix = +v * npad * cellsize + npad//2
    dirty(l, m) = sum_k V_k exp(+2 pi i (u l + v m + w (n-1)))
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import complex_of, not_ported
from ..models.image import Image, create_image
from ..models.polarisation import convert_pol_frame
from ..models.visibility import C_M_S, Visibility
from .fft import extract_mid, fft, ifft, pad_mid
from .gridding import _es_beta, es_kernel, grid_correction
from .gridding_plan import (
    GridPlan,
    degrid_with_plan,
    grid_with_plan,
    make_grid_plan,
)
from .pswf import w_beam
from .visibility_ops import phaserotate_visibility

__all__ = [
    "shift_vis_to_image",
    "normalise_sumwt",
    "w_kernel_correction",
    "ImagingPlan",
    "make_imaging_plan",
    "invert_with_plan",
    "predict_with_plan",
    "uv_grids_to_dirty",
    "image_to_uv_grids",
    "VisibilityImagingPlan",
    "make_visibility_plan",
    "invert_visibility",
    "create_image_from_visibility",
]


def shift_vis_to_image(
    vis: Visibility, im: Image, tangent: bool = True, inverse: bool = False
) -> Visibility:
    """Phase-rotate visibilities to the image phase centre."""
    return phaserotate_visibility(
        vis, im.phasecentre, tangent=tangent, inverse=inverse
    )


def normalise_sumwt(im: Image, sumwt: torch.Tensor) -> Image:
    """Divide each image plane by its sum of weights."""
    ok = sumwt > 0.0
    scale = torch.where(ok, 1.0 / torch.where(ok, sumwt, 1.0), 0.0)
    return im.replace(pixels=im.pixels * scale[:, :, None, None])


def _w_planes(w: torch.Tensor, nw: int, w_range=None):
    """Linear w-plane split: per-vis lower plane, fraction and the plane
    centres."""
    if w_range is not None:
        wmin = torch.as_tensor(w_range[0], dtype=w.dtype, device=w.device)
        wmax = torch.as_tensor(w_range[1], dtype=w.dtype, device=w.device)
    else:
        wmin, wmax = w.min(), w.max()
    wstep = torch.clamp((wmax - wmin) / max(nw - 1, 1), min=1e-30)
    t = (w - wmin) / wstep
    plane_w = wmin + wstep * torch.arange(nw, device=w.device).to(w.dtype)
    if nw <= 1:
        return torch.zeros_like(w, dtype=torch.int32), torch.zeros_like(w), plane_w
    p0 = torch.clamp(torch.floor(t).to(torch.int32), 0, nw - 2)
    frac = torch.clamp(t - p0, 0.0, 1.0)
    return p0, frac, plane_w


def w_kernel_correction(
    npixel: int, cellsize, wstep, w_support: int, dtype, beta=None, device=None
):
    """Image-plane correction of ES-kernel w-gridding: the w-kernel's
    transform at ``wstep * |n(l,m) - 1|``, ``[npixel, npixel]`` real."""
    h = w_support / 2.0
    q, wq = np.polynomial.legendre.leggauss(8 * w_support)
    q = torch.as_tensor(q, device=device).to(dtype)
    wq = torch.as_tensor(wq, device=device).to(dtype)
    phi = wq * es_kernel(q, w_support, beta)
    x = (torch.arange(npixel, device=device).to(dtype) - npixel // 2) * cellsize
    l2 = torch.clamp(x[None, :] ** 2 + x[:, None] ** 2, 0.0, 1.0)
    nu = l2 / (1.0 + torch.sqrt(1.0 - l2))  # stable 1 - sqrt(1 - r2)
    xx = (wstep * nu) * (2.0 * np.pi * h)
    c = torch.zeros_like(xx)
    for wphi, qq in zip(phi, q):
        c = c + wphi * torch.cos(xx * qq)
    c = c * h
    return torch.where(c.abs() > 1e-30, c, 1.0)


def _npad_for(npixel: int, padding) -> int:
    """Padded uv-grid size, chosen exactly as the JAX package's default
    grid family chooses it (``npad`` changes the numbers): ``padding``
    times npixel rounded up to a multiple of 128, or a 7-smooth multiple
    of 56 within 6% above that."""
    def up(n):
        return -(-int(n) // 128) * 128

    base = max(up(npixel * padding), up(npixel + 1))
    n = -(-base // 56) * 56
    while n <= base * 1.06:
        m = n
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 56
    return base


def _tile_for(npad: int) -> int:
    """Tile of the plan's segments: the JAX package's choice, so that the
    port's plan order equals the JAX plan's order."""
    for ts in (56, 64, 48, 32, 16, 8):
        if npad % ts == 0:
            return ts
    return 8


@dataclass(frozen=True)
class ImagingPlan:
    """Precomputed invert/predict geometry for one set of (u, v, w)."""

    gp: GridPlan
    plane_w: torch.Tensor  # [nw] w-plane centres
    wb_r: torch.Tensor | None  # [nw, npixel, npixel] central Re(w_beam)
    wb_i: torch.Tensor | None  # [nw, npixel, npixel] central Im(w_beam)
    corr_c: torch.Tensor  # [npixel, npixel] central grid correction
    npixel: int
    npad: int
    cellsize: float
    support: int
    nw: int
    do_wstacking: bool


def make_imaging_plan(
    u,
    v,
    w,
    *,
    npixel: int,
    cellsize: float,
    support: int = 8,
    nw: int = 1,
    do_wstacking: bool = True,
    padding=2,
    w_interp: str = "linear",
    w_range=None,
) -> ImagingPlan:
    """Build a reusable plan for :func:`invert_with_plan` and
    :func:`predict_with_plan` from uvw in wavelengths (device tensors;
    f32 by default, f64 in tests)."""
    if w_interp != "linear":
        raise not_ported(f"w_interp={w_interp!r} plans", "S8")
    device = u.device
    npad = _npad_for(npixel, padding)
    beta = _es_beta(support, npad / npixel)
    scale = npad * cellsize
    u_pix = -u * scale + npad // 2
    v_pix = v * scale + npad // 2
    wstack = do_wstacking and nw > 1
    if wstack:
        p0, frac, plane_w = _w_planes(w, nw, w_range)
        nplanes = nw
    else:
        p0, frac = None, None
        plane_w = torch.zeros((1,), dtype=torch.float32, device=device)
        nplanes = 1
    gp = make_grid_plan(
        u_pix,
        v_pix,
        p0,
        frac,
        npixel=npad,
        support=support,
        nplanes=nplanes,
        tile=_tile_for(npad),
        beta=beta,
    )
    if wstack:
        fov = npad * cellsize
        wb = torch.stack(
            [extract_mid(w_beam(npad, fov, wp), npixel) for wp in plane_w]
        )
        wb_r = wb.real.to(torch.float32).contiguous()
        wb_i = wb.imag.to(torch.float32).contiguous()
    else:
        wb_r = wb_i = None
    corr_c = extract_mid(
        grid_correction(npad, support, torch.float32, beta, device), npixel
    ).contiguous()
    return ImagingPlan(
        gp=gp,
        plane_w=plane_w,
        wb_r=wb_r,
        wb_i=wb_i,
        corr_c=corr_c,
        npixel=npixel,
        npad=npad,
        cellsize=float(cellsize),
        support=support,
        nw=nw,
        do_wstacking=do_wstacking,
    )


def uv_grids_to_dirty(plan: ImagingPlan, grids: torch.Tensor) -> torch.Tensor:
    """Image-side tail of an invert: inverse FFT of every plane to the
    central npixel^2, w-beam multiply and plane sum, grid correction."""
    npad = plan.npad
    if plan.do_wstacking and plan.nw > 1:
        ctr = extract_mid(ifft(grids), plan.npixel)  # [nw, np, np]
        dirty = torch.sum(ctr.real * plan.wb_r - ctr.imag * plan.wb_i, dim=0)
    else:
        dirty = extract_mid(ifft(grids), plan.npixel).real
    return dirty * float(npad * npad) / plan.corr_c


def image_to_uv_grids(plan: ImagingPlan, image: torch.Tensor) -> torch.Tensor:
    """Image-side head of a predict: grid correction, conjugate w-beam
    multiply, pad and FFT to the w-stacked uv grids."""
    z = (image / plan.corr_c).to(complex_of(image.dtype))
    if plan.do_wstacking and plan.nw > 1:
        zc = z[None] * torch.complex(plan.wb_r, -plan.wb_i).to(z.dtype)
        return fft(pad_mid(zc, plan.npad))
    return fft(pad_mid(z, plan.npad))[None]


def invert_with_plan(
    plan: ImagingPlan, vals, wgt=None, *, values_sorted: bool = False
):
    """Grid + FFT + w-stack tail on a plan. With ``values_sorted=True``
    ``vals`` and ``wgt`` are in plan order. Returns (dirty [npixel,
    npixel] real, sumwt)."""
    weighted = vals if wgt is None else vals * wgt
    grids = grid_with_plan(plan.gp, weighted, values_sorted=values_sorted)
    dirty = uv_grids_to_dirty(plan, grids)
    if wgt is None:
        sumwt = torch.tensor(float(vals.shape[0]), device=vals.device)
    else:
        sumwt = torch.sum(wgt)
    return dirty, sumwt


def predict_with_plan(
    plan: ImagingPlan, image: torch.Tensor, *, to_sorted: bool = False
) -> torch.Tensor:
    """Degrid model-image visibilities on a plan; ``to_sorted=True``
    returns them in plan order."""
    grids = image_to_uv_grids(plan, image)
    return degrid_with_plan(plan.gp, grids, to_sorted=to_sorted)


@dataclass(frozen=True)
class VisibilityImagingPlan:
    """The :class:`ImagingPlan` set for one (Visibility, Image) pair."""

    plans: tuple  # one ImagingPlan per image channel
    support: int
    nw: int
    do_wstacking: bool
    mfs: bool
    npixel: int
    nchan: int


def _nw_for(vis: Visibility, im: Image, do_wstacking: bool, nw=None) -> int:
    """Static w-plane count from the maximum |w| and the field of view (the
    JAX package's heuristic)."""
    if not do_wstacking:
        return 1
    if nw is not None:
        return int(nw)
    wmax = float(
        vis.uvw[..., 2].abs().max().cpu().numpy()
        * vis.frequency.max().cpu().numpy()
        / C_M_S
    )
    fov = im.npixel * im.cellsize
    nw_est = int(np.ceil(4.0 * wmax * fov * fov)) + 1
    return max(2, min(nw_est, 256)) if wmax > 0 else 1


def make_visibility_plan(
    vis: Visibility,
    model: Image,
    context: str = "ng",
    support: int = 8,
    nw: int | None = None,
    **kwargs,
) -> VisibilityImagingPlan:
    """Precompute the gridding geometry for these (vis, model)
    coordinates: the linear-w plan on device coordinates."""
    if context == "awprojection":
        raise ValueError("plans are not supported for awprojection")
    if kwargs.get("coords", "device") != "device":
        raise not_ported("host64 coordinate plans", "S8")
    if model.nchan != 1 or vis.nchan != 1:
        raise not_ported("multi-channel plans", "S10")
    do_wstacking = context != "2d" and kwargs.get("do_wstacking", True)
    nwp = _nw_for(vis, model, do_wstacking, nw)
    uvw_l = vis.uvw_lambda
    plan = make_imaging_plan(
        uvw_l[:, :, 0, 0].reshape(-1),
        uvw_l[:, :, 0, 1].reshape(-1),
        uvw_l[:, :, 0, 2].reshape(-1),
        npixel=model.npixel,
        cellsize=model.cellsize,
        support=support,
        nw=nwp,
        do_wstacking=do_wstacking,
        w_range=kwargs.get("w_range"),
        w_interp=kwargs.get("w_interp", "linear"),
        padding=kwargs.get("padding", 1.25),
    )
    return VisibilityImagingPlan(
        plans=(plan,),
        support=support,
        nw=nwp,
        do_wstacking=do_wstacking,
        mfs=False,
        npixel=model.npixel,
        nchan=1,
    )


def invert_visibility(
    vis: Visibility,
    model: Image,
    dopsf: bool = False,
    normalise: bool = True,
    context: str = "ng",
    support: int = 8,
    nw: int | None = None,
    plan: VisibilityImagingPlan | None = None,
    **kwargs,
):
    """Visibility -> dirty image or PSF on a plan. Returns (Image, sumwt
    [nchan, npol])."""
    if plan is None:
        raise not_ported("invert_visibility without a plan", "S8")
    if kwargs.get("epsilon") is not None:
        raise not_ported("invert_visibility(epsilon=...)", "S8")
    svis = shift_vis_to_image(vis, model, tangent=True, inverse=False)
    ms = convert_pol_frame(
        svis.flagged_vis, vis.polarisation_frame, model.polarisation_frame
    )
    wgt = svis.flagged_imaging_weight
    if dopsf:
        # unit amplitude in the first polarisation only
        ms = torch.zeros_like(ms)
        ms[..., 0] = 1.0
    pixels = torch.zeros_like(model.pixels)
    sumwt = torch.zeros((1, model.npol), dtype=wgt.dtype, device=wgt.device)
    for pol in range(model.npol):
        dirty, swt = invert_with_plan(
            plan.plans[0],
            ms[:, :, 0, pol].reshape(-1),
            wgt[:, :, 0, pol].reshape(-1),
        )
        pixels[0, pol] = dirty.to(pixels.dtype)
        sumwt[0, pol] = swt
    out = model.replace(pixels=pixels)
    if normalise:
        out = normalise_sumwt(out, sumwt)
    return out, sumwt


def create_image_from_visibility(
    vis: Visibility, dtype=None, device=None, **kwargs
) -> Image:
    """Template image from visibility metadata: cellsize from the longest
    baseline over ``oversampling`` (default 3), on the vis device."""
    nchan = kwargs.get("nchan", vis.nchan)
    if nchan != 1:
        raise not_ported("multi-channel images", "S10")
    freq = vis.frequency.cpu().numpy().astype(np.float64)
    frequency = np.array([np.mean(freq)])
    channel_bandwidth = np.array(
        [np.sum(vis.channel_bandwidth.cpu().numpy().astype(np.float64))]
    )
    npixel = int(kwargs.get("npixel", 512))
    cellsize = kwargs.get("cellsize", None)
    if cellsize is None:
        k = np.max(frequency) / C_M_S
        uvmax = float(np.max(np.abs(vis.uvw[..., :2].cpu().numpy())) * k)
        criticalcellsize = 1.0 / (2.0 * uvmax) if uvmax > 0 else 0.001
        cellsize = criticalcellsize / float(kwargs.get("oversampling", 3.0))
    return create_image(
        npixel=npixel,
        cellsize=float(cellsize),
        phasecentre=vis.phasecentre,
        frequency=frequency,
        channel_bandwidth=channel_bandwidth,
        polarisation_frame=kwargs.get(
            "polarisation_frame", vis.polarisation_frame
        ),
        dtype=vis.weight.dtype if dtype is None else dtype,
        device=vis.device if device is None else device,
    )
