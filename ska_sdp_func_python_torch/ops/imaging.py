"""Imaging: invert and predict between visibilities and images.

Counterpart of ``ska_sdp_func_python_tpu/ops/imaging.py``. Two routes:

- plans (``gridding_plan``, kernels K1-K4): linear or ES-kernel w-stacking
  on a reusable geometry sort, from device coordinates or from host-f64
  ones (split (hi, lo) f32 pairs for an f32 Visibility, f64 coordinates
  for an f64 one); an FFT tail on ``torch.fft`` with the w-beam multiply
  and plane sum over the central ``npixel^2`` only, and the ES grid
  correction. The plans of a Visibility's channels keep what degrid and
  permute read in one stack (``GridPlanStack``), so a cube's predict is
  one batched FFT head, one K3 and one K4 launch;
- the core path (``invert_core``/``predict_core``): one call grids or
  degrids one (channel, polarisation) block, through the tiled gridder
  (``gridding_tiled``, kernel K9) in the precision of its inputs, or
  through a one-shot plan (the "fused" gridder, K1/K3).

``invert_visibility``/``predict_visibility`` take a plan, build one into a
small cache (on the card), or run the core path (on the CPU); with
``epsilon=`` they pick support, padding, w-planes and the route from
``accuracy.gridding_params_for_epsilon``. Sign conventions as in the JAX
package::

    u_pix = -u * npad * cellsize + npad//2
    v_pix = +v * npad * cellsize + npad//2
    dirty(l, m) = sum_k V_k exp(+2 pi i (u l + v m + w (n-1)))
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..config import (
    complex_of,
    not_ported,
    plan_cache_size,
    real_of,
    resolve_device,
)
from ..models.image import Image, create_image
from ..models.polarisation import convert_pol_frame
from ..models.visibility import C_M_S, Visibility
from .accuracy import gridding_params_for_epsilon, nw_for_epsilon
from .fft import extract_mid, fft, ifft, pad_mid
from .gridding import _es_beta, es_kernel, grid_correction
from .gridding_fused import degrid_stack
from .gridding_plan import (
    STACKED,
    GridPlan,
    GridPlanStack,
    degrid_with_plan,
    grid_with_plan,
    make_grid_plan,
    stack_views,
)
from .gridding_tiled import tiled_degrid, tiled_grid
from .permute import permute_apply
from .pswf import w_beam
from .visibility_ops import phaserotate_visibility

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = [
    "shift_vis_to_image",
    "normalise_sumwt",
    "fill_vis_for_psf",
    "visibility_recentre",
    "advise_wide_field",
    "w_kernel_correction",
    "ImagingPlan",
    "make_imaging_plan",
    "invert_with_plan",
    "predict_with_plan",
    "uv_grids_to_dirty",
    "image_to_uv_grids",
    "invert_core",
    "predict_core",
    "VisibilityImagingPlan",
    "make_visibility_plan",
    "image_to_uv_grids_stack",
    "predict_with_stack",
    "invert_visibility",
    "predict_visibility",
    "predict_ng",
    "invert_ng",
    "predict_wg",
    "invert_wg",
    "create_image_from_visibility",
    "rad_deg_arcsec",
]

# entries one unit of the tiled gridder takes. Gridding (one CTA of K9 a
# unit): a cell's f32 sum is a sum within each unit (register runs of at
# most 64 entries, then the shared tile) of sums across the units of its
# segment (global atomics). At the flagship, where one segment holds 3.8M
# entries, 4096 keeps the kernel within 1e-6 of the grid maximum, and its
# f32 plain version too, where 1024 took the plain version to 1.4e-5; the
# kernel's time hardly depends on the unit (unit_tiles_units.py, PERF.md).
# Degridding (dense unit matmuls): every unit is padded to the longest, so
# units stay short.
_UNIT_GRID = 4096
_UNIT_DEGRID = 1024


def shift_vis_to_image(
    vis: Visibility, im: Image, tangent: bool = True, inverse: bool = False
) -> Visibility:
    """Phase-rotate visibilities to the image phase centre."""
    return phaserotate_visibility(
        vis, im.phasecentre, tangent=tangent, inverse=inverse
    )


def rad_deg_arcsec(x) -> str:
    """``x`` in radians written in radians, degrees and arcseconds."""
    return (
        f"{x:.3g} (rad) {180.0 * x / np.pi:.3g} (deg) "
        f"{3600.0 * 180.0 * x / np.pi:.3g} (asec)"
    )


def normalise_sumwt(im: Image, sumwt: torch.Tensor) -> Image:
    """Divide each image plane by its sum of weights."""
    ok = sumwt > 0.0
    scale = torch.where(ok, 1.0 / torch.where(ok, sumwt, 1.0), 0.0)
    return im.replace(pixels=im.pixels * scale[:, :, None, None])


def fill_vis_for_psf(vis: Visibility) -> Visibility:
    """``vis`` with its visibilities set to 1 in the parallel hands and 0
    in the cross hands (at npol 4), or to 1 everywhere."""
    if vis.npol == 4:
        newvis = vis.vis * 0.0  # as the JAX package: a non-finite value stays
        newvis[..., 0] = 1.0
        newvis[..., 3] = 1.0
    else:
        newvis = torch.ones_like(vis.vis)
    return vis.replace(vis=newvis)


def visibility_recentre(uvw, dl, dm):
    """Compensate for w-kernel re-centring: (u, v, w) -> (u - w dl, v - w
    dm, w) over the last axis of ``uvw`` (a tensor, or anything
    ``torch.as_tensor`` takes)."""
    uvw = torch.as_tensor(uvw)
    u = uvw[..., 0] - uvw[..., 2] * dl
    v = uvw[..., 1] - uvw[..., 2] * dm
    return torch.stack([u, v, uvw[..., 2]], dim=-1)


def _w_planes(
    w: torch.Tensor, nw: int, w_interp: str = "linear", w_range=None,
    w_support: int = 8,
):
    """W-plane decomposition: per-vis plane index, fraction (or offset)
    and the plane centres.

    ``"linear"``: the lower of two neighbouring planes and the fraction to
    the upper one. ``"nearest"``: the closest plane, no fraction.
    ``"quadratic"``: the centre plane of a 3-plane Lagrange stencil
    (clipped to [1, nw-2]) and the signed offset. ``"eskernel"``: the
    first of ``w_support`` tap planes and the continuous plane coordinate
    minus it; the plane grid extends ``w_support / 2`` planes beyond
    [wmin, wmax] on each side. ``w_range=(wmin, wmax)`` pins the grid."""
    if w_range is not None:
        wmin = torch.as_tensor(w_range[0], dtype=w.dtype, device=w.device)
        wmax = torch.as_tensor(w_range[1], dtype=w.dtype, device=w.device)
    else:
        wmin, wmax = w.min(), w.max()
    planes = torch.arange(nw, device=w.device).to(w.dtype)
    if w_interp == "eskernel":
        ssw = w_support
        ni = max(nw - ssw, 1)
        rng = wmax - wmin
        wstep = torch.where(rng > 0, rng / max(ni - 1, 1), torch.ones_like(rng))
        w_lo = wmin - (ssw / 2) * wstep
        t = (w - w_lo) / wstep
        j0 = torch.floor(t).to(torch.int32) - (ssw // 2 - 1)
        j0 = torch.clamp(j0, 0, max(nw - ssw, 0))
        return j0, t - j0.to(w.dtype), w_lo + wstep * planes
    # a tensor divisor: on the card a division by a host scalar multiplies
    # by its reciprocal, and a nearest plane would then differ from the CPU's
    wstep = torch.clamp((wmax - wmin) / torch.full_like(wmax, max(nw - 1, 1)), min=1e-30)
    t = (w - wmin) / wstep
    plane_w = wmin + wstep * planes
    if nw <= 1:
        return torch.zeros_like(w, dtype=torch.int32), torch.zeros_like(w), plane_w
    if w_interp == "nearest":
        return torch.clamp(torch.round(t).to(torch.int32), 0, nw - 1), None, plane_w
    if w_interp == "quadratic":
        j = torch.clamp(torch.round(t).to(torch.int32), 1, max(nw - 2, 1))
        return j, t - j, plane_w
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


def _w_order(w_interp: str, support: int) -> int:
    """The tiled gridder's w stencil for ``w_interp``."""
    return {"quadratic": 2, "eskernel": support}.get(w_interp, 1)


def invert_core(
    u,
    v,
    w,
    vals,
    wgt,
    u_lo=None,
    v_lo=None,
    *,
    npixel: int,
    cellsize: float,
    support: int = 8,
    nw: int = 1,
    do_wstacking: bool = True,
    padding=2,
    gridder: str | None = None,
    w_interp: str = "linear",
    prepix: bool = False,
):
    """Grid, FFT and w-stack one (channel, polarisation) block (same
    contract as the JAX package's ``invert_core``).

    ``gridder``: "tiled" (kernel K9, in the dtype of ``u``) or "fused" (a
    one-shot support-8 plan through K1, f32); None picks "tiled" on the
    CPU and "fused" on the card, and the multi-plane w stencils
    (``w_interp`` "quadratic", "eskernel") always take "tiled".
    ``prepix``: ``u``/``v`` are padded-grid pixel coordinates already,
    with optional (hi, lo) residuals ``u_lo``/``v_lo``.

    :param u, v, w: [N] baseline coordinates in wavelengths
    :param vals: [N] complex visibilities
    :param wgt: [N] imaging weights
    :return: (dirty [npixel, npixel] real, sumwt)
    """
    npad = _npad_for(npixel, padding)
    beta = _es_beta(support, npad / npixel)
    gridder = _core_gridder(gridder, w_interp, prepix, vals.device)
    u_pix, v_pix = _pixels(u, v, npad, cellsize, prepix)
    weighted = vals * wgt.to(vals.dtype)
    ts = _tile_for(npad)
    wstack = do_wstacking and nw > 1
    dev, rdtype = u.device, u.dtype
    if wstack:
        p0, frac, plane_w = _w_planes(w, nw, w_interp, w_support=support)
    else:
        p0 = frac = None
    if gridder == "fused":
        gp = make_grid_plan(
            u_pix, v_pix, p0, frac, npixel=npad, support=support,
            nplanes=nw if wstack else 1, tile=ts, beta=beta,
        )
        grids = grid_with_plan(gp, weighted)
    else:
        grids = tiled_grid(
            u_pix, v_pix, weighted, p0, frac, u_lo, v_lo, npixel=npad,
            support=support, nplanes=nw if wstack else 1, tile=ts,
            unit=_UNIT_GRID, beta=beta,
            w_order=_w_order(w_interp, support) if wstack else 1,
        )
    if wstack:
        fov = npad * cellsize
        dirty = torch.zeros((npad, npad), dtype=grids.dtype, device=dev)
        for g, wp in zip(grids, plane_w):
            img = (npad * npad) * ifft(g)
            dirty = dirty + img * w_beam(npad, fov, wp).to(img.dtype)
        dirty = dirty.real
        if w_interp == "eskernel":
            dirty = dirty / w_kernel_correction(
                npad, cellsize, float(plane_w[1] - plane_w[0]), support,
                rdtype, device=dev,
            )
    else:
        dirty = ((npad * npad) * ifft(grids.reshape(npad, npad))).real
    corr = grid_correction(npad, support, rdtype, beta, dev)
    return extract_mid(dirty / corr, npixel), torch.sum(wgt)


def predict_core(
    u,
    v,
    w,
    image,
    u_lo=None,
    v_lo=None,
    *,
    cellsize: float,
    support: int = 8,
    nw: int = 1,
    do_wstacking: bool = True,
    padding=2,
    gridder: str | None = None,
    w_interp: str = "linear",
    prepix: bool = False,
):
    """Degrid visibilities from an image plane: the adjoint of
    :func:`invert_core` (same contract as the JAX package's
    ``predict_core``).

    :param image: [npixel, npixel] real model image
    :return: [N] complex visibilities
    """
    npixel = image.shape[-1]
    npad = _npad_for(npixel, padding)
    beta = _es_beta(support, npad / npixel)
    gridder = _core_gridder(gridder, w_interp, prepix, image.device)
    u_pix, v_pix = _pixels(u, v, npad, cellsize, prepix)
    dev, rdtype = u.device, u.dtype
    corr = grid_correction(npad, support, rdtype, beta, dev)
    img_c = (pad_mid(image, npad) / corr).to(complex_of(image.dtype))
    ts = _tile_for(npad)
    wstack = do_wstacking and nw > 1
    if wstack:
        p0, frac, plane_w = _w_planes(w, nw, w_interp, w_support=support)
        if w_interp == "eskernel":
            img_c = img_c / w_kernel_correction(
                npad, cellsize, float(plane_w[1] - plane_w[0]), support,
                rdtype, device=dev,
            )
        fov = npad * cellsize
        grids = torch.stack([
            fft(img_c * w_beam(npad, fov, wp).conj().to(img_c.dtype))
            for wp in plane_w
        ])
    else:
        p0 = frac = None
        grids = fft(img_c)[None]
    if gridder == "fused":
        gp = make_grid_plan(
            u_pix, v_pix, p0, frac, npixel=npad, support=support,
            nplanes=nw if wstack else 1, tile=ts, beta=beta,
        )
        return degrid_with_plan(gp, grids)
    return tiled_degrid(
        u_pix, v_pix, grids, p0, frac, u_lo, v_lo, support=support,
        nplanes=nw if wstack else 1, tile=ts, unit=_UNIT_DEGRID, beta=beta,
        w_order=_w_order(w_interp, support) if wstack else 1,
    )


def _core_gridder(gridder, w_interp: str, prepix: bool, device) -> str:
    if gridder is None:
        gridder = "tiled" if device.type == "cpu" else "fused"
    if w_interp in ("quadratic", "eskernel"):
        gridder = "tiled"  # the multi-plane stencils live in the tiled path
    if gridder in ("scatter", "gather"):
        raise not_ported(f"the {gridder!r} core gridder", "S11")
    if gridder not in ("tiled", "fused"):
        raise ValueError(f"unknown gridder {gridder!r}")
    if prepix and gridder != "tiled":
        raise ValueError("prepix coordinates need the tiled gridder")
    return gridder


def _pixels(u, v, npad: int, cellsize: float, prepix: bool):
    if prepix:
        return u, v
    scale = npad * cellsize
    return -u * scale + npad // 2, v * scale + npad // 2


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
    # entry copies per visibility: 1 (linear w, 2-d) or w_support // 2
    # (ES-kernel w-gridding plans, see make_imaging_plan)
    ncopies: int = 1


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _es_np(nu, support: int):
    """The ES kernel in numpy f64 at the sigma-2 shape parameter (the
    eskernel plans' w weights)."""
    b = _es_beta(support, 2.0)
    nu2 = np.clip(nu * nu, 0.0, 1.0)
    return np.where(np.abs(nu) < 1.0, np.exp(b * (np.sqrt(1.0 - nu2) - 1.0)), 0.0)


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
    dtype: torch.dtype | None = None,
    device=None,
) -> ImagingPlan:
    """Build a reusable plan for :func:`invert_with_plan` and
    :func:`predict_with_plan` (same contract as the JAX package's
    ``make_imaging_plan``).

    ``u, v, w``: uvw in wavelengths, as tensors (device coordinates, in
    their dtype) or as numpy f64 arrays (host-f64 coordinates, placed on
    ``device``, None: the CUDA card). ``dtype`` is the Visibility's real
    dtype (the JAX package's x64 switch): with host-f64 coordinates and
    f32 (the default) the plan is compensated, its pixel coordinates
    split (hi, lo) f32 pairs computed in f64 on the host; with f64 they
    stay f64. ``w_interp="eskernel"`` (w-stacked, support 8, ``nw >= 10``)
    builds ``support // 2`` entry copies per visibility, copy c covering
    planes (j0 + 2c, j0 + 2c + 1) with the pair's ES weights: the pair
    mass folded into the stored u taps and the w-kernel correction into
    ``corr_c``."""
    host = isinstance(u, np.ndarray)
    if device is None:
        device = resolve_device(None) if host else u.device
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if host else u.dtype
    f64 = dtype == torch.float64
    npad = _npad_for(npixel, padding)
    beta = _es_beta(support, npad / npixel)
    scale = npad * cellsize
    wstack = do_wstacking and nw > 1
    if w_interp == "quadratic" and wstack:
        raise ValueError(
            "quadratic w-interpolation runs on the core path, not on plans"
        )
    compensated = host and not f64
    u_lo = v_lo = taps_scale = None
    ncopies = 1

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    def split(p64):
        hi = p64.astype(np.float32)
        return put(hi, torch.float32), put((p64 - hi).astype(np.float32), torch.float32)

    if w_interp == "eskernel" and wstack:
        if support != 8:
            raise ValueError("eskernel plans need the support-8 tap payload")
        ssw = support
        if nw < ssw + 2:
            raise ValueError(f"eskernel plans need nw >= {ssw + 2}, got {nw}")
        w64 = _host64(w)
        up64 = -_host64(u) * scale + npad // 2
        vp64 = _host64(v) * scale + npad // 2
        if w_range is not None:
            wmin, wmax = float(w_range[0]), float(w_range[1])
        else:
            wmin, wmax = float(w64.min()), float(w64.max())
        rng_w = wmax - wmin
        wstep = rng_w / max(nw - ssw - 1, 1) if rng_w > 0 else 1.0
        w_lo_edge = wmin - (ssw / 2) * wstep
        t = (w64 - w_lo_edge) / wstep
        j0 = np.clip(np.floor(t).astype(np.int32) - (ssw // 2 - 1), 0, nw - ssw)
        ncopies = ssw // 2
        p0_l, frac_l, ts_l = [], [], []
        for c in range(ncopies):
            a = _es_np((j0 + 2 * c - t) / (ssw / 2.0), ssw)
            b = _es_np((j0 + 2 * c + 1 - t) / (ssw / 2.0), ssw)
            m = a + b
            p0_l.append(j0 + 2 * c)
            frac_l.append(b / np.where(m > 0, m, 1.0))
            ts_l.append(m)
        up_t, vp_t = np.tile(up64, ncopies), np.tile(vp64, ncopies)
        if f64:
            u_pix, v_pix = put(up_t, torch.float64), put(vp_t, torch.float64)
        else:
            (u_pix, u_lo), (v_pix, v_lo) = split(up_t), split(vp_t)
        p0 = put(np.concatenate(p0_l), torch.int32)
        frac = put(np.concatenate(frac_l).astype(np.float32), torch.float32)
        taps_scale = put(np.concatenate(ts_l).astype(np.float32), torch.float32)
        plane_w = put((w_lo_edge + wstep * np.arange(nw)).astype(np.float32), torch.float32)
        nplanes = nw
    elif compensated:
        (u_pix, u_lo) = split(-_host64(u) * scale + npad // 2)
        (v_pix, v_lo) = split(_host64(v) * scale + npad // 2)
        if wstack:
            # the w-plane split on the host in f64
            w64 = _host64(w)
            if w_range is not None:
                wmin, wmax = float(w_range[0]), float(w_range[1])
            else:
                wmin, wmax = float(w64.min()), float(w64.max())
            wstep = max((wmax - wmin) / max(nw - 1, 1), 1e-30)
            t = (w64 - wmin) / wstep
            plane_w = put((wmin + wstep * np.arange(nw)).astype(np.float32), torch.float32)
            if w_interp == "nearest":
                p0 = put(np.clip(np.round(t).astype(np.int32), 0, nw - 1), torch.int32)
                frac = None
            else:
                p0n = np.clip(np.floor(t).astype(np.int32), 0, nw - 2)
                p0 = put(p0n, torch.int32)
                frac = put(np.clip(t - p0n, 0.0, 1.0).astype(np.float32), torch.float32)
            nplanes = nw
    else:
        if host:
            u, v, w = (put(a, dtype) for a in (u, v, w))
        u_pix = -u * scale + npad // 2
        v_pix = v * scale + npad // 2
        if wstack:
            p0, frac, plane_w = _w_planes(w, nw, w_interp, w_range=w_range)
            nplanes = nw
    if not wstack:
        p0 = frac = None
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
        u_lo=u_lo,
        v_lo=v_lo,
        taps_scale=taps_scale,
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
    )
    if ncopies > 1:
        corr_c = corr_c * extract_mid(
            w_kernel_correction(
                npad, cellsize, wstep, support, torch.float32, device=device
            ),
            npixel,
        )
    return ImagingPlan(
        gp=gp,
        plane_w=plane_w,
        wb_r=wb_r,
        wb_i=wb_i,
        corr_c=corr_c.contiguous(),
        npixel=npixel,
        npad=npad,
        cellsize=float(cellsize),
        support=support,
        nw=nw,
        do_wstacking=do_wstacking,
        ncopies=ncopies,
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
    if plan.ncopies > 1:
        # eskernel plan: the per-copy ES pair weights live in the taps
        if values_sorted:
            raise ValueError("values_sorted is not supported on eskernel plans")
        weighted = weighted.repeat(plan.ncopies)
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
    vals = degrid_with_plan(plan.gp, grids, to_sorted=to_sorted)
    if plan.ncopies > 1:
        if to_sorted:
            raise ValueError("to_sorted is not supported on eskernel plans")
        # the per-copy ES-weighted plane-pair contributions
        vals = vals.reshape(plan.ncopies, -1).sum(dim=0)
    return vals


@dataclass(frozen=True)
class VisibilityImagingPlan:
    """The :class:`ImagingPlan` set for one (Visibility, Image) pair. With
    one entry copy per visibility (every plan but eskernel's), ``stack``
    holds the channel plans' degrid and permute arrays stacked (each
    plan's are views into it) and ``corr_c``, ``wb_r`` and ``wb_i`` the
    channels' image-side arrays ``[nchan, ...]`` (each plan's, views)."""

    plans: tuple  # one ImagingPlan per image channel
    support: int
    nw: int
    do_wstacking: bool
    mfs: bool
    npixel: int
    nchan: int
    stack: GridPlanStack | None = None
    corr_c: torch.Tensor | None = None  # [nchan, npixel, npixel]
    wb_r: torch.Tensor | None = None  # [nchan, nw, npixel, npixel]
    wb_i: torch.Tensor | None = None


def image_to_uv_grids_stack(
    plan: VisibilityImagingPlan, images: torch.Tensor
) -> torch.Tensor:
    """:func:`image_to_uv_grids` of every channel of a stacked plan set at
    once: ``images`` [nchan, npixel, npixel] -> [nchan, nplanes, npad,
    npad] (one batched FFT)."""
    p0 = plan.plans[0]
    z = (images / plan.corr_c).to(complex_of(images.dtype))
    if p0.do_wstacking and p0.nw > 1:
        zc = z[:, None] * torch.complex(plan.wb_r, -plan.wb_i).to(z.dtype)
        return fft(pad_mid(zc, p0.npad))
    return fft(pad_mid(z, p0.npad))[:, None]


def predict_with_stack(
    plan: VisibilityImagingPlan, images: torch.Tensor, *, to_sorted: bool = False
) -> torch.Tensor:
    """:func:`predict_with_plan` of every channel of a stacked plan set:
    ``images`` [nchan, npixel, npixel] -> [nchan, n] complex64 (each
    channel in its plan's order with ``to_sorted=True``), through one
    batched FFT head, one degrid launch (K3) and, for natural order, one
    permute launch (K4)."""
    st = plan.stack
    if st is None:
        raise ValueError("the plan set has no channel stack (eskernel plans)")
    grids = image_to_uv_grids_stack(plan, images)
    vals = degrid_stack(st, grids.to(torch.complex64).contiguous())
    return vals if to_sorted else permute_apply(st.iperm, vals)


def _nw_for(
    vis: Visibility, im: Image, do_wstacking: bool, nw=None, wmax=None
) -> int:
    """Static w-plane count from the maximum |w| and the field of view (the
    JAX package's heuristic). ``wmax`` (wavelengths) overrides the
    maximum of ``vis``: the streamed cycle passes the observation's, so
    every slab stacks onto the same planes."""
    if not do_wstacking:
        return 1
    if nw is not None:
        return int(nw)
    if wmax is None:
        wmax = float(
            vis.uvw[..., 2].abs().max().cpu().numpy()
            * vis.frequency.max().cpu().numpy()
            / C_M_S
        )
    fov = im.npixel * im.cellsize
    nw_est = int(np.ceil(4.0 * wmax * fov * fov)) + 1
    return max(2, min(nw_est, 256)) if wmax > 0 else 1


def _nw_wkernel_for(vis: Visibility, model: Image, support: int):
    """Plane count of ES-kernel w-gridding: plane spacing 1 / (2 sigma_w
    numax), sigma_w = 2, numax = |n - 1| at the image corner, plus
    ``support`` margin planes."""
    wl = _host64(vis.uvw)[..., 2:3] * (_host64(vis.frequency) / C_M_S)
    wmin, wmax = float(wl.min()), float(wl.max())
    fov = model.npixel * float(model.cellsize)
    numax = 1.0 - math.sqrt(max(0.0, 1.0 - min(1.0, 2 * (fov / 2) ** 2)))
    if numax <= 0.0 or wmax <= wmin:
        return support + 2
    dw = 1.0 / (4.0 * numax)
    return int(math.ceil((wmax - wmin) / dw)) + 1 + support


def _is_f64(vis: Visibility) -> bool:
    return real_of(vis.vis.dtype) == torch.float64


def _prepix_rows(vis: Visibility, model: Image, fsel, npad: int):
    """Host-f64 padded-grid pixel coordinates of the core path's epsilon
    rows: (u, u_lo, v, v_lo, w). An f64 Visibility gets f64 coordinates
    (lo None); an f32 one split (hi, lo) f32 pairs that the tiled kernel
    recombines after the small hi difference."""
    uvw = _host64(vis.uvw)
    f = _host64(vis.frequency)[fsel] / C_M_S
    scale = npad * float(model.cellsize)
    up = (-uvw[..., 0:1] * f * scale + npad // 2).reshape(-1)
    vp = (uvw[..., 1:2] * f * scale + npad // 2).reshape(-1)
    wl = (uvw[..., 2:3] * f).reshape(-1)

    def put(a, dt):
        return torch.as_tensor(a, device=vis.device).to(dt)

    if _is_f64(vis):
        return put(up, torch.float64), None, put(vp, torch.float64), None, put(wl, torch.float64)
    uh, vh = up.astype(np.float32), vp.astype(np.float32)
    f32 = torch.float32
    return (
        put(uh, f32), put((up - uh).astype(np.float32), f32),
        put(vh, f32), put((vp - vh).astype(np.float32), f32),
        put(wl.astype(np.float32), f32),
    )


def make_visibility_plan(
    vis: Visibility,
    model: Image,
    context: str = "ng",
    support: int = 8,
    nw: int | None = None,
    **kwargs,
) -> VisibilityImagingPlan:
    """Precompute the gridding geometry for these (vis, model)
    coordinates: one plan per image channel, each from the visibility
    channel of the same index, or, for an image of one channel from
    several visibility channels (multi-frequency synthesis, ``mfs``), one
    plan over all of them, its entries in the (time, baseline, channel)
    order of the visibilities, each at its channel's frequency.
    ``coords="host64"`` computes the pixel
    coordinates in f64 on the host (compensated (hi, lo) pairs for an f32
    Visibility, f64 for an f64 one); ``w_interp`` "linear" (default) or
    "eskernel"; ``padding`` defaults to 1.25."""
    if context == "awprojection":
        raise ValueError("plans are not supported for awprojection")
    mfs = model.nchan == 1 and vis.nchan > 1
    if model.nchan > vis.nchan:
        raise ValueError(
            f"{model.nchan} image channels for {vis.nchan} visibility channels"
        )
    do_wstacking = context != "2d" and kwargs.get("do_wstacking", True)
    nwp = _nw_for(vis, model, do_wstacking, nw)
    coords = kwargs.get("coords", "device")
    if coords == "host64":
        uvw_l = np.einsum(
            "tbs,f->tbfs", _host64(vis.uvw), _host64(vis.frequency) / C_M_S
        )
    elif coords == "device":
        uvw_l = vis.uvw_lambda
    else:
        raise ValueError(f"coords must be 'device' or 'host64', got {coords!r}")
    nchan = model.nchan
    plans, store, tails = [], {}, {}
    for c in range(nchan):
        fsel = slice(None) if mfs else slice(c, c + 1)
        ip = make_imaging_plan(
            uvw_l[:, :, fsel, 0].reshape(-1),
            uvw_l[:, :, fsel, 1].reshape(-1),
            uvw_l[:, :, fsel, 2].reshape(-1),
            npixel=model.npixel,
            cellsize=model.cellsize,
            support=support,
            nw=nwp,
            do_wstacking=do_wstacking,
            w_range=kwargs.get("w_range"),
            w_interp=kwargs.get("w_interp", "linear"),
            padding=kwargs.get("padding", 1.25),
            dtype=vis.uvw.dtype,
            device=vis.device,
        )
        if ip.ncopies == 1:
            # each channel's arrays move into the stack as it is built, so
            # the plan set is never held twice
            gp = dataclasses.replace(ip.gp, **stack_views(
                store, nchan, c, ip.gp.n, **{k: getattr(ip.gp, k) for k in STACKED}
            ))
            ip = dataclasses.replace(ip, gp=gp, **stack_views(
                tails, nchan, c,
                **{k: getattr(ip, k) for k in ("corr_c", "wb_r", "wb_i")
                   if getattr(ip, k) is not None},
            ))
        plans.append(ip)
    return VisibilityImagingPlan(
        plans=tuple(plans),
        support=support,
        nw=nwp,
        do_wstacking=do_wstacking,
        mfs=mfs,
        npixel=model.npixel,
        nchan=nchan,
        stack=GridPlanStack.of(store, [p.gp for p in plans]) if store else None,
        **tails,
    )


# Plans that invert_visibility/predict_visibility build when no plan is
# passed (on the card by default): keyed on the identity of the
# Visibility's uvw and frequency tensors, held with strong references so
# the identities stay valid, least recently used first out.
_PLAN_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def _auto_plan(
    vis: Visibility, model: Image, support: int, nwp: int,
    do_wstacking: bool, padding, coords: str = "device",
    w_interp: str = "linear",
) -> VisibilityImagingPlan | None:
    size = plan_cache_size()
    if size <= 0 or w_interp not in ("linear", "nearest", "eskernel"):
        return None
    key = (
        id(vis.uvw), id(vis.frequency), tuple(vis.uvw.shape),
        model.npixel, float(model.cellsize), model.nchan, vis.nchan,
        int(support), int(nwp), bool(do_wstacking), padding, coords,
        w_interp,
    )
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        uvw_ref, freq_ref, plan = hit
        if uvw_ref is vis.uvw and freq_ref is vis.frequency:
            _PLAN_CACHE.move_to_end(key)
            return plan
        del _PLAN_CACHE[key]  # an id reused after collection
    # padding 2 gives the core path's numbers; callers who want the
    # faster 1.25 pass padding= (make_visibility_plan defaults to it)
    plan = make_visibility_plan(
        vis, model, context="ng" if do_wstacking else "2d",
        support=support, nw=nwp, do_wstacking=do_wstacking,
        padding=2 if padding is None else padding,
        coords=coords, w_interp=w_interp,
    )
    _PLAN_CACHE[key] = (vis.uvw, vis.frequency, plan)
    while len(_PLAN_CACHE) > size:
        _PLAN_CACHE.popitem(last=False)
    return plan


def _check_plan(plan: VisibilityImagingPlan, model: Image, mfs: bool) -> None:
    if plan.nchan != model.nchan or plan.npixel != model.npixel or plan.mfs != mfs:
        raise ValueError(
            f"plan for {plan.nchan} channels of {plan.npixel}^2 (mfs "
            f"{plan.mfs}), image {tuple(model.pixels.shape)} (mfs {mfs})"
        )


def _route(vis, model, context, support, nw, plan, kwargs):
    """The keywords both entry points share: ``epsilon=`` resolved into
    support, padding, plane count, w stencil and route (the JAX package's
    routing), the plan (passed, cached or None) and the w-plane count.
    Returns (support, nwp, do_wstacking, plan, kwargs)."""
    if context == "awprojection":
        raise not_ported("the awprojection context", "S11")
    if kwargs.get("tail", "fft") not in (None, "fft"):
        raise ValueError("the port has one image tail, 'fft'")
    do_wstacking = context != "2d" and kwargs.get("do_wstacking", True)
    if kwargs.get("epsilon") is not None:
        acc = gridding_params_for_epsilon(
            kwargs.pop("epsilon"), do_wstacking=do_wstacking, f64=_is_f64(vis)
        )
        support = acc.support
        kwargs["padding"] = acc.padding
        if do_wstacking:
            if acc.w_interp == "eskernel":
                nw = _nw_wkernel_for(vis, model, acc.support)
            else:
                nw = nw_for_epsilon(
                    _nw_for(vis, model, do_wstacking, nw), acc.epsilon,
                    acc.w_interp,
                )
        if acc.w_interp != "linear":
            kwargs["w_interp"] = acc.w_interp
        plan_capable = (
            acc.gridder is None
            and acc.w_interp == "eskernel"
            and acc.support == 8
            and do_wstacking
            and nw is not None
            and nw >= acc.support + 2
        )
        if plan_capable:
            # the f32 rows on an eskernel plan: K1/K3 with support // 2
            # entry copies and the ES pair weights in the taps
            kwargs["coords"] = "host64"
            # without a plan (the CPU, auto_plan=False) an f32 Visibility
            # takes the tiled core path from the same host-f64 (hi, lo)
            # coordinates: from f32 device coordinates it would miss the
            # row's floor (an f64 one keeps its f64 coordinates, as the
            # JAX package under x64)
            kwargs["prepix"] = not _is_f64(vis)
        elif acc.gridder is not None or acc.w_interp == "eskernel":
            # the deep f64 rows (and 2-d eskernel) run the tiled core path
            plan, kwargs["auto_plan"] = None, False
            kwargs["gridder"] = acc.gridder or "tiled"
            if acc.coords == "host64":
                kwargs["prepix"] = True
        else:
            kwargs["coords"] = acc.coords
    nwp = _nw_for(vis, model, do_wstacking, nw)
    if plan is None and kwargs.get("auto_plan", vis.device.type != "cpu"):
        plan = _auto_plan(
            vis, model, support, nwp, do_wstacking, kwargs.get("padding"),
            kwargs.get("coords", "device"), kwargs.get("w_interp", "linear"),
        )
    return support, nwp, do_wstacking, plan, kwargs


def _core_rows(vis: Visibility, model: Image, uvw_l, fsel, kwargs):
    """(u, u_lo, v, v_lo, w) of the channels ``fsel`` for the core path."""
    if kwargs.get("prepix"):
        npad = _npad_for(model.npixel, kwargs.get("padding") or 2)
        return _prepix_rows(vis, model, fsel, npad)
    return (
        uvw_l[:, :, fsel, 0].reshape(-1), None,
        uvw_l[:, :, fsel, 1].reshape(-1), None,
        uvw_l[:, :, fsel, 2].reshape(-1),
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
    """Visibility -> dirty image or PSF. Returns (Image, sumwt [nchan,
    npol]).

    Contexts "2d" (no w-correction) and "ng"/"wg" (w-stacking). With
    ``plan`` (from :func:`make_visibility_plan`) the geometry is reused;
    without one, a Visibility on the card builds one into a small cache
    (``auto_plan``, default on for the card and off on the CPU, where the
    core path runs). ``epsilon=`` picks support, padding, w-planes,
    coordinate mode and route from :mod:`.accuracy` and raises when the
    tolerance cannot be met (below the f32 floor with an f32
    Visibility)."""
    support, nwp, do_wstacking, plan, kwargs = _route(
        vis, model, context, support, nw, plan, dict(kwargs)
    )
    nchan_img, npol_img = model.nchan, model.npol
    mfs = nchan_img == 1 and vis.nchan > 1
    if plan is not None:
        _check_plan(plan, model, mfs)
    svis = shift_vis_to_image(vis, model, tangent=True, inverse=False)
    ms = convert_pol_frame(
        svis.flagged_vis, vis.polarisation_frame, model.polarisation_frame
    )
    wgt = svis.flagged_imaging_weight
    if wgt.shape[-1] != ms.shape[-1]:
        # the conversion changed the polarisation count: the first
        # polarisation's weights serve every one
        wgt = wgt[..., :1].expand(ms.shape)
    if dopsf:
        # unit amplitude in the first polarisation only
        ms = torch.zeros_like(ms)
        ms[..., 0] = 1.0
    uvw_l = svis.uvw_lambda if plan is None else None
    pixels = torch.zeros_like(model.pixels)
    sumwt = torch.zeros(
        (nchan_img, npol_img), dtype=wgt.dtype, device=wgt.device
    )
    for chan in range(nchan_img):
        fsel = slice(None) if mfs else slice(chan, chan + 1)
        if plan is None:
            uu, ulo, vv, vlo, ww = _core_rows(svis, model, uvw_l, fsel, kwargs)
        for pol in range(npol_img):
            vals = ms[:, :, fsel, pol].reshape(-1)
            wv = wgt[:, :, fsel, pol].reshape(-1)
            if plan is not None:
                dirty, swt = invert_with_plan(plan.plans[chan], vals, wv)
            else:
                dirty, swt = invert_core(
                    uu, vv, ww, vals, wv, ulo, vlo,
                    npixel=model.npixel,
                    cellsize=model.cellsize,
                    support=support,
                    nw=nwp,
                    do_wstacking=do_wstacking,
                    padding=kwargs.get("padding") or 2,
                    gridder=kwargs.get("gridder"),
                    w_interp=kwargs.get("w_interp", "linear"),
                    prepix=bool(kwargs.get("prepix")),
                )
            pixels[chan, pol] = dirty.to(pixels.dtype)
            sumwt[chan, pol] = swt
    out = model.replace(pixels=pixels)
    if normalise:
        out = normalise_sumwt(out, sumwt)
    return out, sumwt


def predict_visibility(
    vis: Visibility,
    model: Image,
    context: str = "ng",
    support: int = 8,
    nw: int | None = None,
    plan: VisibilityImagingPlan | None = None,
    **kwargs,
) -> Visibility:
    """Model image -> visibilities. Each image channel degrids into the
    visibility channel of the same index (an image of one channel, into
    all of them: multi-frequency synthesis). Plans, the cache and
    ``epsilon=`` as in :func:`invert_visibility`. Returns ``vis`` with
    its ``vis`` replaced."""
    support, nwp, do_wstacking, plan, kwargs = _route(
        vis, model, context, support, nw, plan, dict(kwargs)
    )
    nchan_img, npol_img = model.nchan, model.npol
    mfs = nchan_img == 1 and vis.nchan > 1
    if plan is not None:
        _check_plan(plan, model, mfs)
    uvw_l = vis.uvw_lambda if plan is None else None
    cdtype = complex_of(vis.vis.dtype)
    newvis = torch.zeros(
        vis.vis.shape[:3] + (npol_img,), dtype=cdtype, device=vis.device
    )
    if plan is not None and plan.stack is not None:
        # every channel in one batched head, degrid and permute
        ntime, nbl, nvchan = newvis.shape[:3]
        for pol in range(npol_img):
            vals = predict_with_stack(plan, model.pixels[:, pol])
            if mfs:
                # the one plan's stream is in (time, baseline, channel) order
                newvis[..., pol] = vals.reshape(ntime, nbl, nvchan).to(cdtype)
            else:
                newvis[:, :, :nchan_img, pol] = (
                    vals.reshape(nchan_img, ntime, nbl).permute(1, 2, 0).to(cdtype)
                )
    else:
        for chan in range(nchan_img):
            fsel = slice(None) if mfs else slice(chan, chan + 1)
            tb_shape = newvis[:, :, fsel, 0].shape
            if plan is None:
                uu, ulo, vv, vlo, ww = _core_rows(vis, model, uvw_l, fsel, kwargs)
            for pol in range(npol_img):
                if plan is not None:
                    vals = predict_with_plan(plan.plans[chan], model.pixels[chan, pol])
                else:
                    vals = predict_core(
                        uu, vv, ww, model.pixels[chan, pol], ulo, vlo,
                        cellsize=model.cellsize,
                        support=support,
                        nw=nwp,
                        do_wstacking=do_wstacking,
                        padding=kwargs.get("padding") or 2,
                        gridder=kwargs.get("gridder"),
                        w_interp=kwargs.get("w_interp", "linear"),
                        prepix=bool(kwargs.get("prepix")),
                    )
                newvis[:, :, fsel, pol] += vals.reshape(tb_shape).to(cdtype)
    newvis = convert_pol_frame(
        newvis, model.polarisation_frame, vis.polarisation_frame
    )
    out = vis.replace(vis=newvis.to(vis.vis.dtype))
    return shift_vis_to_image(out, model, tangent=True, inverse=True)


def predict_ng(bvis, model, **kwargs):
    """The reference's nifty-gridder predict name."""
    kwargs.pop("context", None)
    return predict_visibility(bvis, model, context="ng", **kwargs)


def invert_ng(bvis, model, dopsf=False, normalise=True, **kwargs):
    """The reference's nifty-gridder invert name."""
    kwargs.pop("context", None)
    return invert_visibility(
        bvis, model, dopsf=dopsf, normalise=normalise, context="ng", **kwargs
    )


def predict_wg(bvis, model, **kwargs):
    """The reference's GPU-gridder predict name."""
    kwargs.pop("context", None)
    return predict_visibility(bvis, model, context="wg", **kwargs)


def invert_wg(bvis, model, dopsf=False, normalise=True, **kwargs):
    """The reference's GPU-gridder invert name."""
    kwargs.pop("context", None)
    return invert_visibility(
        bvis, model, dopsf=dopsf, normalise=normalise, context="wg", **kwargs
    )


def advise_wide_field(
    vis: Visibility,
    delA: float = 0.02,
    oversampling_synthesised_beam: float = 3.0,
    guard_band_image: float = 6.0,
    facets: int = 1,
    verbose: bool = False,
) -> dict:
    """Advice on imaging parameters, computed on the host in f64 with the
    JAX package's keys and formulas: wavelength and uv extrema, the
    primary-beam, image and facet fields of view, synthesised beam,
    cellsize, pixel counts rounded to 2-, {2,3}- and {2,3,4,5}-smooth
    sizes, w, time and frequency sampling at the image, facet and
    primary-beam scales, and the w-stack and w-projection plane counts at
    the image and primary-beam fields of view. The station diameter is
    the Visibility's ``station_diameter``."""
    freq = vis.frequency.detach().cpu().numpy().astype(np.float64)
    max_wavelength = C_M_S / np.min(freq)
    min_wavelength = C_M_S / np.max(freq)
    uvw = _host64(vis.uvw)
    maximum_baseline = np.max(np.abs(uvw)) / min_wavelength if uvw.size else 1.0
    maximum_w = np.max(np.abs(uvw[..., 2])) / min_wavelength
    if maximum_baseline <= 0.0:
        raise ValueError("Error in UVW coordinates: all uvw are zero")
    diameter = float(getattr(vis, "station_diameter", 35.0) or 35.0)
    if diameter <= 0.0:
        raise ValueError("Station/dish diameter must be greater than zero")
    primary_beam_fov = max_wavelength / diameter
    image_fov = primary_beam_fov * guard_band_image
    facet_fov = image_fov / facets if facets > 1 else image_fov
    synthesized_beam = 1.0 / maximum_baseline
    cellsize = synthesized_beam / oversampling_synthesised_beam

    def pwr2(n):
        return int(2 ** int(np.ceil(np.log(n) / np.log(2.0))))

    def pwr23(n):
        best = pwr2(n)
        return best * 3 // 4 if best * 3 // 4 >= n else best

    def pwr2345(n):
        number = np.array([2, 3, 4, 5])
        ex = np.ceil(np.log(n) / np.log(number)).astype("int")
        return int(min(np.power(number[:], ex[:])))

    npixels = int(round(image_fov / cellsize))
    # Cornwell, Humphreys & Voronkov (2012) eq. 24
    def w_sampling(fov):
        return np.sqrt(2.0 * delA) / (np.pi * fov**2)

    w_sampling_image = w_sampling(image_fov)
    w_sampling_facet = w_sampling(facet_fov) if facets > 1 else w_sampling_image
    w_sampling_primary_beam = w_sampling(primary_beam_fov)
    max_freq = np.max(freq)

    def planes(wstep, fov):
        slices = max(1, int(2 * maximum_w / wstep))
        npix = int(2.0 * slices * fov)
        return slices, npix - npix % 2

    vis_slices_primary_beam, nwpixels_primary_beam = planes(
        w_sampling_primary_beam, primary_beam_fov
    )
    vis_slices_image, nwpixels_image = planes(w_sampling_image, image_fov)
    advice = {
        "delA": delA,
        "oversampling_synthesised_beam": oversampling_synthesised_beam,
        "guard_band_image": guard_band_image,
        "facets": facets,
        "verbose": verbose,
        "max_wavelength": max_wavelength,
        "min_wavelength": min_wavelength,
        "maximum_baseline": maximum_baseline,
        "maximum_w": maximum_w,
        "diameter": diameter,
        "primary_beam_fov": primary_beam_fov,
        "image_fov": image_fov,
        "facet_fov": facet_fov,
        "synthesized_beam": synthesized_beam,
        "cellsize": cellsize,
        "npixels": npixels,
        "npixels2": pwr2(npixels),
        "npixels23": pwr23(npixels),
        "npixels_min": pwr2345(npixels),
        "w_sampling_image": w_sampling_image,
        "w_sampling_facet": w_sampling_facet,
        "w_sampling_primary_beam": w_sampling_primary_beam,
        "time_sampling_image": 86400.0 * (synthesized_beam / image_fov),
        "time_sampling_primary_beam": 86400.0 * (synthesized_beam / primary_beam_fov),
        "max_freq": max_freq,
        "freq_sampling_image": max_freq * (synthesized_beam / image_fov),
        "freq_sampling_primary_beam": max_freq * (synthesized_beam / primary_beam_fov),
        "wstep_primary_beam": w_sampling_primary_beam,
        "vis_slices_primary_beam": vis_slices_primary_beam,
        "wprojection_planes_primary_beam": vis_slices_primary_beam,
        "nwpixels_primary_beam": nwpixels_primary_beam,
        "wstep_image": w_sampling_image,
        "vis_slices_image": vis_slices_image,
        "wprojection_planes_image": vis_slices_image,
        "nwpixels_image": nwpixels_image,
        # the JAX package's aliases: the primary-beam advice
        "wstep": w_sampling_primary_beam,
        "vis_slices": vis_slices_primary_beam,
    }
    if verbose:
        for k, v in advice.items():
            log.info("advise_wide_field: (%s) %s", k, v)
    return advice


def create_image_from_visibility(
    vis: Visibility, dtype=None, device=None, **kwargs
) -> Image:
    """Template image from visibility metadata, on the vis device: one
    channel at the mean frequency over the whole band (``nchan=1``), or
    the first ``nchan`` visibility channels (default: all of them);
    cellsize from the longest baseline at the highest image frequency over
    ``oversampling`` (default 3)."""
    nchan = int(kwargs.get("nchan", vis.nchan))
    freq = np.asarray(
        kwargs.get("frequency", vis.frequency.cpu().numpy()), np.float64
    )
    bandwidth = vis.channel_bandwidth.cpu().numpy().astype(np.float64)
    if nchan == 1:
        frequency = np.array([np.mean(freq)])
        channel_bandwidth = np.array([np.sum(bandwidth)])
    else:
        frequency = freq[:nchan]
        channel_bandwidth = bandwidth[:nchan]
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
