"""The GridData API: convolution functions (CF), gridding onto and
degridding from a GridData, weight grids, and AW-projection.

Counterpart of ``ska_sdp_func_python_tpu/ops/griddata_ops.py``. A CF is a
tensor ``[nw, oversampling, oversampling, S, S]``: the kernel of each
w-plane at each sub-cell offset. The JAX package builds it in numpy; the
port builds it with ``torch`` (``torch.fft`` for the w-kernels) in f64 on
the device of its image (``create_pswf_convolutionfunction``, which has no
image, takes ``device``, None for the card). The grid scatters sum in int64
fixed point (``gridding.FixedGrid``): the same bits on every run, on the
card too. The JAX package grids every visibility at once; the port walks
them in chunks of ``_CHUNK`` to bound the ``[chunk, S, S]`` temporaries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import complex_of, resolve_device
from ..models.griddata import GridData
from ..models.image import Image
from ..models.visibility import Visibility
from .fft import fft, ifft
from .gridding import (
    FixedGrid,
    _abs_sum,
    grid_correction,
    grid_weights_nearest,
    reweight_imaging_weights,
)
from .pswf import grdsf, w_beam

__all__ = [
    "convolution_mapping_visibility",
    "spatial_mapping",
    "create_pswf_convolutionfunction",
    "create_awterm_convolutionfunction",
    "create_griddata_from_image",
    "grid_visibility_to_griddata",
    "degrid_visibility_from_griddata",
    "grid_visibility_weight_to_griddata",
    "griddata_merge_weights",
    "griddata_visibility_reweight",
    "fft_griddata_to_image",
    "fft_image_to_griddata",
    "predict_awprojection",
    "invert_awprojection",
]

# visibilities one [chunk, S, S] patch temporary takes
_CHUNK = 131072


def create_griddata_from_image(im: Image, polarisation_frame=None) -> GridData:
    """An empty uv grid of the image's shape, on its device, in the
    complex dtype of its precision."""
    frame = (
        str(getattr(polarisation_frame, "name", polarisation_frame))
        if polarisation_frame is not None
        else im.polarisation_frame
    )
    return GridData(
        pixels=torch.zeros(
            im.pixels.shape, dtype=complex_of(im.pixels.dtype), device=im.device
        ),
        frequency=im.frequency,
        cellsize=im.cellsize,
        polarisation_frame=frame,
    )


def _pswf_rows(support: int, frac: torch.Tensor) -> torch.Tensor:
    """[len(frac), S]: the PSWF (1 - nu^2) grdsf(nu) at cells (j - (half -
    1) - frac), zero for |nu| >= 1, each row normalised to sum 1."""
    half = support // 2
    cells = torch.arange(support, dtype=torch.float64, device=frac.device)
    nu = (cells[None, :] - (half - 1) - frac[:, None]) / half
    vals = (1.0 - nu**2) * grdsf(nu)[0]
    vals = torch.where(nu.abs() >= 1.0, 0.0, vals)
    s = vals.sum(dim=1, keepdim=True)
    return torch.where(s != 0, vals / torch.where(s != 0, s, 1.0), vals)


def create_pswf_convolutionfunction(
    support: int = 8, oversampling: int = 16, nw: int = 1, device=None
) -> torch.Tensor:
    """The oversampled PSWF gridding kernel ``[nw, oversampling,
    oversampling, support, support]`` f64 (every w-plane the same): the
    outer product of the row-normalised 1-D kernels at sub-cell offsets
    k / oversampling."""
    device = resolve_device(device)
    frac = torch.arange(oversampling, dtype=torch.float64, device=device) / oversampling
    k1d = _pswf_rows(support, frac)
    cf = torch.einsum("ay,bx->abyx", k1d, k1d)
    return cf.expand((nw,) + cf.shape).contiguous()


def create_awterm_convolutionfunction(
    im: Image,
    nw: int = 1,
    wstep: float = 0.0,
    oversampling: int = 16,
    support: int = 8,
    use_aaf: bool = True,
):
    """W-dependent (optionally anti-aliased) convolution functions, built
    in f64 on the image's device.

    The kernel of w-plane ``(j - nw // 2) * wstep`` is the Fourier
    transform of the image's w-beam zero-padded ``oversampling`` times
    (``torch.fft``), its central ``support * oversampling`` samples cut
    into the ``oversampling^2`` sub-cell kernels, each normalised to unit
    |sum|; with ``use_aaf`` each is multiplied by the PSWF kernel and
    normalised to sum 1. The w = 0 plane is the PSWF kernel itself.

    Returns (gcf [ny, nx] image-plane correction, cf [nw, ov, ov, S, S])."""
    npixel = im.npixel
    dev = im.device
    base = create_pswf_convolutionfunction(support, oversampling, nw=1, device=dev)[0]
    fov = npixel * im.cellsize
    nsub = support * oversampling
    big = npixel * oversampling
    lo = (big - npixel) // 2
    c = big // 2
    cfs = []
    for j in range(nw):
        w = (j - nw // 2) * wstep
        if w == 0.0:
            cfs.append(base.to(torch.complex128))
            continue
        wb = w_beam(npixel, fov, torch.tensor(w, dtype=torch.float64, device=dev))
        pad = torch.zeros((big, big), dtype=torch.complex128, device=dev)
        pad[lo : lo + npixel, lo : lo + npixel] = wb
        kern = torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(pad)))
        del pad
        patch = kern[c - nsub // 2 : c + nsub // 2, c - nsub // 2 : c + nsub // 2]
        cf_w = patch.reshape(support, oversampling, support, oversampling)
        cf_w = cf_w.permute(1, 3, 0, 2).contiguous()  # [ov, ov, S, S]
        del kern
        norm = cf_w.sum(dim=(2, 3)).abs()[..., None, None]
        cf_w = cf_w / torch.where(norm > 0, norm, 1.0)
        if use_aaf:
            cf_w = cf_w * base
            s = cf_w.sum(dim=(2, 3))[..., None, None]
            cf_w = cf_w / torch.where(s.abs() > 0, s, 1.0)
        cfs.append(cf_w)
    gcf = 1.0 / grid_correction(npixel, support, torch.float64, device=dev)
    return gcf, torch.stack(cfs)


def _pswf_cf_correction(npixel: int, support: int = 8, device=None) -> torch.Tensor:
    """The image-plane response of :func:`create_pswf_convolutionfunction`
    (the DTFT of its zero-offset kernel), clamped at 0.05 against the
    aliased band edge (the AW path grids at image resolution); pass
    ``1 / corr`` as the gcf."""
    half = support // 2
    cells = torch.arange(support, dtype=torch.float64, device=device) - (half - 1)
    vals = _pswf_rows(support, torch.zeros(1, dtype=torch.float64, device=device))[0]
    x = (torch.arange(npixel, dtype=torch.float64, device=device) - npixel // 2) / npixel
    c = torch.sum(vals[None, :] * torch.cos(2.0 * np.pi * x[:, None] * cells[None, :]), dim=1)
    c = torch.clamp(c, min=0.05)
    return torch.outer(c, c)


def _sub_cells(u_pix, v_pix, oversampling: int):
    """(iu, iv, fu, fv): the integer cell and the nearest of
    ``oversampling`` sub-cell offsets of each position (an offset that
    rounds up to a whole cell moves to the next cell)."""
    iu = torch.floor(u_pix).to(torch.int64)
    iv = torch.floor(v_pix).to(torch.int64)
    fu = torch.round((u_pix - iu) * oversampling).to(torch.int64)
    fv = torch.round((v_pix - iv) * oversampling).to(torch.int64)
    iu = torch.where(fu >= oversampling, iu + 1, iu)
    fu = torch.where(fu >= oversampling, 0, fu)
    iv = torch.where(fv >= oversampling, iv + 1, iv)
    fv = torch.where(fv >= oversampling, 0, fv)
    return iu, iv, fu, fv


def _uv_mapping(vis: Visibility, npixel: int, cellsize, oversampling, nw, wstep):
    """Per-(time, baseline, channel) cell, sub-cell offsets and w-plane."""
    scale = npixel * cellsize
    uvw_l = vis.uvw_lambda
    u_pix = -uvw_l[..., 0] * scale + npixel // 2
    v_pix = uvw_l[..., 1] * scale + npixel // 2
    iu, iv, fu, fv = _sub_cells(u_pix, v_pix, oversampling)
    if nw > 1 and wstep > 0:
        pw = torch.clamp(torch.round(uvw_l[..., 2] / wstep).to(torch.int64) + nw // 2, 0, nw - 1)
    else:
        pw = torch.zeros(u_pix.shape, dtype=torch.int64, device=u_pix.device)
    return iu, iv, fu, fv, pw


def _cf_patches(iu, iv, fu, fv, pw, cf, npixel: int):
    """(flat cell index [N, S, S], CF kernels [N, S, S], in-grid mask [N]).
    Indices past the CF's extent are clamped, as the JAX package's gather
    clamps them."""
    support = cf.shape[-1]
    half = support // 2
    i0u = iu - (half - 1)
    i0v = iv - (half - 1)
    ok = (i0u >= 0) & (i0u + support <= npixel) & (i0v >= 0) & (i0v + support <= npixel)
    i0u = torch.clamp(i0u, 0, npixel - support)
    i0v = torch.clamp(i0v, 0, npixel - support)
    cells = torch.arange(support, device=iu.device)
    rows = i0v[:, None, None] + cells[None, :, None]
    cols = i0u[:, None, None] + cells[None, None, :]
    kern = cf[
        torch.clamp(pw, 0, cf.shape[0] - 1),
        torch.clamp(fv, 0, cf.shape[1] - 1),
        torch.clamp(fu, 0, cf.shape[2] - 1),
    ]
    return rows * npixel + cols, kern, ok


def _mapped(vis, griddata, oversampling, nw, wstep):
    """The mapping of every (time, baseline, channel) and a selector of
    the channels image channel ``c`` takes (all of them for an MFS grid)."""
    nchan_g = griddata.pixels.shape[0]
    mfs = nchan_g == 1 and vis.nchan > 1
    maps = _uv_mapping(vis, griddata.npixel, griddata.cellsize, oversampling, nw, wstep)

    def rows(c):
        fsel = slice(None) if mfs else slice(c, c + 1)
        return fsel, [m[:, :, fsel].reshape(-1) for m in maps]

    return rows


def grid_visibility_to_griddata(
    vis: Visibility, griddata: GridData, cf=None, oversampling: int = 16,
    nw: int = 1, wstep: float = 0.0,
):
    """Grid the weighted visibilities onto a GridData with the convolution
    function ``cf`` (None: the support-8 PSWF). Each image channel takes
    its visibility channel (all channels for a one-channel grid of a
    multi-channel Visibility). Returns (GridData, sumwt [nchan, npol]);
    the grid starts from zero."""
    if cf is None:
        cf = create_pswf_convolutionfunction(8, oversampling, nw=max(nw, 1), device=vis.device)
    nchan_g, npol = griddata.pixels.shape[:2]
    npixel = griddata.npixel
    rows = _mapped(vis, griddata, oversampling, nw, wstep)
    vis_w = vis.flagged_vis * vis.flagged_imaging_weight.to(vis.vis.dtype)
    fiw = vis.flagged_imaging_weight
    cf = cf.to(vis.vis.dtype)
    cf_max = torch.view_as_real(cf).abs().sum(dim=-1).amax().to(torch.float64)
    pixels = torch.zeros_like(griddata.pixels)
    sumwt = torch.zeros((nchan_g, npol), dtype=vis.weight.dtype, device=vis.device)
    for ichan in range(nchan_g):
        fsel, (iu, iv, fu, fv, pw) = rows(ichan)
        for pol in range(npol):
            vals = vis_w[:, :, fsel, pol].reshape(-1)
            grid = FixedGrid(npixel * npixel, _abs_sum(vals) * cf_max, vis_w.dtype, vis.device)
            for a in range(0, vals.shape[0], _CHUNK):
                sl = slice(a, a + _CHUNK)
                idx, kern, ok = _cf_patches(iu[sl], iv[sl], fu[sl], fv[sl], pw[sl], cf, npixel)
                grid.add(idx, kern * torch.where(ok, vals[sl], 0.0)[:, None, None])
            pixels[ichan, pol] = grid.value().reshape(npixel, npixel).to(pixels.dtype)
            sumwt[ichan, pol] += fiw[:, :, fsel, pol].sum()
    return griddata.replace(pixels=pixels), sumwt


def degrid_visibility_from_griddata(
    vis: Visibility, griddata: GridData, cf=None, oversampling: int = 16,
    nw: int = 1, wstep: float = 0.0,
) -> Visibility:
    """Degrid visibilities from a GridData: each visibility's patch
    weighted by the conjugate of its CF kernel and summed (the adjoint of
    :func:`grid_visibility_to_griddata`)."""
    if cf is None:
        cf = create_pswf_convolutionfunction(8, oversampling, nw=max(nw, 1), device=vis.device)
    nchan_g, npol = griddata.pixels.shape[:2]
    npixel = griddata.npixel
    rows = _mapped(vis, griddata, oversampling, nw, wstep)
    cf = cf.to(griddata.pixels.dtype)
    newvis = torch.zeros_like(vis.vis)
    for ichan in range(nchan_g):
        fsel, (iu, iv, fu, fv, pw) = rows(ichan)
        shape = vis.vis[:, :, fsel, 0].shape
        for pol in range(npol):
            g = griddata.pixels[ichan, pol].reshape(-1)
            parts = []
            for a in range(0, iu.shape[0], _CHUNK):
                sl = slice(a, a + _CHUNK)
                idx, kern, ok = _cf_patches(iu[sl], iv[sl], fu[sl], fv[sl], pw[sl], cf, npixel)
                vals = (g[idx] * kern.conj()).sum(dim=(1, 2))
                parts.append(torch.where(ok, vals, 0.0))
            newvis[:, :, fsel, pol] += torch.cat(parts).reshape(shape).to(newvis.dtype)
    return vis.replace(vis=newvis)


def _pixels_of(vis: Visibility, griddata: GridData):
    """[N] nearest-cell coordinates of every (time, baseline, channel)."""
    npixel = griddata.npixel
    scale = npixel * griddata.cellsize
    uvw_l = vis.uvw_lambda
    u_pix = (-uvw_l[..., 0] * scale + npixel // 2).reshape(-1)
    v_pix = (uvw_l[..., 1] * scale + npixel // 2).reshape(-1)
    return u_pix, v_pix


def grid_visibility_weight_to_griddata(vis: Visibility, griddata: GridData):
    """The nearest-cell weight density of each polarisation (with the
    conjugate points) in image channel 0. Returns (GridData, sumwt
    [nchan, npol])."""
    u_pix, v_pix = _pixels_of(vis, griddata)
    nchan_g, npol = griddata.pixels.shape[:2]
    pixels = torch.zeros_like(griddata.pixels.real)
    sumwt = torch.zeros((nchan_g, npol), dtype=torch.float64, device=vis.device)
    fw = vis.flagged_weight
    for pol in range(npol):
        density, swt = grid_weights_nearest(
            u_pix, v_pix, fw[..., pol].reshape(-1), griddata.npixel
        )
        pixels[0, pol] += density.to(pixels.dtype)
        sumwt[0, pol] += swt
    return griddata.replace(pixels=pixels.to(griddata.pixels.dtype)), sumwt


def griddata_merge_weights(gd_list):
    """Sum the weight grids and the sums of weights of a list of
    (GridData, sumwt)."""
    gd0, sumwt = gd_list[0]
    pixels = gd0.pixels
    total = torch.as_tensor(sumwt)
    for gd, swt in gd_list[1:]:
        pixels = pixels + gd.pixels
        total = total + torch.as_tensor(swt)
    return gd0.replace(pixels=pixels), total


def griddata_visibility_reweight(
    vis: Visibility,
    griddata: GridData,
    weighting: str = "uniform",
    robustness: float = 0.0,
    sumwt=None,
) -> Visibility:
    """Imaging weights from a gridded weight density (uniform or Briggs
    robust; "natural" keeps the weights)."""
    if weighting == "natural":
        return vis.replace(imaging_weight=vis.weight)
    u_pix, v_pix = _pixels_of(vis, griddata)
    fw = vis.flagged_weight
    new_imwt = torch.zeros_like(fw)
    total = None if sumwt is None else torch.as_tensor(sumwt).sum()
    for pol in range(fw.shape[-1]):
        imwt = reweight_imaging_weights(
            u_pix, v_pix, fw[..., pol].reshape(-1), griddata.pixels[0, pol].real,
            weighting=weighting, robustness=robustness, sumwt=total,
        )
        new_imwt[..., pol] = imwt.reshape(fw.shape[:3]).to(new_imwt.dtype)
    return vis.replace(imaging_weight=new_imwt)


def fft_griddata_to_image(griddata: GridData, template: Image, gcf=None) -> Image:
    """uv grid -> image (npixel^2 times the inverse FFT, its real part),
    times the correction ``gcf``."""
    npixel = griddata.npixel
    img = ((npixel * npixel) * ifft(griddata.pixels)).real
    if gcf is not None:
        img = img * gcf
    return template.replace(pixels=img.to(template.pixels.dtype))


def fft_image_to_griddata(im: Image, griddata: GridData, gcf=None) -> GridData:
    """Image times the correction ``gcf`` -> uv grid (the forward FFT)."""
    pixels = im.pixels
    if gcf is not None:
        pixels = pixels * gcf
    return griddata.replace(pixels=fft(pixels.to(griddata.pixels.dtype)))


def _gcfcf(gcfcf, model: Image):
    if gcfcf is not None:
        return gcfcf
    cf = create_pswf_convolutionfunction(8, 16, 1, device=model.device)
    return 1.0 / _pswf_cf_correction(model.npixel, 8, device=model.device), cf


def invert_awprojection(
    vis: Visibility, model: Image, gcfcf=None, normalise: bool = True,
    **kwargs,
):
    """AW-projection invert with a (gcf, cf) pair (None: the support-8
    PSWF at oversampling 16); ``kwargs`` (``oversampling``, ``wstep``) go
    to :func:`grid_visibility_to_griddata`. Returns (Image, sumwt)."""
    from .imaging import normalise_sumwt, shift_vis_to_image

    gcf, cf = _gcfcf(gcfcf, model)
    svis = shift_vis_to_image(vis, model, tangent=True, inverse=False)
    gd = create_griddata_from_image(model)
    gd, sumwt = grid_visibility_to_griddata(svis, gd, cf=cf, nw=cf.shape[0], **kwargs)
    out = fft_griddata_to_image(gd, model, gcf=gcf)
    if normalise:
        out = normalise_sumwt(out, sumwt)
    return out, sumwt


def predict_awprojection(
    vis: Visibility, model: Image, gcfcf=None, **kwargs
) -> Visibility:
    """AW-projection predict with a (gcf, cf) pair (see
    :func:`invert_awprojection`)."""
    from .imaging import shift_vis_to_image

    gcf, cf = _gcfcf(gcfcf, model)
    gd = fft_image_to_griddata(model, create_griddata_from_image(model), gcf=gcf)
    newvis = degrid_visibility_from_griddata(vis, gd, cf=cf, nw=cf.shape[0], **kwargs)
    return shift_vis_to_image(newvis, model, tangent=True, inverse=True)


def spatial_mapping(
    griddata: GridData, u, v, w, cf=None, oversampling: int = 16,
    nw: int = 1, wstep: float = 0.0,
):
    """Per-row (u, v, w) in wavelengths -> grid coordinates (the grid's WCS
    is the affine u_pix = -u n cellsize + n // 2).

    With a CF: (cell u, sub-cell offset u, cell v, offset v, w-plane, its
    fraction), the oversampling and plane count taken from the CF.
    Without: (nearest cell u, v, and of the conjugate point u, v)."""
    npixel = griddata.npixel
    scale = npixel * griddata.cellsize
    u, v, w = (torch.as_tensor(x) for x in (u, v, w))
    u_pix = -u * scale + npixel // 2
    v_pix = v * scale + npixel // 2
    if cf is None:
        def cell(x):
            return torch.round(x).to(torch.int32)

        return (cell(u_pix), cell(v_pix), cell(u * scale + npixel // 2),
                cell(-v * scale + npixel // 2))
    if hasattr(cf, "shape"):
        nw, oversampling = cf.shape[0], cf.shape[1]
    iu, iv, fu, fv = (x.to(torch.int32) for x in _sub_cells(u_pix, v_pix, oversampling))
    if nw > 1 and wstep > 0.0:
        pw_pix = w / wstep + nw // 2
        pw = torch.clamp(torch.round(pw_pix).to(torch.int32), 0, nw - 1)
        pw_frac = pw_pix - pw
    else:
        pw = torch.zeros(u_pix.shape, dtype=torch.int32, device=u_pix.device)
        pw_frac = torch.zeros_like(u_pix)
    return iu, fu, iv, fv, pw, pw_frac


def convolution_mapping_visibility(
    vis: Visibility, griddata: GridData, chan: int, cf=None, **kwargs
):
    """:func:`spatial_mapping` of one channel's (u, v, w), NaN read as
    zero."""
    uvw_l = vis.uvw_lambda
    u, v, w = (torch.nan_to_num(uvw_l[..., chan, k].reshape(-1)) for k in range(3))
    return spatial_mapping(griddata, u, v, w, cf=cf, **kwargs)
