"""Hogbom CLEAN (kernel K5).

Counterpart of ``hogbom`` in ``ska_sdp_func_python_tpu/ops/cleaners.py``.
The semantics are kept exactly: the peak of |residual| with ties to the
first index; mval = val * gain / pmax; the PSF subtracted over its
footprint around the peak, clipped at the image edges (overlapIndices);
stop once |val - mval * psf_centre| < 0.9 * absthresh with
absthresh = max(thresh, fracthresh * max|dirty|). Components leave the
loop as [niter, 4] rows (y, x, val, used) and are scattered into the
component image afterwards, as the TPU list kernel does.

On CUDA the whole loop is one kernel (``csrc/hogbom.cu``); on the CPU the
plain version below runs.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import not_ported

__all__ = ["hogbom", "hogbom_lanes", "hogbom_rows_plain"]


def hogbom_rows_plain(
    dirty, psf, *, gain: float, thresh: float, niter: int, fracthresh: float
):
    """Plain version of the K5 loop for one lane: returns ([niter, 4]
    rows (y, x, val, used), residual)."""
    ny, nx = dirty.shape
    py, px = psf.shape
    cy, cx = py // 2, px // 2
    res = dirty.clone()
    rows = torch.zeros((niter, 4), dtype=torch.float32, device=dirty.device)
    pmax = psf.max()
    psf_c = psf[cy, cx]
    absthresh = torch.clamp(fracthresh * dirty.abs().max(), min=thresh)
    stop = 0.9 * absthresh
    for i in range(niter):
        idx = int(torch.argmax(res.abs()))
        my, mx = divmod(idx, nx)
        val = res[my, mx].clone()
        mval = val * gain / pmax
        y0, y1 = max(0, my - cy), min(ny, my - cy + py)
        x0, x1 = max(0, mx - cx), min(nx, mx - cx + px)
        patch = psf[y0 - my + cy : y1 - my + cy, x0 - mx + cx : x1 - mx + cx]
        res[y0:y1, x0:x1] = _fms(res[y0:y1, x0:x1], patch, mval)
        rows[i, 0], rows[i, 1], rows[i, 2], rows[i, 3] = my, mx, mval, 1.0
        if bool(_fms(val, mval, psf_c).abs() < stop):
            break
    return rows, res


def _fms(c, a, b):
    """c - a * b rounded once to f32, as a fused multiply-add rounds it
    (the f32 product is exact in f64). The JAX package's CPU loop gets
    this rounding from XLA's multiply-subtract contraction and the CUDA
    kernel from ``__fmaf_rn``."""
    return (c.double() - a.double() * b.double()).to(torch.float32)


def _rows_to_image(rows, ny, nx):
    """Scatter [lanes, niter, 4] component rows into [lanes, ny, nx]."""
    nl = rows.shape[0]
    lane = torch.arange(nl, device=rows.device)[:, None].expand(
        -1, rows.shape[1]
    )
    vals = torch.where(rows[..., 3] > 0.0, rows[..., 2], 0.0)
    comps = torch.zeros((nl, ny, nx), dtype=torch.float32, device=rows.device)
    comps.index_put_(
        (lane, rows[..., 0].long(), rows[..., 1].long()),
        vals,
        accumulate=True,
    )
    return comps


def hogbom_lanes(
    dirty: torch.Tensor,
    psf: torch.Tensor,
    *,
    gain: float,
    thresh: float,
    niter: int,
    fracthresh: float,
):
    """Hogbom on a batch of independent lanes: dirty ``[lanes, ny, nx]``,
    psf ``[lanes, py, px]`` (f32). Returns (components, residual), both
    ``[lanes, ny, nx]``."""
    nl, ny, nx = dirty.shape
    py, px = psf.shape[-2:]
    if dirty.device.type == "cpu":
        out = [
            hogbom_rows_plain(
                dirty[i], psf[i], gain=gain, thresh=thresh, niter=niter,
                fracthresh=fracthresh,
            )
            for i in range(nl)
        ]
        rows = torch.stack([o[0] for o in out])
        res = torch.stack([o[1] for o in out])
        return _rows_to_image(rows, ny, nx), res
    dev = dirty.device
    chk = kernels.check_cuda_tensor
    if psf.shape[0] != nl or py > 2 * ny or px > 2 * nx:
        raise ValueError(f"psf: shape {tuple(psf.shape)} for {tuple(dirty.shape)}")
    res = torch.empty_like(dirty)
    rows = torch.empty((nl, niter, 4), dtype=torch.float32, device=dev)
    kernels.KERNELS["hogbom"].launch(
        chk("dirty", dirty, torch.float32, dev),
        chk("psf", psf, torch.float32, dev),
        res.data_ptr(),
        rows.data_ptr(),
        nl,
        ny,
        nx,
        py,
        px,
        int(niter),
        float(gain),
        float(thresh),
        float(fracthresh),
    )
    return _rows_to_image(rows, ny, nx), res


def hogbom(
    dirty: torch.Tensor,
    psf: torch.Tensor,
    window=None,
    gain: float = 0.1,
    thresh: float = 0.0,
    niter: int = 100,
    fracthresh: float = 0.01,
):
    """Hogbom CLEAN of one image. Returns (components, residual)."""
    if window is not None:
        raise not_ported("clean windows", "S7x")
    comps, res = hogbom_lanes(
        dirty[None].to(torch.float32).contiguous(),
        psf[None].to(torch.float32).contiguous(),
        gain=gain,
        thresh=thresh,
        niter=niter,
        fracthresh=fracthresh,
    )
    return comps[0], res[0]
