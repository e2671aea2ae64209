"""Imaging weights from the uv density, and uv tapers.

Counterpart of ``ska_sdp_func_python_tpu/ops/weighting.py``; plain
PyTorch, as the JAX package left the density grid to XLA's scatter. The
density grid sums in int64 fixed point (``gridding.grid_weights_nearest``),
so the weights repeat bit for bit from run to run on the card.
"""

from __future__ import annotations

import math

import torch

from ..models.image import Image
from ..models.visibility import Visibility
from ..utils.arrays import tukey_filter
from .gridding import grid_weights_nearest, reweight_imaging_weights

__all__ = [
    "weight_visibility",
    "taper_visibility_gaussian",
    "taper_visibility_tukey",
]


def weight_visibility(
    vis: Visibility,
    model: Image,
    weighting: str = "uniform",
    robustness: float = 0.0,
    **kwargs,
) -> Visibility:
    """Imaging weights by uv density: each pol's flagged weights go onto
    one nearest-cell density grid of the model's size (with conjugate
    points), then uniform or robust (Briggs, ``robustness``) reweighting;
    "natural" keeps the weights."""
    if weighting == "natural":
        return vis.replace(imaging_weight=vis.weight)
    npixel = model.npixel
    scale = npixel * model.cellsize
    uvw_l = vis.uvw_lambda
    up = (-uvw_l[..., 0] * scale + npixel // 2).reshape(-1)
    vp = (uvw_l[..., 1] * scale + npixel // 2).reshape(-1)
    fw = vis.flagged_weight
    new_imwt = torch.zeros_like(fw)
    for pol in range(fw.shape[-1]):
        wts = fw[..., pol].reshape(-1)
        density, sumwt = grid_weights_nearest(up, vp, wts, npixel)
        imwt = reweight_imaging_weights(
            up, vp, wts, density, weighting=weighting,
            robustness=robustness, sumwt=sumwt,
        )
        new_imwt[..., pol] = imwt.reshape(fw.shape[:-1])
    return vis.replace(imaging_weight=new_imwt)


def taper_visibility_gaussian(vis: Visibility, beam: float) -> Visibility:
    """Gaussian uv taper for a target beam FWHM of ``beam`` radians: the
    imaging weights times exp(-s |uv|^2), s = ln 2 / (4 ln 2 / (pi
    beam))^2, half power at the uv radius 4 ln 2 / (pi beam). Computed in
    f64, as :func:`taper_visibility_tukey`."""
    uvw_l = vis.uvw_lambda.to(torch.float64)
    uvdist2 = uvw_l[..., 0] ** 2 + uvw_l[..., 1] ** 2
    sf = -math.log(0.5) / ((4.0 * math.log(2.0) / (math.pi * beam)) ** 2)
    taper = torch.exp(-sf * uvdist2).to(vis.imaging_weight.dtype)
    return vis.replace(imaging_weight=vis.imaging_weight * taper[..., None])


def taper_visibility_tukey(vis: Visibility, tukey: float = 0.1) -> Visibility:
    """Tukey radial taper of the imaging weights over the uv distance
    normalised by its maximum. Computed in f64 and rounded once to the
    weights' dtype: the card's f32 square root and cosine are not
    correctly rounded, and the taper's slope (pi / tukey) would carry
    their last bits to a few 1e-6 of the CPU's taper."""
    uvw_l = vis.uvw_lambda.to(torch.float64)
    uvdist = torch.sqrt(uvw_l[..., 0] ** 2 + uvw_l[..., 1] ** 2)
    uvdistmax = uvdist.max()
    x = uvdist / torch.where(uvdistmax > 0, uvdistmax, 1.0)
    taper = tukey_filter(x, tukey).to(vis.imaging_weight.dtype)
    return vis.replace(imaging_weight=vis.imaging_weight * taper[..., None])
