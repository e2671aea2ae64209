"""Imaging weights from the uv density.

Counterpart of ``weight_visibility`` in
``ska_sdp_func_python_tpu/ops/weighting.py``; plain PyTorch, as the JAX
package left the density grid to XLA's scatter.
"""

from __future__ import annotations

import torch

from ..config import not_ported
from ..models.image import Image
from ..models.visibility import Visibility
from .gridding import grid_weights_nearest, reweight_imaging_weights

__all__ = ["weight_visibility"]


def weight_visibility(
    vis: Visibility,
    model: Image,
    weighting: str = "uniform",
) -> Visibility:
    """Imaging weights by uv density: every pol's flagged weights go onto
    one nearest-cell density grid of the model's size (with conjugate
    points), then uniform reweighting."""
    if weighting == "natural":
        return vis.replace(imaging_weight=vis.weight)
    if weighting != "uniform":
        raise not_ported(f"{weighting!r} weighting", "S8")
    npixel = model.npixel
    scale = npixel * model.cellsize
    uvw_l = vis.uvw_lambda
    up = (-uvw_l[..., 0] * scale + npixel // 2).reshape(-1)
    vp = (uvw_l[..., 1] * scale + npixel // 2).reshape(-1)
    fw = vis.flagged_weight
    new_imwt = torch.zeros_like(fw)
    for pol in range(fw.shape[-1]):
        wts = fw[..., pol].reshape(-1)
        density, _ = grid_weights_nearest(up, vp, wts, npixel)
        imwt = reweight_imaging_weights(up, vp, wts, density)
        new_imwt[..., pol] = imwt.reshape(fw.shape[:-1])
    return vis.replace(imaging_weight=new_imwt)
