"""Visibility phase rotation and arithmetic.

Counterpart of the phasor, phase-rotation, subtract and divide functions
of ``ska_sdp_func_python_tpu/ops/visibility_ops.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import expi, frac_dot_turns, not_ported
from ..models.visibility import Visibility
from ..utils.coordinates import radec_to_lmn

__all__ = [
    "calculate_visibility_phasor",
    "phaserotate_visibility",
    "subtract_visibility",
    "divide_visibility",
]


def calculate_visibility_phasor(direction, vis: Visibility) -> torch.Tensor:
    """exp(-2 pi i uvw_lambda . lmn) for a sky direction, ``[ntime, nbl,
    nchan]``; (l, m, n-1) come from the host in f64."""
    direction = np.asarray(direction, np.float64)
    l, m, n1 = radec_to_lmn(
        direction[..., 0], direction[..., 1], *vis.phasecentre
    )
    uvw_l = vis.uvw_lambda
    s = torch.as_tensor(
        np.stack([l, m, n1]), device=vis.device
    ).to(uvw_l.dtype)
    phase = -2.0 * np.pi * frac_dot_turns(uvw_l, s)
    return expi(phase).to(vis.vis.dtype)


def phaserotate_visibility(
    vis: Visibility, newphasecentre, tangent: bool = True, inverse: bool = False
) -> Visibility:
    """Phase-rotate to a new phase centre, keeping uvw (tangent plane)."""
    if not tangent:
        raise not_ported("phase rotation with uvw re-projection", "S11")
    phasor = calculate_visibility_phasor(newphasecentre, vis)[..., None]
    if inverse:
        return vis.replace(vis=vis.vis * phasor)
    return vis.replace(vis=vis.vis * phasor.conj())


def subtract_visibility(vis: Visibility, model_vis: Visibility) -> Visibility:
    """vis - model_vis."""
    return vis.replace(vis=vis.vis - model_vis.vis)


def divide_visibility(vis: Visibility, modelvis: Visibility) -> Visibility:
    """Point-source-equivalent visibility X = V_obs / V_model with weight
    |V_model|^2 w; the model's flagged samples count as zero model."""
    mflag = (1 - modelvis.flags).to(modelvis.weight.dtype)
    mvis = modelvis.vis * mflag
    xwt = mvis.abs() ** 2 * vis.flagged_weight
    ok = xwt > 0.0
    x = torch.where(
        ok, vis.flagged_vis / torch.where(ok, mvis, torch.ones_like(mvis)), 0.0
    )
    return vis.replace(vis=x.to(vis.vis.dtype), weight=xwt.to(vis.weight.dtype))
