"""Visibility phase rotation, arithmetic and polarisation conversion.

Counterpart of the phasor, phase-rotation, subtract, divide and
polarisation functions of ``ska_sdp_func_python_tpu/ops/visibility_ops.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import expi, frac_dot_turns, not_ported
from ..models.polarisation import (
    convert_circular_to_stokes,
    convert_linear_to_stokes,
    convert_stokesI_to_polframe,
    npol as _frame_npol,
    parallel_hands_to_stokesI,
)
from ..models.visibility import Visibility
from ..utils.coordinates import radec_to_lmn

__all__ = [
    "calculate_visibility_phasor",
    "phaserotate_visibility",
    "subtract_visibility",
    "divide_visibility",
    "convert_visibility_to_stokes",
    "convert_visibility_to_stokesI",
    "convert_visibility_stokesI_to_polframe",
    "expand_polarizations",
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


def _pair_flags(flags, i, j):
    """[..., 1]: a sample is flagged where either of polarisations ``i``
    and ``j`` is."""
    return (flags[..., i].bool() | flags[..., j].bool())[..., None].to(flags.dtype)


def convert_visibility_to_stokes(vis: Visibility) -> Visibility:
    """linear or circular visibilities -> stokesIQUV; the flags of the
    parallel hands flag all four. Other frames are returned as they
    are."""
    if vis.polarisation_frame == "linear":
        newvis = convert_linear_to_stokes(vis.vis, polaxis=3)
    elif vis.polarisation_frame == "circular":
        newvis = convert_circular_to_stokes(vis.vis, polaxis=3)
    else:
        return vis
    flags = _pair_flags(vis.flags, 0, 3).expand(vis.flags.shape).contiguous()
    return vis.replace(vis=newvis, flags=flags, polarisation_frame="stokesIQUV")


def convert_visibility_to_stokesI(vis: Visibility) -> Visibility:
    """Stokes I from the parallel hands, with their summed weights and
    joined flags."""
    frame = vis.polarisation_frame
    if frame == "stokesI":
        return vis
    if frame in ("linear", "circular"):
        i, j = 0, 3
    elif frame in ("linearnp", "circularnp"):
        i, j = 0, 1
    else:
        raise ValueError(f"Unsupported frame {frame}")
    fw, fiw = vis.flagged_weight, vis.flagged_imaging_weight
    return vis.replace(
        vis=parallel_hands_to_stokesI(vis.flagged_vis),
        weight=(fw[..., i] + fw[..., j])[..., None],
        imaging_weight=(fiw[..., i] + fiw[..., j])[..., None],
        flags=_pair_flags(vis.flags, i, j),
        polarisation_frame="stokesI",
    )


def convert_visibility_stokesI_to_polframe(vis: Visibility, poldef: str) -> Visibility:
    """Stokes I -> ``poldef``: every polarisation copies I, and the cross
    hands of a four-polarisation frame are zero."""
    if vis.polarisation_frame == str(poldef):
        return vis
    n = _frame_npol(str(poldef))

    def rep(x):
        return x[..., :1].repeat_interleave(n, dim=-1)

    return vis.replace(
        vis=convert_stokesI_to_polframe(vis.flagged_vis, poldef),
        weight=rep(vis.flagged_weight),
        imaging_weight=rep(vis.flagged_imaging_weight),
        flags=rep(vis.flags),
        polarisation_frame=str(poldef),
    )


def expand_polarizations(data: torch.Tensor, dtype=None) -> torch.Tensor:
    """[..., npol] -> [..., 4]: npol 2 fills the parallel hands, npol 1
    both of them with its one value."""
    dtype = data.dtype if dtype is None else dtype
    if data.shape[-1] == 4:
        return data.to(dtype)
    out = torch.zeros(data.shape[:-1] + (4,), dtype=dtype, device=data.device)
    out[..., 0] = data[..., 0]
    out[..., 3] = data[..., 1 if data.shape[-1] == 2 else 0]
    return out
