"""Visibility phase rotation, arithmetic, concatenation, channel
averaging, continuum removal and polarisation conversion.

Counterpart of ``ska_sdp_func_python_tpu/ops/visibility_ops.py``. Times and
integration times stay f64 whatever the working dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import expi, frac_dot_turns
from ..models.polarisation import (
    convert_circular_to_stokes,
    convert_linear_to_stokes,
    convert_stokesI_to_polframe,
    npol as _frame_npol,
    parallel_hands_to_stokesI,
)
from ..models.visibility import Visibility
from ..utils.coordinates import radec_to_lmn, uvw_to_xyz, xyz_to_uvw

__all__ = [
    "calculate_visibility_phasor",
    "phaserotate_visibility",
    "concatenate_visibility",
    "concatenate_visibility_frequency",
    "subtract_visibility",
    "divide_visibility",
    "remove_continuum_visibility",
    "integrate_visibility_by_channel",
    "average_visibility_by_channel",
    "calculate_visibility_uvw_lambda",
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
    """Phase-rotate to a new phase centre. With ``tangent`` (the default)
    the uvw stay as they are; with ``tangent=False`` they are re-projected
    into the new frame (through celestial XYZ at hour angle minus the
    right ascension, in f64) and ``phasecentre`` becomes the new one."""
    phasor = calculate_visibility_phasor(newphasecentre, vis)[..., None]
    out = vis.replace(vis=vis.vis * (phasor if inverse else phasor.conj()))
    if tangent:
        return out
    new = np.asarray(newphasecentre, np.float64)
    xyz = uvw_to_xyz(
        vis.uvw.to(torch.float64), -vis.phasecentre[0], vis.phasecentre[1]
    )
    uvw = xyz_to_uvw(xyz, -new[0], new[1]).to(vis.uvw.dtype)
    return out.replace(uvw=uvw, phasecentre=new)


_TIME_FIELDS = (
    "vis", "weight", "imaging_weight", "flags", "uvw", "time", "integration_time",
)
_FREQUENCY_FIELDS = ("vis", "weight", "imaging_weight", "flags")


def concatenate_visibility(vis_list, dim: str = "time") -> Visibility:
    """Concatenate Visibilities along time or frequency; the first one's
    other fields are kept."""
    if not vis_list:
        raise ValueError("concatenate_visibility: vis_list is empty")
    v0 = vis_list[0]
    if dim == "time":
        return v0.replace(**{
            f: torch.cat([getattr(v, f) for v in vis_list], dim=0)
            for f in _TIME_FIELDS
        })
    if dim == "frequency":
        return v0.replace(
            frequency=torch.cat([v.frequency for v in vis_list]),
            channel_bandwidth=torch.cat([v.channel_bandwidth for v in vis_list]),
            **{
                f: torch.cat([getattr(v, f) for v in vis_list], dim=2)
                for f in _FREQUENCY_FIELDS
            },
        )
    raise ValueError(f"concatenate_visibility: unknown dim {dim}")


def concatenate_visibility_frequency(bvis_list) -> Visibility:
    """Concatenate a channel-ordered list of Visibilities in frequency."""
    return concatenate_visibility(bvis_list, dim="frequency")


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


def remove_continuum_visibility(
    vis: Visibility, degree: int = 1, mask=None
) -> Visibility:
    """Fit a polynomial in frequency of ``degree`` to each (time,
    baseline, polarisation) spectrum by weighted least squares (weights
    the square roots of the flagged weights; ``mask`` [nchan] non-zero
    leaves a channel out of the fit) and subtract it. The frequency axis
    is centred on channel nchan // 2 and scaled by its offset from
    channel 0, as the JAX package does."""
    nchan = vis.nchan
    f = vis.frequency
    x = (f - f[nchan // 2]) / (f[0] - f[nchan // 2])
    wt = torch.sqrt(vis.flagged_weight)
    if mask is not None:
        keep = 1.0 - torch.as_tensor(np.asarray(mask), device=wt.device).to(wt.dtype)
        wt = wt * keep[None, None, :, None]
    cdtype = vis.vis.dtype
    powers = torch.arange(degree, -1, -1, device=x.device)
    vand = x[:, None] ** powers[None, :]  # [f, degree + 1]
    wtm = wt.movedim(2, -1)  # [t, b, p, f]
    vism = vis.vis.movedim(2, -1)
    a = wtm[..., :, None] * vand
    y = wtm.to(cdtype) * vism
    ata = torch.einsum("...fi,...fj->...ij", a, a)
    aty = torch.einsum("...fi,...f->...i", a.to(cdtype), y)
    eye = torch.eye(degree + 1, dtype=cdtype, device=x.device)
    coef = torch.linalg.solve(ata.to(cdtype) + 1e-30 * eye, aty[..., None])[..., 0]
    pred = torch.einsum("fi,...i->...f", vand.to(cdtype), coef)
    return vis.replace(vis=(vism - pred).movedim(-1, 2))


def integrate_visibility_by_channel(vis: Visibility) -> Visibility:
    """Collapse the channel axis: the weighted mean of each spectrum (its
    flagged weights as weights), the summed weights and imaging weights, a
    sample flagged only where every channel is, the mean frequency and
    the summed bandwidth."""
    fw = vis.flagged_weight
    flags = (vis.flags.sum(dim=-2, keepdim=True) >= vis.nchan).to(vis.flags.dtype)
    newvis = (vis.vis * fw.to(vis.vis.dtype)).sum(dim=-2, keepdim=True)
    newweights = fw.sum(dim=-2, keepdim=True)
    denom = (1 - flags) * newweights
    ok = denom > 0.0
    newvis = torch.where(
        ok, newvis / torch.where(ok, denom, 1.0).to(newvis.dtype), newvis
    )
    return vis.replace(
        vis=newvis,
        weight=newweights,
        imaging_weight=vis.flagged_imaging_weight.sum(dim=-2, keepdim=True),
        flags=flags,
        frequency=vis.frequency.mean(dim=0, keepdim=True),
        channel_bandwidth=vis.channel_bandwidth.sum(dim=0, keepdim=True),
    )


def average_visibility_by_channel(vis: Visibility, channel_average: int) -> list:
    """One single-channel Visibility per group of ``channel_average``
    channels (the last group may be shorter), each integrated by
    :func:`integrate_visibility_by_channel`."""
    out = []
    for start in range(0, vis.nchan, channel_average):
        sel = slice(start, min(start + channel_average, vis.nchan))
        out.append(integrate_visibility_by_channel(vis.replace(
            vis=vis.vis[..., sel, :],
            weight=vis.weight[..., sel, :],
            imaging_weight=vis.imaging_weight[..., sel, :],
            flags=vis.flags[..., sel, :],
            frequency=vis.frequency[sel],
            channel_bandwidth=vis.channel_bandwidth[sel],
        )))
    return out


def calculate_visibility_uvw_lambda(vis: Visibility) -> Visibility:
    """The Visibility as it is: ``uvw_lambda`` is derived from uvw and the
    frequencies on access (the JAX package's API keeps this call)."""
    return vis


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
