"""Direct Fourier transform predict of sky components, and its inverse
(component fluxes from visibilities).

Counterpart of ``ska_sdp_func_python_tpu/ops/dft.py``. Plain PyTorch: the
JAX package left this to XLA as two contractions, and the port leaves it
to PyTorch's matmul the same way. Phases are reduced mod one turn with the
Dekker-split product (``config.frac_dot_turns``) and the direction cosines
ride as a compensated (hi, lo) pair, so f32 device arithmetic keeps the
host-f64 direction accuracy at long baselines.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import frac_dot_turns, real_of
from ..models.components import SkyComponents
from ..models.polarisation import convert_pol_frame
from ..models.visibility import Visibility
from ..utils.coordinates import radec_to_lmn

__all__ = [
    "dft_cpu_looped",
    "dft_gpu_raw_kernel",
    "extract_direction_and_flux",
    "dft_kernel",
    "dft_skycomponent_visibility",
    "idft_visibility_skycomponent",
]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp [..., k]`` given at the increasing
    ``xp [k]`` onto ``x [m]``, along the last axis, on the tensors' device:
    ``torch.searchsorted`` and a lerp in ``jnp.interp``'s operations, held
    at ``fp[..., 0]`` below ``xp[0]`` and ``fp[..., -1]`` above ``xp[-1]``.
    Returns ``[..., m]``."""
    k = xp.shape[0]
    if k == 1:
        return fp[..., :1].expand(*fp.shape[:-1], x.shape[0])
    dtype = torch.promote_types(x.dtype, xp.dtype)
    x, xp = x.to(dtype), xp.to(dtype)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, k - 1)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64 if dtype == torch.float64 else np.float32).eps))
    dx0 = dx.abs() <= eps
    f0, f1 = fp[..., i - 1], fp[..., i]
    t = (delta / torch.where(dx0, torch.ones_like(dx), dx)).to(fp.dtype)
    f = torch.where(dx0, f0, f0 + t * (f1 - f0))
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def flux_on_channels(flux: torch.Tensor, frequency, to_frequency, nchan: int) -> torch.Tensor:
    """Component fluxes ``[ncomp, nchan_c, npol]`` given at ``frequency``
    on ``nchan`` channels at ``to_frequency``: as they are where
    ``nchan_c`` is ``nchan``, broadcast from one channel, else linearly
    interpolated (:func:`interp`) per component and polarisation."""
    if flux.shape[1] == nchan:
        return flux
    if flux.shape[1] == 1:
        return flux.expand(flux.shape[0], nchan, flux.shape[2])
    dev = flux.device
    xp = torch.as_tensor(frequency, device=dev)
    x = torch.as_tensor(to_frequency, device=dev)
    return interp(x, xp, flux.transpose(1, 2)).transpose(1, 2)


def extract_direction_and_flux(sc: SkyComponents, vis: Visibility):
    """Component (l, m, n-1) as a (hi, lo) pair ``[ncomp, 3, 2]`` and the
    fluxes on the vis channels (interpolated linearly in frequency where
    the components have other channels) and in the vis frame ``[ncomp,
    nchan, npol]``."""
    flux = sc.flux
    if sc.polarisation_frame != vis.polarisation_frame:
        flux = convert_pol_frame(
            flux, sc.polarisation_frame, vis.polarisation_frame, polaxis=-1
        )
    vflux = flux_on_channels(flux, sc.frequency, vis.frequency, vis.nchan)
    l, m, n1 = radec_to_lmn(
        sc.direction[:, 0], sc.direction[:, 1], *vis.phasecentre
    )
    cdtype = vis.vis.dtype
    lmn = _split_lmn(l, m, n1, cdtype).to(vis.device)
    return lmn, vflux.to(device=vis.device, dtype=cdtype)


def _split_lmn(l, m, n1, cdtype):
    """Direction cosines as a compensated (hi, lo) pair ``[c, 3, 2]``.

    On an f32 device the hi part goes through the mod-1 compensated dot
    and the lo part (|lo| ~ eps32 |lmn|) adds a plain-product phase
    correction; in f64 the lo part is zero."""
    lmn64 = np.stack([l, m, n1], axis=-1).astype(np.float64)
    if cdtype == torch.complex64:
        hi = lmn64.astype(np.float32)
        lo = (lmn64 - hi.astype(np.float64)).astype(np.float32)
        return torch.from_numpy(np.stack([hi, lo], axis=-1))
    return torch.from_numpy(np.stack([lmn64, np.zeros_like(lmn64)], axis=-1))


def _turns(uvw, lmn):
    """Phase turns ``[t, b, f, c]`` of every (visibility, component)
    from the (hi, lo) pair ``lmn`` ``[c, 3, 2]``: the hi part through the
    mod-1 compensated dot, the lo part (|uvw . lo| << 1 turn) as a plain
    product."""
    rdtype = uvw.dtype
    turns = frac_dot_turns(
        uvw[..., None, :], lmn[..., 0].to(rdtype)[None, None, None]
    )
    return turns + torch.einsum("tbfs,cs->tbfc", uvw, lmn[..., 1].to(rdtype))


def dft_kernel(direction_cosines, vfluxes, uvw_lambda):
    """V[t,b,f,p] = sum_c S[c,f,p] exp(-2 pi i uvw[t,b,f,:] . lmn[c,:]).

    ``direction_cosines`` is ``[c, 3]`` or the (hi, lo) pair ``[c, 3, 2]``.
    """
    rdtype = real_of(vfluxes.dtype)
    uvw = uvw_lambda.to(rdtype)
    if direction_cosines.ndim == 3:
        turns = _turns(uvw, direction_cosines)
    else:
        turns = frac_dot_turns(
            uvw[..., None, :], direction_cosines.to(rdtype)[None, None, None]
        )  # [t, b, f, c]
    phase = (-2.0 * np.pi) * turns
    phasor = torch.polar(torch.ones_like(phase), phase).to(vfluxes.dtype)
    return torch.einsum("tbfc,cfp->tbfp", phasor, vfluxes)


def dft_skycomponent_visibility(
    vis: Visibility, sc: SkyComponents
) -> Visibility:
    """Predict visibilities from components, replacing ``vis.vis``."""
    if sc is None or sc.ncomp == 0:
        return vis
    lmn, vflux = extract_direction_and_flux(sc, vis)
    new_vis = dft_kernel(lmn, vflux, vis.uvw_lambda)
    return vis.replace(vis=new_vis.to(vis.vis.dtype))


def idft_visibility_skycomponent(vis: Visibility, sc: SkyComponents):
    """Component fluxes from the visibilities: the weighted sum of V
    times the conjugate phasor of each component's direction, over the
    sum of weights, per (channel, polarisation), taken back from the vis
    frame to the components' frame. Returns (components with that flux,
    weights ``[nchan, npol]`` in the vis frame)."""
    if sc is None:
        return sc, None
    l, m, n1 = radec_to_lmn(
        sc.direction[:, 0], sc.direction[:, 1], *vis.phasecentre
    )
    rdtype = real_of(vis.vis.dtype)
    lmn = _split_lmn(l, m, n1, vis.vis.dtype).to(vis.device)
    phase = (-2.0 * np.pi) * _turns(vis.uvw_lambda.to(rdtype), lmn)
    conj_phasor = torch.polar(torch.ones_like(phase), -phase).to(vis.vis.dtype)
    fw = vis.flagged_weight
    flux = torch.einsum("tbfp,tbfc->cfp", fw * vis.flagged_vis, conj_phasor)
    weight = fw.sum(dim=(0, 1))  # [nchan, npol]
    ok = weight[None] > 0.0
    flux = torch.where(ok, flux / torch.where(ok, weight[None], 1.0), 0.0).real
    if sc.polarisation_frame != vis.polarisation_frame:
        flux = convert_pol_frame(
            flux, vis.polarisation_frame, sc.polarisation_frame, polaxis=-1
        ).real
    return sc.replace(flux=flux.to(sc.flux.dtype)), weight


def dft_cpu_looped(direction_cosines, vfluxes, uvw_lambda, *args):
    """The reference's looped CPU entry: :func:`dft_kernel`, which serves
    every device."""
    return dft_kernel(direction_cosines, vfluxes, uvw_lambda)


def dft_gpu_raw_kernel(direction_cosines, vfluxes, uvw_lambda, *args):
    """The reference's raw-GPU-kernel entry: :func:`dft_kernel`, which
    serves every device."""
    return dft_kernel(direction_cosines, vfluxes, uvw_lambda)
