"""Direct Fourier transform predict of sky components.

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

from ..config import frac_dot_turns, not_ported, real_of
from ..models.components import SkyComponents
from ..models.visibility import Visibility
from ..utils.coordinates import radec_to_lmn

__all__ = [
    "extract_direction_and_flux",
    "dft_kernel",
    "dft_skycomponent_visibility",
]


def extract_direction_and_flux(sc: SkyComponents, vis: Visibility):
    """Component (l, m, n-1) as a (hi, lo) pair ``[ncomp, 3, 2]`` and the
    fluxes on the vis channels ``[ncomp, nchan, npol]``."""
    if sc.polarisation_frame != vis.polarisation_frame:
        raise not_ported("component polarisation conversion", "S7x")
    flux = sc.flux
    if flux.shape[1] == vis.nchan:
        vflux = flux
    elif flux.shape[1] == 1:
        vflux = flux.expand(flux.shape[0], vis.nchan, flux.shape[2])
    else:
        raise not_ported("component flux frequency interpolation", "S11")
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


def dft_kernel(direction_cosines, vfluxes, uvw_lambda):
    """V[t,b,f,p] = sum_c S[c,f,p] exp(-2 pi i uvw[t,b,f,:] . lmn[c,:]).

    ``direction_cosines`` is ``[c, 3]`` or the (hi, lo) pair ``[c, 3, 2]``.
    """
    rdtype = real_of(vfluxes.dtype)
    lo = None
    if direction_cosines.ndim == 3:
        lo = direction_cosines[..., 1]
        direction_cosines = direction_cosines[..., 0]
    uvw = uvw_lambda.to(rdtype)
    turns = frac_dot_turns(
        uvw[..., None, :], direction_cosines.to(rdtype)[None, None, None]
    )  # [t, b, f, c]
    if lo is not None:
        # |uvw . lo| << 1 turn: a plain product is exact enough
        turns = turns + torch.einsum("tbfs,cs->tbfc", uvw, lo.to(rdtype))
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
