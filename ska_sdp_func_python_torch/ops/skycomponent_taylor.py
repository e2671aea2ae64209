"""Frequency Taylor terms of sky components.

Counterpart of ``ska_sdp_func_python_tpu/ops/skycomponent_taylor.py``: one
``SkyComponents`` holds every source, so the channel <-> moment maps are
single contractions over its ``flux [ncomp, nchan, npol]`` with the
pseudo-inverse of ``taylor.moment_weights``, on the flux's device. The
per-channel lists (``transpose_skycomponents_to_channels``,
``gather_skycomponents_from_channels``) keep the reference's
[channel][source] decomposition.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.components import SkyComponents
from .taylor import moment_weights

__all__ = [
    "calculate_skycomponent_list_taylor_terms",
    "find_skycomponents_frequency_taylor_terms",
    "gather_skycomponents_from_channels",
    "interpolate_skycomponents_frequency",
    "transpose_skycomponents_to_channels",
]


def _reference_frequency(frequency, reference_frequency) -> float:
    """The middle channel's frequency, unless given."""
    if reference_frequency is not None:
        return float(reference_frequency)
    frequency = torch.as_tensor(frequency)
    return float(frequency[frequency.shape[0] // 2])


def _weights(sc: SkyComponents, ref: float, nmoment: int) -> torch.Tensor:
    return moment_weights(sc.frequency.to(torch.float64), ref, nmoment)


def calculate_skycomponent_list_taylor_terms(
    sc: SkyComponents, nmoment: int = 1, reference_frequency=None
) -> SkyComponents:
    """The frequency Taylor terms of every component: a SkyComponents
    whose channel axis is the moment axis (``flux [ncomp, nmoment,
    npol]``, every frequency the reference frequency), through the
    pseudo-inverse of the channel-moment weights."""
    ref = _reference_frequency(sc.frequency, reference_frequency)
    pinv = torch.linalg.pinv(_weights(sc, ref, nmoment), rtol=1e-7)
    flux = torch.einsum("mc,kcp->kmp", pinv.to(sc.flux.dtype), sc.flux)
    frequency = torch.full((nmoment,), ref, dtype=sc.frequency.dtype,
                           device=sc.frequency.device)
    return sc.replace(flux=flux, frequency=frequency)


def interpolate_skycomponents_frequency(
    sc: SkyComponents, nmoment: int = 1, reference_frequency=None
) -> SkyComponents:
    """Component fluxes smoothed by their least-squares polynomial of
    degree ``nmoment - 1`` in fractional frequency: flux -> V pinv(V) flux,
    V the ``[nchan, nmoment]`` moment weights."""
    ref = _reference_frequency(sc.frequency, reference_frequency)
    v = _weights(sc, ref, nmoment)
    proj = (v @ torch.linalg.pinv(v)).to(sc.flux.dtype)
    return sc.replace(flux=torch.einsum("dc,kcp->kdp", proj, sc.flux))


def transpose_skycomponents_to_channels(sc: SkyComponents) -> List[SkyComponents]:
    """[source, channel] -> a list over channels of one-channel
    SkyComponents."""
    return [
        sc.replace(flux=sc.flux[:, chan : chan + 1, :],
                   frequency=sc.frequency[chan : chan + 1])
        for chan in range(sc.nchan)
    ]


def gather_skycomponents_from_channels(sc_list: List[SkyComponents]) -> SkyComponents:
    """The inverse of :func:`transpose_skycomponents_to_channels`."""
    return sc_list[0].replace(
        flux=torch.cat([sc.flux for sc in sc_list], dim=1),
        frequency=torch.cat([sc.frequency for sc in sc_list]),
    )


def find_skycomponents_frequency_taylor_terms(
    dirty_list, nmoment: int = 1, reference_frequency=None, **kwargs
) -> List[SkyComponents]:
    """Find components on the moment-0 image of a list of one-channel
    images, fit each one's flux on every channel
    (``skycomponent_ops.fit_skycomponent``), smooth the fluxes by a
    polynomial in frequency and return them per channel ([channel][source];
    ``[]`` when none is found). ``component_threshold`` sets the finder's
    threshold (default infinite: nothing is found); the other keywords go
    to the fit."""
    from .skycomponent_ops import find_skycomponents, fit_skycomponent
    from .taylor import calculate_frequency_taylor_terms_from_image_list

    frequency = np.array([float(np.asarray(d.frequency)[0]) for d in dirty_list])
    ref = _reference_frequency(frequency, reference_frequency)
    moment0 = calculate_frequency_taylor_terms_from_image_list(
        dirty_list, nmoment=1, reference_frequency=ref
    )[0]
    threshold = kwargs.get("component_threshold", np.inf)
    try:
        found = find_skycomponents(moment0, threshold=threshold)
    except ValueError:
        return []
    if found is None or found.ncomp == 0:
        return []
    fit_kwargs = {k: v for k, v in kwargs.items() if k != "component_threshold"}
    flux = torch.stack([
        torch.stack([
            fit_skycomponent(d, found.select([k]), **fit_kwargs).flux[0, 0, :]
            for d in dirty_list
        ])
        for k in range(found.ncomp)
    ])  # [ncomp, nchan, npol]
    full = found.replace(
        flux=flux,
        frequency=torch.as_tensor(frequency, device=found.flux.device).to(found.frequency.dtype),
    )
    smoothed = interpolate_skycomponents_frequency(full, nmoment=nmoment, reference_frequency=ref)
    return transpose_skycomponents_to_channels(smoothed)
