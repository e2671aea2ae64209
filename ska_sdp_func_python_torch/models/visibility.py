"""Visibility data model: a dataclass of tensors.

Counterpart of ``ska_sdp_func_python_tpu/models/visibility.py`` with the
same shapes: ``vis/weight/imaging_weight/flags`` are
``[ntime, nbaseline, nchan, npol]``, ``uvw`` is ``[ntime, nbaseline, 3]`` in
metres, ``antenna1/antenna2`` are ``[nbaseline]`` int32. ``time`` and
``integration_time`` are f64 whatever the working dtype (absolute epochs
in MJD seconds, ~5e9 s, keep no sub-second resolution in f32), as in the
JAX package under x64. ``phasecentre`` stays host numpy f64 (astrometry
contract, see utils/coordinates.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import complex_of, resolve_device
from .polarisation import npol as _frame_npol

C_M_S = 299792458.0  # speed of light [m/s]

__all__ = ["Visibility", "create_visibility_from_arrays", "C_M_S"]


@dataclasses.dataclass
class Visibility:
    vis: torch.Tensor
    weight: torch.Tensor
    imaging_weight: torch.Tensor
    flags: torch.Tensor
    uvw: torch.Tensor
    time: torch.Tensor
    integration_time: torch.Tensor
    frequency: torch.Tensor
    channel_bandwidth: torch.Tensor
    antenna1: torch.Tensor
    antenna2: torch.Tensor
    phasecentre: np.ndarray
    polarisation_frame: str = "stokesI"
    nants: int = 0
    station_diameter: float = 35.0

    @property
    def device(self) -> torch.device:
        return self.vis.device

    @property
    def ntimes(self) -> int:
        return self.vis.shape[0]

    @property
    def nbaselines(self) -> int:
        return self.vis.shape[1]

    @property
    def nchan(self) -> int:
        return self.vis.shape[2]

    @property
    def npol(self) -> int:
        return self.vis.shape[3]

    @property
    def nvis(self) -> int:
        return int(np.prod(self.vis.shape))

    @property
    def flagged_vis(self) -> torch.Tensor:
        return self.vis * (1 - self.flags).to(self.weight.dtype)

    @property
    def flagged_weight(self) -> torch.Tensor:
        return self.weight * (1 - self.flags).to(self.weight.dtype)

    @property
    def flagged_imaging_weight(self) -> torch.Tensor:
        return self.imaging_weight * (1 - self.flags).to(
            self.imaging_weight.dtype
        )

    @property
    def uvw_lambda(self) -> torch.Tensor:
        """uvw in wavelengths, ``[ntime, nbaseline, nchan, 3]``. The
        frequencies are divided by c as a tensor of the same device: on the
        card a division by a host scalar multiplies by its reciprocal,
        which rounds differently from the CPU's division, and the nearest
        cells of the imaging weights would then differ between the two."""
        k = self.frequency / torch.full_like(self.frequency, C_M_S)
        return torch.einsum("tbs,f->tbfs", self.uvw, k.to(self.uvw.dtype))

    def replace(self, **kwargs) -> "Visibility":
        return dataclasses.replace(self, **kwargs)


def _default_integration_time(time: torch.Tensor) -> torch.Tensor:
    """Integration times of a time axis: the spacing of consecutive times,
    the last one repeated (1 s for a single time)."""
    if time.shape[0] > 1:
        dt = torch.diff(time)
        return torch.cat([dt, dt[-1:]])
    return torch.ones_like(time)


def _default_channel_bandwidth(frequency: torch.Tensor) -> torch.Tensor:
    """Channel bandwidths of a frequency axis: the spacing of consecutive
    channels, the last one repeated (1 MHz for a single channel)."""
    if frequency.shape[0] > 1:
        df = torch.diff(frequency)
        return torch.cat([df, df[-1:]])
    return torch.full_like(frequency, 1e6)


def create_visibility_from_arrays(
    *,
    uvw,
    time,
    frequency,
    antenna1,
    antenna2,
    vis=None,
    weight=None,
    flags=None,
    imaging_weight=None,
    integration_time=None,
    channel_bandwidth=None,
    phasecentre=(0.0, 0.0),
    polarisation_frame="stokesI",
    nants=None,
    station_diameter=35.0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Visibility:
    """Build a Visibility on ``device`` filling defaults (zero vis, unit
    weight). ``dtype`` is the real working dtype (f32 by default; f64 is
    the opt-in for tests) and sets the complex dtype with it; the time
    axis is f64 whatever ``dtype`` is. ``device`` None is the CUDA card
    (:func:`config.default_device`)."""
    device = resolve_device(device)
    cdtype = complex_of(dtype)

    def real(x):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    uvw = real(uvw)
    time = f64(time)
    frequency = real(np.atleast_1d(np.asarray(frequency)))
    a1 = torch.as_tensor(np.asarray(antenna1, np.int32), device=device)
    a2 = torch.as_tensor(np.asarray(antenna2, np.int32), device=device)
    frame = getattr(polarisation_frame, "name", str(polarisation_frame))
    shape = (uvw.shape[0], uvw.shape[1], frequency.shape[0], _frame_npol(frame))
    if vis is None:
        vis = torch.zeros(shape, dtype=cdtype, device=device)
    else:
        vis = torch.as_tensor(np.asarray(vis), device=device).to(cdtype)
    weight = (
        torch.ones(shape, dtype=dtype, device=device)
        if weight is None
        else real(weight)
    )
    imaging_weight = weight if imaging_weight is None else real(imaging_weight)
    if flags is None:
        flags = torch.zeros(shape, dtype=torch.int32, device=device)
    else:
        flags = torch.as_tensor(np.asarray(flags, np.int32), device=device)
    if integration_time is None:
        integration_time = _default_integration_time(time)
    else:
        integration_time = f64(integration_time)
    if channel_bandwidth is None:
        channel_bandwidth = _default_channel_bandwidth(frequency)
    else:
        channel_bandwidth = real(np.atleast_1d(np.asarray(channel_bandwidth)))
    if nants is None:
        nants = int(max(int(a1.max()), int(a2.max())) + 1)
    return Visibility(
        vis=vis,
        weight=weight,
        imaging_weight=imaging_weight,
        flags=flags,
        uvw=uvw,
        time=time,
        integration_time=integration_time,
        frequency=frequency,
        channel_bandwidth=channel_bandwidth,
        antenna1=a1,
        antenna2=a2,
        phasecentre=np.asarray(phasecentre, np.float64),
        polarisation_frame=frame,
        nants=int(nants),
        station_diameter=float(station_diameter),
    )
