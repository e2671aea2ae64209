"""GainTable data model.

Counterpart of ``ska_sdp_func_python_tpu/models/gaintable.py``: ``gain`` and
``weight`` are ``[ntime, nants, nchan, nrec, nrec]``, ``residual`` is
``[ntime, nchan, nrec, nrec]``, ``time``/``interval`` ``[ntime]``, f64
whatever the working dtype (see models/visibility.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import complex_of

__all__ = ["GainTable", "create_gaintable_from_visibility"]


@dataclasses.dataclass
class GainTable:
    gain: torch.Tensor
    weight: torch.Tensor
    residual: torch.Tensor
    time: torch.Tensor
    interval: torch.Tensor
    frequency: torch.Tensor
    jones_type: str = "T"
    receptor_frame: str = "linear"

    @property
    def ntimes(self) -> int:
        return self.gain.shape[0]

    @property
    def nants(self) -> int:
        return self.gain.shape[1]

    @property
    def nchan(self) -> int:
        return self.gain.shape[2]

    @property
    def nrec(self) -> int:
        return self.gain.shape[3]

    def replace(self, **kwargs) -> "GainTable":
        return dataclasses.replace(self, **kwargs)


def _solution_intervals(time, integration_time, timeslice):
    """Solution-interval centres and widths, on the host: one per unique
    integration for ``None``/"auto", else fixed-width bins."""
    time = np.asarray(time)
    integration_time = np.asarray(integration_time)
    if timeslice is None or timeslice == "auto":
        utime, idx = np.unique(time, return_index=True)
        return utime, integration_time[idx]
    timeslice = float(timeslice)
    tmin, tmax = time.min(), time.max()
    nbins = max(1, int(np.ceil((tmax - tmin) / timeslice))) if tmax > tmin else 1
    centres = tmin + (np.arange(nbins) + 0.5) * timeslice
    return centres, np.full(nbins, timeslice)


def create_gaintable_from_visibility(
    vis, jones_type: str = "T", timeslice=None
) -> GainTable:
    """A unit gaintable matching ``vis``, on its device: "T" and "G" get
    one solution channel at the mean frequency, "B" one per visibility
    channel. ``nrec`` is 1 for stokesI visibilities, else 2 (unit
    diagonal, zero off-diagonal)."""
    device = vis.device
    nrec = 1 if vis.npol == 1 else 2
    rdtype = vis.weight.dtype
    centres, widths = _solution_intervals(
        vis.time.cpu().numpy(), vis.integration_time.cpu().numpy(), timeslice
    )
    ntab = len(centres)
    if jones_type == "B":
        frequency = vis.frequency.to(rdtype)
    else:
        frequency = torch.as_tensor(
            [float(vis.frequency.mean())], device=device
        ).to(rdtype)
    nchan = frequency.shape[0]
    shape = (ntab, vis.nants, nchan, nrec, nrec)
    eye = torch.eye(nrec, dtype=complex_of(rdtype), device=device)
    return GainTable(
        gain=eye.expand(shape).clone(),
        weight=torch.ones(shape, dtype=rdtype, device=device),
        residual=torch.zeros((ntab, nchan, nrec, nrec), dtype=rdtype, device=device),
        time=torch.as_tensor(centres, dtype=torch.float64, device=device),
        interval=torch.as_tensor(widths, dtype=torch.float64, device=device),
        frequency=frequency.clone(),
        jones_type=jones_type,
    )
