"""Sky components as one structure of arrays.

Counterpart of ``ska_sdp_func_python_tpu/models/components.py``:
``direction [ncomp, 2]`` (ra, dec) rad stays host numpy f64 (astrometry
contract); ``flux [ncomp, nchan, npol]`` is a tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SkyComponents"]


@dataclasses.dataclass
class SkyComponents:
    direction: np.ndarray
    flux: torch.Tensor
    frequency: torch.Tensor
    shape_params: torch.Tensor
    shape: str = "Point"
    polarisation_frame: str = "stokesI"

    @property
    def ncomp(self) -> int:
        return self.direction.shape[0]

    @property
    def nchan(self) -> int:
        return self.flux.shape[1]

    @property
    def npol(self) -> int:
        return self.flux.shape[2]

    def replace(self, **kwargs) -> "SkyComponents":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_lists(
        cls,
        directions,
        fluxes,
        frequency,
        shape: str = "Point",
        polarisation_frame: str = "stokesI",
        shape_params=None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "SkyComponents":
        directions = np.asarray(directions, np.float64).reshape(-1, 2)
        fluxes = np.asarray(fluxes, dtype=float)
        if fluxes.ndim == 2:  # [ncomp, npol] -> single channel
            fluxes = fluxes[:, None, :]
        if shape_params is None:
            shape_params = np.zeros((directions.shape[0], 3))
        frequency = np.atleast_1d(
            np.asarray(
                frequency.cpu() if torch.is_tensor(frequency) else frequency
            )
        )
        return cls(
            direction=directions,
            flux=torch.as_tensor(fluxes, device=device).to(dtype),
            frequency=torch.as_tensor(frequency, device=device).to(dtype),
            shape_params=torch.as_tensor(
                np.asarray(shape_params), device=device
            ).to(dtype),
            shape=shape,
            polarisation_frame=str(polarisation_frame),
        )
