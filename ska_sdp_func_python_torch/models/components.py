"""Sky components as one structure of arrays, and the sky model.

Counterpart of ``ska_sdp_func_python_tpu/models/components.py``:
``direction [ncomp, 2]`` (ra, dec) rad stays host numpy f64 (astrometry
contract); ``flux [ncomp, nchan, npol]`` is a tensor. A :class:`SkyModel`
is an optional image, optional components, an optional gaintable and an
optional multiplicative mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["SkyComponents", "SkyModel"]


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

    def select(self, idx) -> "SkyComponents":
        """The components of index array ``idx``, in its order."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        t = torch.as_tensor(idx, device=self.flux.device)
        return dataclasses.replace(
            self,
            direction=self.direction[idx],
            flux=self.flux[t],
            shape_params=self.shape_params[t],
        )

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
        """Components on ``device`` (None: the CUDA card)."""
        device = resolve_device(device)
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


@dataclasses.dataclass
class SkyModel:
    """Sky model: an optional image (``models.Image``), optional
    components, an optional gaintable (``models.GainTable``) and an
    optional ``[ny, nx]`` multiplicative mask (a tensor or array)."""

    image: Optional[object]
    components: Optional[SkyComponents]
    gaintable: Optional[object]
    mask: Optional[object]
    fixed: bool = False

    def replace(self, **kwargs) -> "SkyModel":
        return dataclasses.replace(self, **kwargs)
