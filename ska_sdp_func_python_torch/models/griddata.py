"""uv-grid data model: a dataclass of tensors.

Counterpart of ``ska_sdp_func_python_tpu/models/griddata.py``: ``pixels
[nchan, npol, nv, nu]`` complex on a device, the image template's
frequencies (host numpy f64), its cellsize and polarisation frame. The
grid's WCS reduces to the image cellsize: for an image of ``npixel``
pixels of ``cellsize`` rad, the uv cell is ``1 / (npixel * cellsize)``
wavelengths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GridData"]


@dataclasses.dataclass
class GridData:
    """uv grid; ``pixels [nchan, npol, nv, nu]`` complex. ``cellsize`` is
    the image cellsize in radians."""

    pixels: torch.Tensor
    frequency: np.ndarray
    cellsize: float = 0.001
    polarisation_frame: str = "stokesI"

    @property
    def device(self) -> torch.device:
        return self.pixels.device

    @property
    def npixel(self) -> int:
        return self.pixels.shape[-1]

    @property
    def uv_cell(self) -> float:
        return 1.0 / (self.pixels.shape[-1] * self.cellsize)

    def replace(self, **kwargs) -> "GridData":
        return dataclasses.replace(self, **kwargs)
