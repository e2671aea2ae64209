"""Image data model: ``pixels [nchan, npol, ny, nx]`` plus the affine
SIN-projection parameters the hot path uses.

Counterpart of ``ska_sdp_func_python_tpu/models/image.py``, same pixel
convention: ``l = -(ix - nx//2) * cellsize``, ``m = (iy - ny//2) * cellsize``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from .polarisation import npol as _frame_npol

__all__ = ["Image", "create_image"]


@dataclasses.dataclass
class Image:
    pixels: torch.Tensor
    frequency: np.ndarray
    channel_bandwidth: np.ndarray
    phasecentre: np.ndarray
    clean_beam: Optional[np.ndarray]
    cellsize: float = 0.001
    polarisation_frame: str = "stokesI"

    @property
    def device(self) -> torch.device:
        return self.pixels.device

    @property
    def nchan(self) -> int:
        return self.pixels.shape[0]

    @property
    def npol(self) -> int:
        return self.pixels.shape[1]

    @property
    def npixel(self) -> int:
        return self.pixels.shape[-1]

    def replace(self, **kwargs) -> "Image":
        return dataclasses.replace(self, **kwargs)

    def pixel_to_lm(self, ix, iy):
        """Pixel -> (l, m), in host f64 (astrometry contract)."""
        ny, nx = self.pixels.shape[-2:]
        l = -(np.asarray(ix, np.float64) - nx // 2) * self.cellsize
        m = (np.asarray(iy, np.float64) - ny // 2) * self.cellsize
        return l, m

    def lm_to_pixel(self, l, m):
        """(l, m) -> fractional pixel (ix, iy), in host f64."""
        ny, nx = self.pixels.shape[-2:]
        ix = nx // 2 - np.asarray(l, np.float64) / self.cellsize
        iy = ny // 2 + np.asarray(m, np.float64) / self.cellsize
        return ix, iy

    def radec_to_pixel(self, ra, dec):
        """World (rad) -> fractional pixel (ix, iy) by the SIN projection."""
        from ..utils.coordinates import radec_to_lmn

        l, m, _ = radec_to_lmn(ra, dec, self.phasecentre[0], self.phasecentre[1])
        return self.lm_to_pixel(l, m)

    def pixel_to_radec(self, ix, iy):
        from ..utils.coordinates import lmn_to_radec

        l, m = self.pixel_to_lm(ix, iy)
        return lmn_to_radec(l, m, self.phasecentre[0], self.phasecentre[1])


def create_image(
    npixel: int,
    cellsize: float,
    phasecentre,
    frequency=None,
    channel_bandwidth=None,
    polarisation_frame: str = "stokesI",
    nchan: int | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Image:
    """An empty image on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    frequency = np.atleast_1d(
        np.asarray([1e8] if frequency is None else frequency, np.float64)
    )
    if channel_bandwidth is None:
        if frequency.shape[0] > 1:
            df = np.diff(frequency)
            channel_bandwidth = np.concatenate([df, df[-1:]])
        else:
            channel_bandwidth = np.full((1,), 1e6)
    frame = getattr(polarisation_frame, "name", str(polarisation_frame))
    nchan = frequency.shape[0] if nchan is None else nchan
    return Image(
        pixels=torch.zeros(
            (nchan, _frame_npol(frame), npixel, npixel),
            dtype=dtype,
            device=device,
        ),
        frequency=frequency,
        channel_bandwidth=np.atleast_1d(np.asarray(channel_bandwidth)),
        phasecentre=np.asarray(phasecentre, np.float64),
        clean_beam=None,
        cellsize=float(cellsize),
        polarisation_frame=frame,
    )
