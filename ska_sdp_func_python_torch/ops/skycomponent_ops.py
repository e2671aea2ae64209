"""Sky-component operations on images.

Counterpart of ``restore_skycomponent`` and ``_component_pixels`` in
``ska_sdp_func_python_tpu/ops/skycomponent_ops.py``. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.components import SkyComponents
from ..models.image import Image
from .deconvolution import convert_clean_beam_to_pixels

__all__ = ["restore_skycomponent"]

# components whose Gaussians are built in one [block, ny, nx] tensor: all
# of a sky model's components at once would take ncomp x ny x nx (4 GB for
# a thousand components on a 1024^2 f32 image)
_BLOCK = 32


def _component_pixels(sc: SkyComponents, im: Image):
    """Fractional pixel positions (ix, iy), each ``[ncomp]`` host f64, of
    the components in ``im``."""
    return im.radec_to_pixel(sc.direction[:, 0], sc.direction[:, 1])


def restore_skycomponent(
    im: Image, sc: SkyComponents, clean_beam: dict = None
) -> Image:
    """Add a clean-beam Gaussian of each component's flux at its position.

    Components of one channel serve every image channel; components of
    several channels restored onto a one-channel image add their mean
    flux (the continuum image is the channel mean)."""
    if clean_beam is None:
        clean_beam = {"bmaj": 1e-2, "bmin": 1e-2, "bpa": 0.0}
    sx, sy, th = convert_clean_beam_to_pixels(im, clean_beam)
    ix, iy = _component_pixels(sc, im)
    ny, nx = im.pixels.shape[-2:]
    dtype, device = im.pixels.dtype, im.pixels.device
    ct, st = np.cos(th), np.sin(th)
    a = ct**2 / (2 * sx**2) + st**2 / (2 * sy**2)
    b = st * ct * (1 / (2 * sx**2) - 1 / (2 * sy**2))
    c = st**2 / (2 * sx**2) + ct**2 / (2 * sy**2)
    flux = sc.flux.to(device=device, dtype=dtype)
    if flux.shape[1] != im.nchan:
        if flux.shape[1] == 1:
            flux = flux.expand(flux.shape[0], im.nchan, flux.shape[2])
        elif im.nchan == 1:
            flux = flux.mean(dim=1, keepdim=True)
        else:
            raise ValueError(
                f"components of {flux.shape[1]} channels on an image of {im.nchan}"
            )
    xx = torch.arange(nx, device=device, dtype=dtype)[None, None, :]
    yy = torch.arange(ny, device=device, dtype=dtype)[None, :, None]
    cx = torch.as_tensor(ix, device=device).to(dtype)[:, None, None]
    cy = torch.as_tensor(iy, device=device).to(dtype)[:, None, None]
    pixels = im.pixels.clone()
    for k in range(0, sc.ncomp, _BLOCK):
        dx = xx - cx[k : k + _BLOCK]
        dy = yy - cy[k : k + _BLOCK]
        g = torch.exp(-(a * dx**2 + 2 * b * dx * dy + c * dy**2))
        pixels += torch.einsum("kfp,kyx->fpyx", flux[k : k + _BLOCK], g)
    return im.replace(
        pixels=pixels,
        clean_beam=np.deg2rad(
            [clean_beam["bmaj"], clean_beam["bmin"], clean_beam["bpa"]]
        ),
    )
