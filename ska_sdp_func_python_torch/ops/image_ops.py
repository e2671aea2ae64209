"""Image polarisation and clean-beam conversions.

Counterpart of ``ska_sdp_func_python_tpu/ops/image_ops.py``. The clean-beam
converters are the ones ``ops.deconvolution`` restores with, re-exported
here under the JAX module's names.
"""

from __future__ import annotations

import torch

from ..config import complex_of
from ..models.image import Image
from ..models.polarisation import (
    convert_circular_to_stokes,
    convert_linear_to_stokes,
    convert_stokes_to_circular,
    convert_stokes_to_linear,
    frame_name,
)
from .deconvolution import convert_clean_beam_to_degrees, convert_clean_beam_to_pixels

__all__ = [
    "convert_clean_beam_to_degrees",
    "convert_clean_beam_to_pixels",
    "convert_stokes_to_polimage",
    "convert_polimage_to_stokes",
]


def convert_stokes_to_polimage(im: Image, polarisation_frame) -> Image:
    """A Stokes image -> a complex image in the correlation frame
    ``polarisation_frame`` (linear, linearnp, circular, circularnp), or
    the same image made complex for "stokesI"."""
    frame = frame_name(polarisation_frame)
    if frame in ("linear", "linearnp"):
        data = convert_stokes_to_linear(im.pixels, polaxis=1)
    elif frame in ("circular", "circularnp"):
        data = convert_stokes_to_circular(im.pixels, polaxis=1)
    elif frame == "stokesI":
        data = im.pixels.to(complex_of(im.pixels.dtype))
    else:
        raise ValueError(f"Cannot convert stokes to {frame}")
    return im.replace(pixels=data, polarisation_frame=frame)


_TO_STOKES = {
    "linear": (convert_linear_to_stokes, "stokesIQUV"),
    "linearnp": (convert_linear_to_stokes, "stokesIQ"),
    "circular": (convert_circular_to_stokes, "stokesIQUV"),
    "circularnp": (convert_circular_to_stokes, "stokesIV"),
}


def convert_polimage_to_stokes(im: Image, complex_image: bool = False) -> Image:
    """A complex correlation-frame image -> Stokes (its real part unless
    ``complex_image``)."""
    frame = im.polarisation_frame
    if frame == "stokesI":
        data, new_frame = im.pixels, "stokesI"
    elif frame in _TO_STOKES:
        fn, new_frame = _TO_STOKES[frame]
        data = fn(im.pixels, polaxis=1)
    else:
        raise ValueError(f"Cannot convert {frame} to stokes")
    if not complex_image and torch.is_complex(data):
        data = data.real
    return im.replace(pixels=data, polarisation_frame=new_frame)
