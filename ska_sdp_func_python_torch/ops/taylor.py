"""Frequency moments (Taylor terms) of image cubes.

Counterpart of ``moment_weights``, ``calculate_image_frequency_moments`` and
``calculate_image_from_frequency_taylor_terms`` in
``ska_sdp_func_python_tpu/ops/taylor.py``: the channel <-> moment maps are
single einsums against the ``[nchan, nmoment]`` weight matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.image import Image

__all__ = [
    "moment_weights",
    "calculate_image_frequency_moments",
    "calculate_image_from_frequency_taylor_terms",
]


def moment_weights(frequency, reference_frequency=None, nmoment: int = 1):
    """w[chan, k] = ((nu_chan - nu_ref) / nu_ref)^k as an f64 tensor on
    the CPU (or on the device of a tensor ``frequency``); ``nu_ref`` is the
    middle channel's frequency unless given."""
    if not isinstance(frequency, torch.Tensor):
        frequency = torch.tensor(np.asarray(frequency, np.float64))
    frequency = frequency.to(torch.float64)
    nchan = frequency.shape[0]
    if reference_frequency is None:
        reference_frequency = frequency[nchan // 2]
    x = (frequency - reference_frequency) / reference_frequency
    return x[:, None] ** torch.arange(nmoment, device=x.device)[None, :]


def calculate_image_frequency_moments(
    im: Image, reference_frequency=None, nmoment: int = 1
) -> Image:
    """Channel cube -> frequency-moment cube: the spectral axis of the
    pixels becomes a moment axis."""
    if nmoment > im.nchan:
        raise ValueError(
            f"Number of moments {nmoment} cannot exceed channels {im.nchan}"
        )
    w = moment_weights(im.frequency, reference_frequency, nmoment)
    w = w.to(device=im.pixels.device, dtype=im.pixels.dtype)
    return im.replace(pixels=torch.einsum("cm,cpyx->mpyx", w, im.pixels))


def calculate_image_from_frequency_taylor_terms(
    im: Image, taylor_terms_image: Image, reference_frequency=None
) -> Image:
    """Moment cube -> channel cube on ``im``'s frequency grid."""
    tt = taylor_terms_image.pixels
    w = moment_weights(im.frequency, reference_frequency, tt.shape[0])
    w = w.to(device=tt.device, dtype=tt.dtype)
    return im.replace(pixels=torch.einsum("cm,mpyx->cpyx", w, tt))
