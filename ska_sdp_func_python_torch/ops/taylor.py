"""Frequency moments (Taylor terms) of image cubes.

Counterpart of ``ska_sdp_func_python_tpu/ops/taylor.py``: the channel <->
moment maps are single einsums against the ``[nchan, nmoment]`` weight
matrix (its pseudo-inverse for the least-squares Taylor terms); the list
variants gather single-channel images into one cube first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.image import Image

__all__ = [
    "moment_weights",
    "calculate_image_frequency_moments",
    "calculate_image_from_frequency_taylor_terms",
    "calculate_frequency_taylor_terms_from_image",
    "calculate_image_list_frequency_moments",
    "calculate_image_list_from_frequency_taylor_terms",
    "calculate_frequency_taylor_terms_from_image_list",
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


def calculate_frequency_taylor_terms_from_image(
    im: Image, nmoment: int = 1, reference_frequency=None, rcond: float = 1e-7
) -> Image:
    """Least-squares Taylor terms of a channel cube: the pseudo-inverse of
    the channel-moment weights (singular values below ``rcond`` of the
    largest dropped) applied over the channels."""
    w = moment_weights(im.frequency, reference_frequency, nmoment)
    pinv = torch.linalg.pinv(w, rtol=rcond)  # [nmoment, nchan]
    pinv = pinv.to(device=im.pixels.device, dtype=im.pixels.dtype)
    return im.replace(pixels=torch.einsum("mc,cpyx->mpyx", pinv, im.pixels))


def _gather(im_list) -> Image:
    from .image_iterators import image_gather_channels

    return image_gather_channels(list(im_list))


def calculate_image_list_frequency_moments(
    im_list, reference_frequency=None, nmoment: int = 1
) -> Image:
    """A list of single-channel images -> one moment image."""
    return calculate_image_frequency_moments(
        _gather(im_list), reference_frequency=reference_frequency, nmoment=nmoment
    )


def calculate_image_list_from_frequency_taylor_terms(
    im_list, moment_image: Image, reference_frequency=None
):
    """Each single-channel image of ``im_list`` rebuilt from a moment cube
    at its own frequency (the reference frequency defaults to the middle
    image's)."""
    if reference_frequency is None:
        frequency = np.array([float(np.asarray(d.frequency)[0]) for d in im_list])
        reference_frequency = frequency[len(frequency) // 2]
    tt = moment_image.pixels
    out = []
    for im in im_list:
        w = moment_weights(im.frequency, reference_frequency, tt.shape[0])
        w = w.to(device=tt.device, dtype=tt.dtype)
        out.append(im.replace(pixels=torch.einsum("cm,mpyx->cpyx", w, tt)))
    return out


def calculate_frequency_taylor_terms_from_image_list(
    im_list, nmoment: int = 1, reference_frequency=None
):
    """Least-squares Taylor terms of a list of single-channel images: one
    single-"channel" image a moment, at the reference frequency."""
    cube = _gather(im_list)
    moments = calculate_frequency_taylor_terms_from_image(
        cube, nmoment=nmoment, reference_frequency=reference_frequency
    )
    if reference_frequency is None:
        frequency = np.asarray(cube.frequency)
        reference_frequency = frequency[len(frequency) // 2]
    return [
        im_list[0].replace(
            pixels=moments.pixels[m : m + 1],
            frequency=np.asarray([reference_frequency], np.float64),
        )
        for m in range(nmoment)
    ]
