"""Image facet and channel iterators, scatter and gather.

Counterpart of ``ska_sdp_func_python_tpu/ops/image_iterators.py``: facets
with overlap and a taper (flat, linear, quadratic or tukey), gathered back
with the summed taper as the normaliser, and channel subsets. Plain
PyTorch; the tapers are computed on the host in f64, as the JAX package
computes them in numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.image import Image
from ..utils.arrays import tukey_filter

__all__ = [
    "image_raster_iter",
    "image_channel_iter",
    "image_scatter_facets",
    "image_gather_facets",
    "image_scatter_channels",
    "image_gather_channels",
    "image_raster_update",
]


def _facet_slices(npixel: int, facets: int, overlap: int):
    """(start, stop) pixel ranges of each facet along one axis."""
    step = npixel // facets
    return [
        (max(0, i * step - overlap), min(npixel, (i + 1) * step + overlap))
        for i in range(facets)
    ]


def _taper_1d(width: int, overlap: int, taper: str) -> np.ndarray:
    """Taper weights across one facet axis: 1, with ramps of ``overlap``
    pixels at both ends."""
    w = np.ones(width)
    if overlap <= 0 or taper in (None, "flat"):
        return w
    ramp = np.arange(1, overlap + 1) / (overlap + 1.0)
    if taper == "quadratic":
        ramp = ramp**2
    elif taper == "tukey":
        x = np.arange(1, overlap + 1) / (2.0 * overlap + 1.0)
        ramp = tukey_filter(torch.as_tensor(x), 1.0).numpy()
    elif taper != "linear":
        raise ValueError(f"Unknown taper {taper}")
    w[:overlap] = ramp
    w[-overlap:] = ramp[::-1]
    return w


def _flat(ny: int, nx: int, overlap: int, taper: str, like: torch.Tensor):
    """The facet's taper image ``[ny, nx]`` in the dtype and on the device
    of ``like``."""
    flat = np.outer(_taper_1d(ny, overlap, taper), _taper_1d(nx, overlap, taper))
    return torch.as_tensor(flat, device=like.device).to(like.dtype)


def image_raster_iter(
    im: Image,
    facets: int = 1,
    overlap: int = 0,
    taper: str = "flat",
    make_flat: bool = False,
):
    """Facet images in raster order (views of ``im``'s pixels), each
    ``overlap`` pixels wider on each inner side; with ``make_flat`` the
    facets' taper images instead. A facet keeps the image's phase centre;
    its place is its index in the raster."""
    ny, nx = im.pixels.shape[-2:]
    if nx % facets or ny % facets:
        raise ValueError("Facets must divide the image size")
    for ylo, yhi in _facet_slices(ny, facets, overlap):
        for xlo, xhi in _facet_slices(nx, facets, overlap):
            sub = im.pixels[..., ylo:yhi, xlo:xhi]
            if make_flat:
                flat = _flat(yhi - ylo, xhi - xlo, overlap, taper, im.pixels)
                sub = flat.expand(sub.shape)
            yield im.replace(pixels=sub)


def image_channel_iter(im: Image, subimages: int = 1):
    """Images of ``subimages`` channel subsets in order (the last takes
    the remainder)."""
    step = im.nchan // subimages
    for i in range(subimages):
        lo = i * step
        hi = im.nchan if i == subimages - 1 else (i + 1) * step
        yield im.replace(
            pixels=im.pixels[lo:hi],
            frequency=im.frequency[lo:hi],
            channel_bandwidth=im.channel_bandwidth[lo:hi],
        )


def image_scatter_facets(
    im: Image, facets: int = 1, overlap: int = 0, taper: str = "flat"
) -> List[Image]:
    """The list of :func:`image_raster_iter`'s facets."""
    return list(image_raster_iter(im, facets=facets, overlap=overlap, taper=taper))


def image_gather_facets(
    image_list: List[Image],
    im: Image,
    facets: int = 1,
    overlap: int = 0,
    taper: str = "flat",
    return_flat: bool = False,
) -> Image:
    """``im`` with its pixels reassembled from the facets: each facet
    times its taper, summed, over the summed tapers (0 where they are);
    with ``return_flat`` the summed tapers themselves."""
    ny, nx = im.pixels.shape[-2:]
    out = torch.zeros_like(im.pixels)
    flat_sum = torch.zeros(
        (ny, nx), dtype=im.pixels.dtype, device=im.pixels.device
    )
    k = 0
    for ylo, yhi in _facet_slices(ny, facets, overlap):
        for xlo, xhi in _facet_slices(nx, facets, overlap):
            flat = _flat(yhi - ylo, xhi - xlo, overlap, taper, im.pixels)
            out[..., ylo:yhi, xlo:xhi] += image_list[k].pixels * flat
            flat_sum[ylo:yhi, xlo:xhi] += flat
            k += 1
    if return_flat:
        return im.replace(pixels=flat_sum.expand(im.pixels.shape).clone())
    out = out / torch.where(flat_sum > 0, flat_sum, 1.0)
    return im.replace(pixels=out)


def image_scatter_channels(im: Image, subimages: int = None) -> List[Image]:
    """The channel subsets of :func:`image_channel_iter` (default: one
    image a channel)."""
    if subimages is None:
        subimages = im.nchan
    return list(image_channel_iter(im, subimages=subimages))


def image_gather_channels(image_list: List[Image]) -> Image:
    """One image of all the channels of ``image_list``, in order."""
    return image_list[0].replace(
        pixels=torch.cat([im.pixels for im in image_list], dim=0),
        frequency=np.concatenate([im.frequency for im in image_list]),
        channel_bandwidth=np.concatenate([im.channel_bandwidth for im in image_list]),
    )


def image_raster_update(
    im: Image,
    fn,
    facets: int = 1,
    overlap: int = 0,
    taper: str = "flat",
) -> Image:
    """``fn`` applied to each facet of :func:`image_raster_iter`, and the
    results gathered back with the taper (the JAX package's functional
    form of the reference's in-place facet update)."""
    updated = [
        fn(facet)
        for facet in image_raster_iter(im, facets=facets, overlap=overlap, taper=taper)
    ]
    return image_gather_facets(updated, im, facets=facets, overlap=overlap, taper=taper)
