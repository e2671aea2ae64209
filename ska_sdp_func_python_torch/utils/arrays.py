"""Array helpers: the port's own copy of the JAX package's
``utils/arrays.py``.

``tukey_filter`` serves the Tukey uv taper (``ops.weighting``) and the
facet tapers of the image iterators (``ops.image_iterators``); the
insertion functions serve ``ops.skycomponent_ops.insert_skycomponent``.
Every function takes tensors (or anything ``torch.as_tensor`` takes) and
keeps their dtype and device.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "average_chunks",
    "average_chunks2",
    "tukey_filter",
    "insert_function_sinc",
    "insert_function_L",
    "insert_function_pswf",
    "insert_array",
]


def _average_last(arr, wts, chunksize: int):
    """Weighted means of chunks of ``chunksize`` along the last axis (the
    last chunk may be short), and the chunks' weight sums; a chunk of zero
    weight keeps its (zero) weighted sum."""
    n = arr.shape[-1]
    nchunks = (n - 1) // chunksize + 1
    pad = nchunks * chunksize - n
    wa = torch.nn.functional.pad(wts.to(arr.dtype) * arr, (0, pad))
    w = torch.nn.functional.pad(wts, (0, pad))
    chunks = wa.reshape(*arr.shape[:-1], nchunks, chunksize).sum(-1)
    weights = w.reshape(*wts.shape[:-1], nchunks, chunksize).sum(-1)
    ok = weights > 0.0
    avg = torch.where(ok, chunks / torch.where(ok, weights, 1.0).to(chunks.dtype), chunks)
    return avg, weights


def average_chunks(arr, wts, chunksize: int):
    """Weighted average of the 1-D ``arr`` in chunks of ``chunksize`` (the
    length need not be a multiple of it). Returns (averages, weight
    sums); ``chunksize`` <= 1 returns the inputs."""
    arr, wts = torch.as_tensor(arr), torch.as_tensor(wts)
    if chunksize <= 1:
        return arr, wts
    return _average_last(arr, wts, chunksize)


def average_chunks2(arr, wts, chunksize):
    """2-D chunked weighted averaging, ``chunksize`` (cy, cx): chunks of cx
    along the second axis, then of cy along the first, carrying the
    weights. Returns (averages, weight sums)."""
    arr = torch.as_tensor(arr)
    wts = torch.as_tensor(wts).reshape(arr.shape)
    cy, cx = chunksize
    if cx > 1:
        arr, wts = _average_last(arr, wts, cx)
    if cy > 1:
        a, w = _average_last(arr.T, wts.T, cy)
        arr, wts = a.T, w.T
    return arr, wts


def tukey_filter(x, r):
    """Tukey (tapered cosine) filter of ``x`` in [0, 1] with taper
    fraction ``r``, elementwise: a half-cosine rise over [0, r/2), 1 in
    the middle and a half-cosine fall over [1 - r/2, 1]. Takes a tensor
    (keeps its dtype and device) or anything ``torch.as_tensor`` takes.

    The phase is scaled by the host's 2 pi / r, not divided by r: on the
    card a division by a host scalar multiplies by its reciprocal, so a
    division would round differently from the CPU's."""
    x = torch.as_tensor(x)
    scale = 2.0 * math.pi / r
    lo = 0.5 * (1.0 + torch.cos((x - r / 2.0) * scale))
    hi = 0.5 * (1.0 + torch.cos((x - 1 + r / 2.0) * scale))
    out = torch.ones_like(x)
    out = torch.where((x >= 0.0) & (x < r / 2.0), lo, out)
    return torch.where((x >= 1 - r / 2.0) & (x <= 1.0), hi, out)


def insert_function_sinc(x):
    """sinc(x) = sin(pi x) / (pi x), and 0 at x = 0 (the JAX package's
    rule)."""
    x = torch.as_tensor(x)
    return torch.where(x != 0.0, torch.sinc(x), 0.0)


def insert_function_L(x, a: int = 5):
    """The Lanczos kernel sinc(x) sinc(x / a)."""
    return insert_function_sinc(x) * insert_function_sinc(torch.as_tensor(x) / a)


def insert_function_pswf(x, a: int = 5):
    """The grid-correction PSWF at |x| / a."""
    from ..ops.pswf import grdsf

    return grdsf(torch.as_tensor(x).abs() / a)[1]


def insert_array(
    im,
    x,
    y,
    flux,
    bandwidth: float = 1.0,
    support: int = 7,
    insert_function=insert_function_L,
):
    """Add a point of ``flux [nchan, npol]`` at the fractional pixel (x,
    y) of the image cube ``im [nchan, npol, ny, nx]`` through a normalised
    separable window of ``insert_function`` over 2 ``support`` pixels a
    side, centred on the nearest pixel. The JAX package's edge rule
    (``lax.dynamic_slice``'s): a start before the image's first row or
    column counts from its end, and the start is then clamped so that the
    window lies in the image; a window past the far edge is moved in, and
    one before the near edge lands on the far one. Returns the new cube."""
    im = torch.as_tensor(im)
    flux = torch.as_tensor(flux, device=im.device)
    real = im.real.dtype if im.is_complex() else im.dtype
    x, y = float(x), float(y)
    intx, inty = round(x), round(y)  # round half to even, as jnp.round
    grid = torch.arange(-support, support, device=im.device, dtype=torch.float64)
    ky = insert_function(bandwidth * (grid - (y - inty)))
    kx = insert_function(bandwidth * (grid - (x - intx)))
    kernel = torch.outer(ky, kx)
    kernel = kernel / kernel.sum()
    patch = flux[:, :, None, None] * kernel.to(real)[None, None]
    ny, nx = im.shape[-2:]
    y0, x0 = inty - support, intx - support
    y0 = min(max(y0 + ny if y0 < 0 else y0, 0), ny - 2 * support)
    x0 = min(max(x0 + nx if x0 < 0 else x0, 0), nx - 2 * support)
    out = im.clone()
    out[:, :, y0 : y0 + 2 * support, x0 : x0 + 2 * support] += patch.to(im.dtype)
    return out
