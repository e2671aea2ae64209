"""Array helpers: the port's own copy of what it needs from the JAX
package's ``utils/arrays.py``.

``tukey_filter`` serves the Tukey uv taper (``ops.weighting``) and the
facet tapers of the image iterators (``ops.image_iterators``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["tukey_filter"]


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
