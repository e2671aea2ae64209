"""FFT-coordinate helpers, the prolate spheroidal function and the
Fresnel w-beam.

Counterpart of ``ska_sdp_func_python_tpu/ops/pswf.py``. The coordinate
helpers return tensors on ``device`` (None: the CPU; they are small host
geometry) in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import frac_dot_turns

__all__ = [
    "coordinateBounds",
    "coordinates2Offset",
    "coordinate_bounds",
    "coordinates",
    "coordinates2",
    "coordinates2_offset",
    "grdsf",
    "w_beam",
]


def coordinate_bounds(npixel: int):
    """(first, last) of :func:`coordinates` for ``npixel`` samples."""
    if npixel % 2 == 0:
        return -0.5, 0.5 * (npixel - 2) / npixel
    return -0.5 * (npixel - 1) / npixel, 0.5 * (npixel - 1) / npixel


def _centred(npixel: int, device=None) -> torch.Tensor:
    idx = torch.arange(npixel, dtype=torch.float64, device=device)
    return (idx - npixel // 2) / npixel


def coordinates(npixel: int, device=None) -> torch.Tensor:
    """``[npixel]`` coordinates spanning [-0.5, 0.5) with 0 at
    ``npixel // 2``."""
    return _centred(npixel, device)


def coordinates2(npixel: int, device=None) -> torch.Tensor:
    """(y, x) coordinate grids with 0 at ``npixel // 2``, stacked
    ``[2, npixel, npixel]``."""
    c = _centred(npixel, device)
    return torch.stack(torch.meshgrid(c, c, indexing="ij"))


def coordinates2_offset(npixel: int, cx, cy, quadrant: bool = False, device=None):
    """(y ``[n, 1]``, x ``[1, n]``) coordinates centred on (cx, cy)
    (None: ``npixel // 2``); ``quadrant`` keeps the first ``npixel // 2 +
    1`` of each."""
    cx = npixel // 2 if cx is None else cx
    cy = npixel // 2 if cy is None else cy
    n = npixel // 2 + 1 if quadrant else npixel
    idx = torch.arange(n, dtype=torch.float64, device=device)
    return (idx[:, None] - cy) / npixel, (idx[None, :] - cx) / npixel

# Schwab 'Indirect Imaging' rational-approximation coefficients, m=6 alpha=1
_P = np.array(
    [
        [8.203343e-2, -3.644705e-1, 6.278660e-1, -5.335581e-1, 2.312756e-1],
        [4.028559e-3, -3.697768e-2, 1.021332e-1, -1.201436e-1, 6.412774e-2],
    ]
)
_Q = np.array(
    [
        [1.0000000e0, 8.212018e-1, 2.078043e-1],
        [1.0000000e0, 9.599102e-1, 2.918724e-1],
    ]
)


def grdsf(nu: torch.Tensor):
    """Prolate spheroidal wave function (anti-aliasing kernel), Schwab's
    rational approximation in two parts (|nu| < 0.75, 0.75 <= |nu| <= 1),
    in the dtype and on the device of ``nu``.

    :return: (gridding function, grid-correction function (1-nu^2)*grdsf)
    """
    nu = nu.abs()
    inner = nu < 0.75
    nuend = torch.where(inner, 0.75, 1.0).to(nu.dtype)
    delnusq = nu**2 - nuend**2

    def poly(coeffs):
        val0 = torch.zeros_like(nu)
        val1 = torch.zeros_like(nu)
        for k in range(coeffs.shape[1]):
            val0 = val0 + float(coeffs[0, k]) * delnusq**k
            val1 = val1 + float(coeffs[1, k]) * delnusq**k
        return torch.where(inner, val0, val1)

    top = poly(_P)
    bot = poly(_Q)
    pos = bot > 0.0
    arr = torch.where(pos, top / torch.where(pos, bot, 1.0), 0.0)
    arr = torch.where(nu > 1.0, 0.0, arr)
    return arr, (1 - nu**2) * arr


def w_beam(
    npixel: int,
    field_of_view: float,
    w: torch.Tensor,
    cx=None,
    cy=None,
    remove_shift: bool = False,
) -> torch.Tensor:
    """exp(-2 pi i w (1 - sqrt(1 - l^2 - m^2))) on an ``[npixel, npixel]``
    grid centred on (cx, cy) (None: ``npixel // 2``), in the dtype and on
    the device of the scalar tensor ``w``; ``remove_shift`` divides by the
    value at the last pixel.

    The stable ``1 - sqrt(1-r2) = r2 / (1 + sqrt(1-r2))`` form and the
    split-compensated mod-1 product keep the phase accurate in f32, where
    ``w`` spans thousands of wavelengths."""
    dtype, device = w.dtype, w.device
    cx = npixel // 2 if cx is None else cx
    cy = npixel // 2 if cy is None else cy
    idx = torch.arange(npixel, device=device, dtype=dtype)
    my = -((idx[:, None] - cy) / npixel).abs()
    mx = -((idx[None, :] - cx) / npixel).abs()
    r2 = field_of_view**2 * (my**2 + mx**2)
    r2c = torch.clamp(r2, max=1.0)
    g = r2c / (1.0 + torch.sqrt(1.0 - r2c))
    turns = frac_dot_turns(w.reshape(1, 1, 1), g[..., None])
    ph = -2.0 * np.pi * turns
    ph = torch.where(r2 >= 1.0, 0.0, ph)
    cp = torch.polar(torch.ones_like(ph), ph)
    cp = torch.where(r2 >= 1.0, 0.0, cp)
    cp = torch.where(r2 == 0.0, 1.0, cp)
    if remove_shift:
        cp = cp / cp[-1, -1]
    return cp


# the reference's names
coordinateBounds = coordinate_bounds
coordinates2Offset = coordinates2_offset
