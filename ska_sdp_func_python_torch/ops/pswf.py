"""The prolate spheroidal function and the Fresnel w-beam.

Counterpart of ``grdsf`` and ``w_beam`` in
``ska_sdp_func_python_tpu/ops/pswf.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import frac_dot_turns, not_ported

__all__ = ["grdsf", "w_beam"]

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
    remove_shift: bool = False,
) -> torch.Tensor:
    """exp(-2 pi i w (1 - sqrt(1 - l^2 - m^2))) on an ``[npixel, npixel]``
    grid, in the dtype and on the device of the scalar tensor ``w``.

    The stable ``1 - sqrt(1-r2) = r2 / (1 + sqrt(1-r2))`` form and the
    split-compensated mod-1 product keep the phase accurate in f32, where
    ``w`` spans thousands of wavelengths."""
    if remove_shift:
        raise not_ported("w_beam(remove_shift=True)", "S11")
    dtype, device = w.dtype, w.device
    c = npixel // 2
    idx = torch.arange(npixel, device=device, dtype=dtype)
    my = -((idx[:, None] - c) / npixel).abs()
    mx = -((idx[None, :] - c) / npixel).abs()
    r2 = field_of_view**2 * (my**2 + mx**2)
    r2c = torch.clamp(r2, max=1.0)
    g = r2c / (1.0 + torch.sqrt(1.0 - r2c))
    turns = frac_dot_turns(w.reshape(1, 1, 1), g[..., None])
    ph = -2.0 * np.pi * turns
    ph = torch.where(r2 >= 1.0, 0.0, ph)
    cp = torch.polar(torch.ones_like(ph), ph)
    cp = torch.where(r2 >= 1.0, 0.0, cp)
    return torch.where(r2 == 0.0, 1.0, cp)
