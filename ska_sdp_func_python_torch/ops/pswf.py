"""The Fresnel w-beam of the w-stacking tail.

Counterpart of ``w_beam`` in ``ska_sdp_func_python_tpu/ops/pswf.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import frac_dot_turns, not_ported

__all__ = ["w_beam"]


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
