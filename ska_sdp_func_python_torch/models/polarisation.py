"""Polarisation frames: the stokesI frame of the ported slice.

Counterpart of ``ska_sdp_func_python_tpu/models/polarisation.py``. Only the
stokesI frame is ported; every other frame raises.
"""

from __future__ import annotations

import torch

from ..config import not_ported

__all__ = ["npol", "convert_pol_frame"]

_FRAMES = {"stokesI": ["I"]}


def _name(frame) -> str:
    return getattr(frame, "name", str(frame))


def npol(frame) -> int:
    name = _name(frame)
    if name not in _FRAMES:
        raise not_ported(f"polarisation frame {name!r}", "S7x")
    return len(_FRAMES[name])


def convert_pol_frame(data: torch.Tensor, src, dst, polaxis: int = -1):
    """Convert ``data`` from frame ``src`` to ``dst`` along ``polaxis``;
    stokesI to stokesI is the identity."""
    src, dst = _name(src), _name(dst)
    if src == dst == "stokesI":
        return data
    raise not_ported(f"conversion {src} -> {dst}", "S7x")
