"""Polarisation frames and the conversions between them.

Counterpart of ``ska_sdp_func_python_tpu/models/polarisation.py``, with the
same frame table, matrices and special cases. Frames are plain strings;
every function also takes a :class:`PolarisationFrame` (or any object
with a ``name``).
A conversion is a small complex matmul along ``polaxis`` in the data's
own precision (complex128 for f64 or c128 data, else complex64).

Conventions (Hamaker/RASCIL):
    linear   = [XX, XY, YX, YY],   XX = I+Q, XY = U+iV, YX = U-iV, YY = I-Q
    circular = [RR, RL, LR, LL],   RR = I+V, RL = Q+iU, LR = Q-iU, LL = I-V
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import complex_of

__all__ = [
    "PolarisationFrame",
    "pol_names",
    "npol",
    "convert_pol_frame",
    "convert_linear_to_stokes",
    "convert_stokes_to_linear",
    "convert_circular_to_stokes",
    "convert_stokes_to_circular",
    "convert_linear_to_stokesI",
    "convert_circular_to_stokesI",
    "convert_stokesI_to_polframe",
    "correlate_polarisation",
    "congruent_polarisation",
]

# frame name -> ordered correlation or Stokes labels
_FRAMES = {
    "circular": ["RR", "RL", "LR", "LL"],
    "circularnp": ["RR", "LL"],
    "linear": ["XX", "XY", "YX", "YY"],
    "linearnp": ["XX", "YY"],
    "stokesIQUV": ["I", "Q", "U", "V"],
    "stokesIV": ["I", "V"],
    "stokesIQ": ["I", "Q"],
    "stokesI": ["I"],
}

# the conversion matrices in the Stokes [I, Q, U, V] basis
_STOKES_TO_LINEAR = np.array(
    [[1, 1, 0, 0], [0, 0, 1, 1j], [0, 0, 1, -1j], [1, -1, 0, 0]], dtype=complex
)
_LINEAR_TO_STOKES = np.linalg.inv(_STOKES_TO_LINEAR)
_STOKES_TO_CIRCULAR = np.array(
    [[1, 0, 0, 1], [0, 1, 1j, 0], [0, 1, -1j, 0], [1, 0, 0, -1]], dtype=complex
)
_CIRCULAR_TO_STOKES = np.linalg.inv(_STOKES_TO_CIRCULAR)

# the reduced frames' positions in their four-polarisation frame
_SUBSETS = {
    "linearnp": [0, 3],
    "circularnp": [0, 3],
    "stokesIQ": [0, 1],
    "stokesIV": [0, 3],
    "stokesI": [0],
}


class PolarisationFrame:
    """A validated frame name with its polarisation labels: immutable,
    hashable, and equal to its name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        object.__setattr__(self, "name", _check(frame_name(name)))

    def __setattr__(self, *_):
        raise AttributeError("PolarisationFrame is immutable")

    @property
    def names(self) -> list:
        return list(_FRAMES[self.name])

    @property
    def npol(self) -> int:
        return len(_FRAMES[self.name])

    def __eq__(self, other):
        return self.name == frame_name(other)

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"PolarisationFrame({self.name!r})"


def frame_name(frame) -> str:
    """A frame's name, from the name itself or an object with ``name``."""
    return getattr(frame, "name", str(frame))


def _check(name: str) -> str:
    if name not in _FRAMES:
        raise ValueError(f"Unknown polarisation frame {name!r}")
    return name


def pol_names(frame) -> list:
    return list(_FRAMES[_check(frame_name(frame))])


def npol(frame) -> int:
    return len(_FRAMES[_check(frame_name(frame))])


def _apply_matrix(mat: np.ndarray, data: torch.Tensor, polaxis: int):
    """``mat`` [n_out, n_in] contracted against ``polaxis`` of ``data``,
    in the complex dtype of the data's precision."""
    cdtype = complex_of(data.dtype)
    m = torch.as_tensor(mat, device=data.device).to(cdtype)
    moved = torch.movedim(data.to(cdtype), polaxis, -1)
    return torch.movedim(moved @ m.T, -1, polaxis)


def convert_linear_to_stokes(data, polaxis: int = -1):
    return _apply_matrix(_LINEAR_TO_STOKES, data, polaxis)


def convert_stokes_to_linear(data, polaxis: int = -1):
    return _apply_matrix(_STOKES_TO_LINEAR, data, polaxis)


def convert_circular_to_stokes(data, polaxis: int = -1):
    return _apply_matrix(_CIRCULAR_TO_STOKES, data, polaxis)


def convert_stokes_to_circular(data, polaxis: int = -1):
    return _apply_matrix(_STOKES_TO_CIRCULAR, data, polaxis)


def parallel_hands_to_stokesI(data: torch.Tensor) -> torch.Tensor:
    """[..., 4 or 2] linear or circular correlations -> [..., 1]: the mean
    of the parallel hands (XX, YY or RR, LL), Stokes I."""
    j = 1 if data.shape[-1] == 2 else 3
    return (0.5 * (data[..., 0] + data[..., j]))[..., None]


# the JAX package's names: both frames take the same mean
convert_linear_to_stokesI = convert_circular_to_stokesI = parallel_hands_to_stokesI


def convert_stokesI_to_polframe(data, frame):
    """Stokes I ``[..., 1+]`` -> ``frame``: every polarisation copies I,
    and a four-polarisation frame zeroes its second and third (the JAX
    package's semantics, for the Stokes frames too)."""
    n = npol(frame)
    out = data[..., :1].repeat_interleave(n, dim=-1)
    if n == 4:
        out[..., 1:3] = 0.0
    return out


def _conversion_matrix(src: str, dst: str):
    """The conversion matrix [npol_dst, npol_src], or None for the
    identity."""
    if src == dst:
        return None

    def full(frame):
        if frame in ("linear", "linearnp"):
            return _STOKES_TO_LINEAR, "linear"
        if frame in ("circular", "circularnp"):
            return _STOKES_TO_CIRCULAR, "circular"
        return np.eye(4, dtype=complex), "stokes"

    src_mat, src_fam = full(src)
    dst_mat, dst_fam = full(dst)
    if src_fam == dst_fam != "stokes" and _SUBSETS.get(src) == _SUBSETS.get(dst):
        return None
    # src frame -> Stokes IQUV -> dst frame; a reduced frame reads or
    # writes its rows of the four-polarisation map (missing ones zero)
    m = dst_mat @ np.linalg.inv(src_mat)
    if src in _SUBSETS:
        m = m[:, _SUBSETS[src]]
    if dst in _SUBSETS:
        m = m[_SUBSETS[dst], :]
    return m


def convert_pol_frame(data: torch.Tensor, src, dst, polaxis: int = -1):
    """Convert ``data`` from polarisation frame ``src`` to ``dst`` along
    ``polaxis``; a frame to itself is the identity."""
    src, dst = _check(frame_name(src)), _check(frame_name(dst))
    if src == dst:
        return data
    if dst == "stokesI":
        moved = torch.movedim(data, polaxis, -1)
        if src in ("linear", "linearnp", "circular", "circularnp"):
            out = parallel_hands_to_stokesI(moved)
        elif src == "stokesIQUV":
            out = moved[..., :1]
        else:
            raise ValueError(f"Cannot convert {src} -> stokesI")
        return torch.movedim(out, -1, polaxis)
    if src == "stokesI":
        moved = torch.movedim(data, polaxis, -1)
        return torch.movedim(convert_stokesI_to_polframe(moved, dst), -1, polaxis)
    mat = _conversion_matrix(src, dst)
    if mat is None:
        return data
    return _apply_matrix(mat, data, polaxis)


def correlate_polarisation(frame) -> str:
    """Stokes frame -> the correlation frame an interferometer measures."""
    return {
        "stokesI": "stokesI",
        "stokesIQUV": "linear",
        "stokesIQ": "linearnp",
        "stokesIV": "circularnp",
    }[frame_name(frame)]


def congruent_polarisation(vis_frame, image_frame) -> bool:
    """True if the visibility frame's polarisations map one to one onto
    the image frame's."""
    fam = {
        "linear": "linear",
        "linearnp": "linear",
        "circular": "circular",
        "circularnp": "circular",
    }
    v, i = frame_name(vis_frame), frame_name(image_frame)
    return fam.get(v, v) == fam.get(i, i)
