"""Centred 2-D FFT helpers on ``torch.fft``.

Counterpart of ``ska_sdp_func_python_tpu/ops/fft.py`` (the JAX package
leaves its FFTs to XLA; the port leaves them to cuFFT through torch.fft).
Convention: ``fft`` = fftshift(fft2(ifftshift(.))) over the last two axes;
``ifft`` is the inverse with 1/N normalisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fft", "ifft", "pad_mid", "extract_mid", "extract_oversampled"]

_AXES = (-2, -1)


def fft(a: torch.Tensor) -> torch.Tensor:
    """Image (lm) -> grid (uv) space, centred, over the last two axes."""
    return torch.fft.fftshift(
        torch.fft.fft2(torch.fft.ifftshift(a, dim=_AXES), dim=_AXES),
        dim=_AXES,
    )


def ifft(a: torch.Tensor) -> torch.Tensor:
    """Grid (uv) -> image (lm) space, centred, over the last two axes."""
    return torch.fft.fftshift(
        torch.fft.ifft2(torch.fft.ifftshift(a, dim=_AXES), dim=_AXES),
        dim=_AXES,
    )


def pad_mid(ff: torch.Tensor, npixel: int) -> torch.Tensor:
    """Zero-pad the last two axes to ``npixel`` keeping the centre pixel at
    ``npixel//2``."""
    ny, nx = ff.shape[-2:]
    if npixel == nx and npixel == ny:
        return ff
    if npixel < nx or npixel < ny:
        raise ValueError(f"pad_mid: target {npixel} smaller than {ff.shape}")
    y0 = npixel // 2 - ny // 2
    x0 = npixel // 2 - nx // 2
    return F.pad(ff, (x0, npixel - nx - x0, y0, npixel - ny - y0))


def extract_mid(a: torch.Tensor, npixel: int) -> torch.Tensor:
    """The central ``npixel`` section of the last two axes."""
    ny, nx = a.shape[-2:]
    cy, cx = ny // 2, nx // 2
    s = npixel // 2
    if npixel % 2 != 0:
        return a[..., cy - s : cy + s + 1, cx - s : cx + s + 1]
    return a[..., cy - s : cy + s, cx - s : cx + s]


def extract_oversampled(
    a: torch.Tensor, xf: int, yf: int, kernel_oversampling: int, kernelwidth: int
) -> torch.Tensor:
    """The ``kernelwidth``^2 kernel at sub-pixel offset (xf, yf) of an
    oversampled ``[n, n]`` parent: every ``kernel_oversampling``-th sample
    from the centre less the offset, scaled by the oversampling squared."""
    npixela = a.shape[0]
    ov = kernel_oversampling
    my = npixela // 2 - ov * (kernelwidth // 2) - yf
    mx = npixela // 2 - ov * (kernelwidth // 2) - xf
    mid = a[my : my + ov * kernelwidth : ov, mx : mx + ov * kernelwidth : ov]
    return ov * ov * mid
