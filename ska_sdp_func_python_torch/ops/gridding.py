"""Exponential-of-semicircle (ES) gridding kernel helpers.

Counterpart of ``_es_beta``, ``es_kernel`` and ``grid_correction`` in
``ska_sdp_func_python_tpu/ops/gridding.py``: the ES kernel (Barnett et al.
2019, the family ducc0's wgridder uses) and its image-plane correction,
the periodised continuous Fourier transform of the kernel; and the uv
density grid of the imaging weights (``grid_weights_nearest``) with its
uniform and robust reweighting.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "es_kernel",
    "grid_correction",
    "grid_weights_nearest",
    "reweight_imaging_weights",
]


def _es_beta(support: int, sigma: float = 2.0) -> float:
    """ES shape parameter: 2.3 * support at sigma = 2, scaled for
    fractional padding (same rule as the JAX package)."""
    return 2.3 * support * (1.0 - 1.0 / (2.0 * sigma)) / 0.75


def es_kernel(nu: torch.Tensor, support: int, beta: float | None = None):
    """exp(beta (sqrt(1 - nu^2) - 1)) on nu in [-1, 1], zero outside."""
    if beta is None:
        beta = _es_beta(support)
    nu2 = torch.clamp(nu * nu, 0.0, 1.0)
    k = torch.exp(beta * (torch.sqrt(1.0 - nu2) - 1.0))
    return torch.where(nu.abs() < 1.0, k, 0.0)


def _es_correction_1d(npixel, support, dtype, beta=None, device=None):
    """Periodised continuous FT of the ES kernel on the image grid,
    C(x) = a * int_{-1}^{1} phi(t) cos(2 pi x a t) dt with a = support/2,
    by Gauss-Legendre quadrature, periodised over +-1 cycles."""
    a = support / 2.0
    q, wq = np.polynomial.legendre.leggauss(8 * support)
    q = torch.as_tensor(q, device=device).to(dtype)
    wq = torch.as_tensor(wq, device=device).to(dtype)
    phi = es_kernel(q, support, beta)
    x = (torch.arange(npixel, device=device).to(dtype) - npixel // 2) / npixel

    def ctilde(xx):
        return a * torch.sum(
            (wq * phi)[None, :]
            * torch.cos(2.0 * np.pi * a * xx[:, None] * q[None, :]),
            dim=1,
        )

    return ctilde(x) + ctilde(x + 1.0) + ctilde(x - 1.0)


def grid_correction(
    npixel: int,
    support: int,
    dtype=torch.float64,
    beta: float | None = None,
    device=None,
) -> torch.Tensor:
    """Image-plane taper correction ``[ny, nx]``: divide the FFT image by
    this."""
    c = _es_correction_1d(npixel, support, dtype, beta, device)
    c = torch.where(c.abs() > 1e-30, c, 1.0)
    return torch.outer(c, c)


def grid_weights_nearest(u_pix, v_pix, weights, npixel: int):
    """Nearest-cell weight density grid with conjugate points. Returns
    (grid [npixel, npixel] real, sumwt).

    The cells sum in int64 fixed point, in units of 2^-61 of a bound on
    every cell (twice the number of weights times the largest |weight|,
    both independent of the order of the inputs), and integer sums do not
    depend on the order of the adds: the grid is the same bit for bit
    whatever the order of the entries and of the card's atomics (the JAX
    package's scatter-add and a float ``index_add_`` round in the order of
    the adds). A cell is its exact sum to 2^-61 of the bound, rounded once
    to the weights' dtype. Non-finite weights give a NaN grid."""
    iu = torch.round(u_pix).to(torch.int64)
    iv = torch.round(v_pix).to(torch.int64)
    iuc = npixel - iu
    ivc = npixel - iv
    ok = (
        (iu >= 0) & (iu < npixel) & (iv >= 0) & (iv < npixel)
        & (iuc >= 0) & (iuc < npixel) & (ivc >= 0) & (ivc < npixel)
    )
    w = torch.where(ok, weights, 0.0)
    iu, iv, iuc, ivc = (torch.clamp(a, 0, npixel - 1) for a in (iu, iv, iuc, ivc))
    w64 = w.to(torch.float64)
    bound = (2.0 * max(int(w.numel()), 1)) * (
        w64.abs().amax() if w.numel() else torch.zeros((), dtype=torch.float64)
    )
    finite = torch.isfinite(bound)
    _, e = torch.frexp(torch.where(finite, bound, 0.0))  # bound < 2^e
    unit = torch.ldexp(torch.ones((), dtype=torch.float64, device=w.device), e - 61)
    q = torch.round(torch.where(finite, w64, 0.0) / unit).to(torch.int64)
    grid = torch.zeros(npixel * npixel, dtype=torch.int64, device=weights.device)
    grid.index_add_(0, iv * npixel + iu, q)
    grid.index_add_(0, ivc * npixel + iuc, q)
    grid = torch.where(finite, grid.to(torch.float64) * unit, float("nan"))
    return grid.to(weights.dtype).reshape(npixel, npixel), 2.0 * torch.sum(w)


def reweight_imaging_weights(
    u_pix,
    v_pix,
    weights,
    density_grid,
    weighting: str = "uniform",
    robustness: float = 0.0,
    sumwt=None,
):
    """Uniform or Briggs-robust density reweighting of ``weights`` (same
    contract as the JAX package's): uniform divides each weight by its
    cell's density; robust (Briggs 1995, eq. 3.15-3.16) by ``1 + f^2
    density`` with ``f^2 = (5 10^-robustness)^2 sumwt / sum(density^2)``,
    ``sumwt`` defaulting to twice the sum of the weights; "natural"
    returns the weights."""
    if weighting == "natural":
        return weights
    npixel = density_grid.shape[-1]
    ru, rv = torch.round(u_pix), torch.round(v_pix)
    iu = torch.clamp(ru.to(torch.int64), 0, npixel - 1)
    iv = torch.clamp(rv.to(torch.int64), 0, npixel - 1)
    ok = (ru >= 0) & (ru < npixel) & (rv >= 0) & (rv < npixel)
    gdwt = density_grid[iv, iu]
    pos = gdwt > 0.0
    if weighting == "uniform":
        new = torch.where(pos, weights / torch.where(pos, gdwt, 1.0), 0.0)
    elif weighting == "robust":
        sumlocwt = torch.sum(density_grid**2)
        if sumwt is None:
            sumwt = 2.0 * torch.sum(weights)
        f2 = (5.0 * 10.0 ** (-robustness)) ** 2 * sumwt / sumlocwt
        new = torch.where(pos, weights / (1.0 + f2 * gdwt), 0.0)
    else:
        raise ValueError(f"Unknown weighting {weighting}")
    return torch.where(ok, new, 0.0)
