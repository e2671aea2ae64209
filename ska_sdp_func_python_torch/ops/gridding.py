"""Exponential-of-semicircle (ES) gridding kernels and the direct
scatter/gather gridders.

Counterpart of ``ska_sdp_func_python_tpu/ops/gridding.py``: the ES kernel
(Barnett et al. 2019, the family ducc0's wgridder uses) and its image-plane
correction, the periodised continuous Fourier transform of the kernel;
the separable kernel samples of each visibility (``pswf_kernel_weights``)
and the direct gridders on them (``convolutional_grid``, a scatter of S x S
patches, and its adjoint gather ``convolutional_degrid``); and the uv
density grid of the imaging weights (``grid_weights_nearest``) with its
uniform and robust reweighting.

The JAX package computes these scatters with XLA's ``.at[].add``; on the
card a float ``index_add_`` sums in the order of its atomics, so the
port's scatters sum in int64 fixed point (:class:`FixedGrid`) and give
the same bits on every run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "FixedGrid",
    "es_kernel",
    "pswf_kernel_weights",
    "convolutional_grid",
    "convolutional_degrid",
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


class FixedGrid:
    """A flat grid of ``size`` cells, real or complex (``dtype``), summed in
    int64 fixed point: the scatters of the direct gridders and of the
    weight density, the same bits whatever the order of the adds (integer
    sums commute; a float ``index_add_`` on the card rounds in the order of
    its atomics).

    ``bound`` (a 0-d tensor) bounds every part of every cell and partial
    sum; the units are 2^-kg with 2^(61 - kg) > bound, so a cell is its
    exact sum to 2^-60 of the bound, rounded once to ``dtype``. A
    non-finite bound gives a NaN grid."""

    def __init__(self, size: int, bound: torch.Tensor, dtype, device):
        bound = torch.as_tensor(bound, dtype=torch.float64, device=device)
        self.finite = torch.isfinite(bound)
        _, e = torch.frexp(torch.where(self.finite, bound, 0.0))  # bound < 2^e
        one = torch.ones((), dtype=torch.float64, device=device)
        self.scale = torch.ldexp(one, 61 - e)
        self.dtype = dtype
        parts = 2 if dtype.is_complex else 1
        self.acc = torch.zeros((size, parts), dtype=torch.int64, device=device)

    def add(self, index: torch.Tensor, values: torch.Tensor) -> None:
        """cells[index] += values (flat int64 index)."""
        v = values.reshape(-1)
        v = (torch.view_as_real(v) if v.is_complex() else v[:, None]).to(torch.float64)
        q = torch.round(torch.where(self.finite, v * self.scale, 0.0))
        self.acc.index_add_(0, index.reshape(-1), q.to(torch.int64))

    def value(self) -> torch.Tensor:
        """The cells ``[size]`` in ``dtype``."""
        v = self.acc.to(torch.float64) / self.scale
        v = torch.view_as_complex(v) if self.dtype.is_complex else v[:, 0]
        return torch.where(self.finite, v, float("nan")).to(self.dtype)


def pswf_kernel_weights(pix: torch.Tensor, support: int, beta=None):
    """Separable kernel samples at fractional grid positions.

    :param pix: [N] fractional grid coordinates (pixels)
    :param support: kernel full width S (cells)
    :return: (i0 [N] int64 first cell, k [N, S] unnormalised ES kernel
        values at cells i0 .. i0 + S - 1, the position between cells
        half - 1 and half)

    The kernel is not row-normalised: with the periodised continuous-FT
    correction of :func:`grid_correction` the taper does not depend on the
    fractional offset."""
    half = support // 2
    i0 = torch.floor(pix).to(torch.int64) - (half - 1)
    cells = torch.arange(support, device=pix.device)
    offsets = (i0[:, None] + cells[None, :]).to(pix.dtype) - pix[:, None]
    return i0, es_kernel(offsets / half, support, beta)


def _patches(u_pix, v_pix, npixel: int, support: int, beta=None):
    """(flat cell index [N, S, S], kernel products [N, S, S], in-grid mask
    [N]) of every visibility's S x S patch; patches past the grid edge are
    clipped in place and masked."""
    iu0, ku = pswf_kernel_weights(u_pix, support, beta)
    iv0, kv = pswf_kernel_weights(v_pix, support, beta)
    in_grid = (
        (iu0 >= 0) & (iu0 + support <= npixel)
        & (iv0 >= 0) & (iv0 + support <= npixel)
    )
    iu0 = torch.clamp(iu0, 0, npixel - support)
    iv0 = torch.clamp(iv0, 0, npixel - support)
    cells = torch.arange(support, device=u_pix.device)
    rows = iv0[:, None, None] + cells[None, :, None]
    cols = iu0[:, None, None] + cells[None, None, :]
    return rows * npixel + cols, kv[:, :, None] * ku[:, None, :], in_grid


def _abs_sum(values: torch.Tensor) -> torch.Tensor:
    """sum of |re| + |im| in f64: a bound on every cell a scatter of these
    values by kernel products of at most 1 (the ES kernel's peak) gives."""
    return torch.view_as_real(values).abs().sum(dtype=torch.float64)


def convolutional_grid(u_pix, v_pix, vals, npixel: int, support: int = 8):
    """Scatter kernel-weighted values onto an ``[npixel, npixel]`` uv grid
    (the ES kernel at the sigma-2 shape parameter), summed in fixed point
    (:class:`FixedGrid`).

    :param u_pix, v_pix: [N] fractional grid coordinates
    :param vals: [N] complex (already weighted) visibility values
    :return: (grid [npixel, npixel] complex, in_grid mask [N])
    """
    idx, k2, in_grid = _patches(u_pix, v_pix, npixel, support)
    vals = torch.where(in_grid, vals, 0.0)
    grid = FixedGrid(npixel * npixel, _abs_sum(vals), vals.dtype, vals.device)
    grid.add(idx, k2.to(vals.dtype) * vals[:, None, None])
    return grid.value().reshape(npixel, npixel), in_grid


def convolutional_degrid(u_pix, v_pix, grid, support: int = 8):
    """Adjoint of :func:`convolutional_grid`: each visibility's patch of
    ``grid`` weighted by its kernel products and summed. Returns ([N]
    complex values, zero out of the grid; in_grid mask [N])."""
    npixel = grid.shape[-1]
    idx, k2, in_grid = _patches(u_pix, v_pix, npixel, support)
    vals = (grid.reshape(-1)[idx] * k2.to(grid.dtype)).sum(dim=(1, 2))
    return torch.where(in_grid, vals, 0.0), in_grid


def grid_weights_nearest(u_pix, v_pix, weights, npixel: int):
    """Nearest-cell weight density grid with conjugate points. Returns
    (grid [npixel, npixel] real, sumwt).

    The cells sum in fixed point (:class:`FixedGrid`) at a bound on every
    cell, twice the number of weights times the largest |weight|, both
    independent of the order of the inputs: the grid is the same bit for
    bit whatever the order of the entries and of the card's atomics (the
    JAX package's scatter-add and a float ``index_add_`` round in the order
    of the adds). Non-finite weights give a NaN grid."""
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
    bound = (2.0 * max(int(w.numel()), 1)) * (
        w.to(torch.float64).abs().amax() if w.numel()
        else torch.zeros((), dtype=torch.float64)
    )
    grid = FixedGrid(npixel * npixel, bound, weights.dtype, weights.device)
    grid.add(iv * npixel + iu, w)
    grid.add(ivc * npixel + iuc, w)
    return grid.value().reshape(npixel, npixel), 2.0 * torch.sum(w)


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
