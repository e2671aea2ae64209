"""Batched StefCal gain solver, scalar path.

Counterpart of ``ne_index_map``, ``_gain_substitution_scalar``,
``_solve_scalar_one`` and ``solve_gains_core`` in
``ska_sdp_func_python_tpu/ops/solvers.py``. Plain PyTorch, as the JAX
package left it to XLA. All solution intervals iterate together; an
interval whose update changed by less than ``tol`` (or that reached
``niter``) freezes while the others go on, exactly as the JAX
``vmap``-ed ``while_loop`` does. The iteration order, the 0.5 damping,
the reference-antenna phasing and the residual are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import not_ported

__all__ = ["ne_index_map", "solve_gains_core"]


def ne_index_map(a1, a2, nants):
    """Cell (i, j) of the [nants, nants] antenna matrix reads column
    ``ne_idx[i*nants+j]`` of ``[conj(xb); xb; 0]`` (width 2*nbl+1); the
    last write wins, as in the scatter form."""
    nbl = len(a1)
    idx = np.full((nants, nants), 2 * nbl, np.int32)
    k = np.arange(nbl, dtype=np.int32)
    idx[a1, a2] = k
    idx[a2, a1] = k + nbl
    return idx.reshape(-1)


def _symmetrise(x, xwt):
    """Zero the diagonal and mirror: x[i,j] for i<j becomes conj(x[j,i]).
    Batched over a leading interval axis: x ``[nsol, nants, nants, ...]``."""
    nants = x.shape[1]
    extra = (1,) * (x.ndim - 3)
    i = torch.arange(nants, device=x.device).reshape((1, nants, 1) + extra)
    j = torch.arange(nants, device=x.device).reshape((1, 1, nants) + extra)
    xt = x.transpose(1, 2)
    xwtt = xwt.transpose(1, 2)
    x = torch.where(i > j, x, xt.conj())
    xwt = torch.where(i > j, xwt, xwtt)
    diag = i == j
    return torch.where(diag, 0.0, x), torch.where(diag, 0.0, xwt)


def _gain_substitution_scalar(gain, xxwt, ww):
    """g_j <- sum_i g_i x_ij w_ij / sum_i |g_i|^2 w_ij, batched over
    intervals: gain ``[nsol, nants, nchan, 1, 1]``, xxwt/ww
    ``[nsol, nants, nants, nchan]``."""
    g = gain[..., 0, 0]  # [nsol, nants, nchan]
    top = torch.sum(g[:, :, None, :] * xxwt, dim=1)
    bot = torch.sum((g * g.conj()).real[:, :, None, :] * ww, dim=1)
    ok = bot > 0.0
    newg = torch.where(ok, top / torch.where(ok, bot, 1.0), 0.0)
    gwt = torch.where(ok, bot, 0.0)
    return newg[..., None, None], gwt[..., None, None]


def _phase_normalise(gain):
    a = gain.abs()
    ok = a > 0.0
    return torch.where(ok, gain / torch.where(ok, a, 1.0), gain)


def _solution_residual_scalar(gain, x, xwt):
    """RMS weighted residual per interval ``[nsol, nchan, 1, 1]``."""
    g = gain[..., 0, 0]  # [nsol, nants, nchan]
    xx = x[..., 0]
    ww = xwt[..., 0]
    smueller = torch.einsum("sik,sjk->sijk", g.conj(), g)
    error = xx - smueller
    nants = g.shape[1]
    eye = torch.eye(nants, dtype=torch.bool, device=x.device)[None, :, :, None]
    error = torch.where(eye, 0.0, error)
    res = torch.sum((error * ww * error.conj()).real, dim=(1, 2))
    sumwt = torch.sum(ww, dim=(1, 2))
    ok = sumwt > 0.0
    res = torch.where(ok, torch.sqrt(res / torch.where(ok, sumwt, 1.0)), 0.0)
    return res[..., None, None]


def _solve_scalar(x, xwt, gain0, niter, tol, phase_only, refant, damping):
    """Scalar-path solve of every interval: x ``[nsol, nants, nants,
    nchan, 1]``."""
    x, xwt = _symmetrise(x, xwt)
    ww = xwt[..., 0]
    xxwt = x[..., 0] * ww
    nsol = x.shape[0]
    gain = gain0
    gwt = torch.zeros(gain0.shape, dtype=xwt.dtype, device=x.device)
    change = torch.full((nsol,), float("inf"), dtype=xwt.dtype, device=x.device)
    it = 0
    bshape = (nsol,) + (1,) * (gain.ndim - 1)
    while True:
        active = change >= tol
        if it >= niter or not bool(active.any()):
            break
        newgain, newgwt = _gain_substitution_scalar(gain, xxwt, ww)
        if phase_only:
            newgain = _phase_normalise(newgain)
        angles = torch.angle(newgain)
        newgain = newgain * torch.exp(-1j * angles)[:, refant : refant + 1]
        newgain = (1.0 - damping) * newgain + damping * gain
        new_change = (newgain - gain).abs().reshape(nsol, -1).amax(dim=1)
        act = active.reshape(bshape)
        gain = torch.where(act, newgain, gain)
        gwt = torch.where(act, newgwt, gwt)
        change = torch.where(active, new_change, change)
        it += 1
    if phase_only:
        gain = _phase_normalise(gain)
    residual = _solution_residual_scalar(gain, x, xwt)
    return gain, gwt, residual


def solve_gains_core(
    x,
    xwt,
    gain0,
    *,
    niter: int = 200,
    tol: float = 1e-6,
    phase_only: bool = True,
    crosspol: bool = False,
    npol: int = 1,
    refant: int = 0,
    damping: float = 0.5,
):
    """Solve antenna gains from point-source-equivalent visibilities,
    batched over solution intervals.

    :param x: ``[nsol, nants, nants, nchan, npol]`` complex
    :param xwt: matching real weights
    :param gain0: ``[nsol, nants, nchan, nrec, nrec]`` initial gains
    :return: (gain, gwt, residual)
    """
    if npol != 1 or crosspol:
        raise not_ported("matrix (npol > 1) gain solves", "S7x")
    ok = xwt > 0.0
    xn = torch.where(ok, x / torch.where(ok, xwt, 1.0), 0.0)
    wmax = torch.amax(torch.where(ok, xwt, 0.0), dim=(1, 2, 3, 4), keepdim=True)
    wn = torch.where(ok, xwt / torch.where(wmax > 0, wmax, 1.0), 0.0)
    return _solve_scalar(
        xn, wn, gain0, niter, tol, phase_only, refant, damping
    )
