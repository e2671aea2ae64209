"""Batched StefCal gain solver (the scalar and the 2x2 matrix lanes) and
the gaintable solve.

Counterpart of ``ne_index_map``, the gain substitutions, the per-lane
solves, ``solve_gains_core``, ``build_normal_equations`` and
``solve_gaintable`` in ``ska_sdp_func_python_tpu/ops/solvers.py``. Plain
PyTorch, as the JAX package left it to XLA. All solution intervals
iterate together; an interval whose update changed by less than ``tol``
(or that reached ``niter``) freezes while the others go on, exactly as
the JAX ``vmap``-ed ``while_loop`` does. The iteration order, the 0.5
damping, the reference-antenna phasing (scalar lane) and the residuals
are the JAX package's. The matrix lane substitutes every entry of the
2x2 gains on its own, as broadcast products summed over the antennas,
not as matrix products.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaintable import GainTable, create_gaintable_from_visibility
from ..models.visibility import Visibility
from .visibility_ops import divide_visibility

__all__ = [
    "ne_index_map",
    "solve_gains_core",
    "build_normal_equations",
    "solve_gaintable",
]


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


def _gain_substitution_matrix(gain, wx, w):
    """Entrywise 2x2 substitution, batched over intervals: gain ``[nsol,
    nants, nchan, 2, 2]``; ``wx`` = w x and ``w`` (off-diagonal-masked
    weights) ``[nsol, nants, nants, nchan, 2, 2]``. top_j = sum_i w_ij
    x_ij g_i, bot_i = sum_j w_ij |g_j|^2; the weight is the unmasked
    bot."""
    top = torch.sum(wx * gain[:, :, None], dim=1)
    bot = torch.sum(w * (gain * gain.conj()).real[:, None], dim=2)
    ok = bot > 0.0
    newg = torch.where(ok, top / torch.where(ok, bot, 1.0), 0.0)
    return newg, bot


def _solution_residual_matrix(gain, x, xwt):
    """RMS weighted residual per interval and 2x2 entry ``[nsol, nchan, 2,
    2]``: x_ij - conj(g_i) g_j entrywise."""
    d = x - gain.conj()[:, :, None] * gain[:, None, :]
    res = torch.sum((d.conj() * xwt * d).real, dim=(1, 2))
    sumwt = torch.sum(xwt, dim=(1, 2))
    ok = sumwt > 0.0
    return torch.where(ok, torch.sqrt(res / torch.where(ok, sumwt, 1.0)), 0.0)


def _iterate(gain, gwt, step, niter, tol):
    """The batched StefCal loop: ``step(gain) -> (new gain, new weight,
    change)`` until every interval's change is below ``tol`` or ``niter``
    passes; a converged interval keeps its state while the others go
    on. The convergence test reads the host once a pass."""
    nsol = gain.shape[0]
    change = torch.full((nsol,), float("inf"), dtype=gwt.dtype, device=gain.device)
    bshape = (nsol,) + (1,) * (gain.ndim - 1)
    it = 0
    while True:
        active = change >= tol
        if it >= niter or not bool(active.any()):
            break
        newgain, newgwt, new_change = step(gain)
        act = active.reshape(bshape)
        gain = torch.where(act, newgain, gain)
        gwt = torch.where(act, newgwt, gwt)
        change = torch.where(active, new_change, change)
        it += 1
    return gain, gwt


def _solve_matrix(x, xwt, gain0, niter, tol, phase_only):
    """Matrix-lane solve of every interval: x ``[nsol, nants, nants,
    nchan, 2, 2]`` (an npol-2 problem already embedded). The start has
    its off-diagonal gains zeroed; the change is taken before the 0.5
    damping."""
    x, xwt = _symmetrise(x, xwt)
    gain = gain0.clone()
    gain[..., 0, 1] = 0.0
    gain[..., 1, 0] = 0.0
    nsol, nants = x.shape[:2]
    offdiag = ~torch.eye(nants, dtype=torch.bool, device=x.device)
    w = xwt * offdiag[None, :, :, None, None, None].to(xwt.dtype)
    wx = w * x

    def step(g):
        newg, newgwt = _gain_substitution_matrix(g, wx, w)
        if phase_only:
            newg = _phase_normalise(newg)
        change = (newg - g).abs().reshape(nsol, -1).amax(dim=1)
        return 0.5 * (newg + g), newgwt, change

    gwt0 = torch.zeros(gain0.shape, dtype=xwt.dtype, device=x.device)
    gain, gwt = _iterate(gain, gwt0, step, niter, tol)
    wx = w = None  # the residual needs neither: free them first
    return gain, gwt, _solution_residual_matrix(gain, x, xwt)


def _solve_scalar(x, xwt, gain0, niter, tol, phase_only, refant, damping):
    """Scalar-path solve of every interval: x ``[nsol, nants, nants,
    nchan, 1]``."""
    x, xwt = _symmetrise(x, xwt)
    ww = xwt[..., 0]
    xxwt = x[..., 0] * ww
    nsol = x.shape[0]

    def step(g):
        newgain, newgwt = _gain_substitution_scalar(g, xxwt, ww)
        if phase_only:
            newgain = _phase_normalise(newgain)
        angles = torch.angle(newgain)
        newgain = newgain * torch.exp(-1j * angles)[:, refant : refant + 1]
        newgain = (1.0 - damping) * newgain + damping * g
        change = (newgain - g).abs().reshape(nsol, -1).amax(dim=1)
        return newgain, newgwt, change

    gwt0 = torch.zeros(gain0.shape, dtype=xwt.dtype, device=x.device)
    gain, gwt = _iterate(gain0, gwt0, step, niter, tol)
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

    npol 1 runs the scalar lane (``crosspol`` too, as in the JAX
    package). npol 2 and 4 run the matrix lane: npol 2 embedded into a
    diagonal 4-pol problem, npol 4 with XY/YX zeroed unless ``crosspol``
    keeps all four.
    """
    ok = xwt > 0.0
    xn = torch.where(ok, x / torch.where(ok, xwt, 1.0), 0.0)
    wmax = torch.amax(torch.where(ok, xwt, 0.0), dim=(1, 2, 3, 4), keepdim=True)
    wn = torch.where(ok, xwt / torch.where(wmax > 0, wmax, 1.0), 0.0)
    if npol == 1:
        return _solve_scalar(
            xn, wn, gain0, niter, tol, phase_only, refant, damping
        )
    if npol == 2:
        z, zw = torch.zeros_like(xn[..., 0]), torch.zeros_like(wn[..., 0])
        xn = torch.stack([xn[..., 0], z, z, xn[..., 1]], dim=-1)
        wn = torch.stack([wn[..., 0], zw, zw, wn[..., 1]], dim=-1)
    elif not crosspol:
        keep = torch.tensor([True, False, False, True], device=x.device)
        xn = torch.where(keep, xn, 0.0)
        wn = torch.where(keep, wn, 0.0)
    return _solve_matrix(
        xn.reshape(xn.shape[:4] + (2, 2)),
        wn.reshape(wn.shape[:4] + (2, 2)),
        gain0, niter, tol, phase_only,
    )


def _interval_weights(time, gt_time, gt_interval, dtype):
    """Solution-interval membership ``[nsol, ntime]``, inclusive at both
    ends (an interval's edge time belongs to both neighbours)."""
    t = time[None, :]
    lo = (gt_time - gt_interval / 2)[:, None]
    hi = (gt_time + gt_interval / 2)[:, None]
    return ((t >= lo) & (t <= hi)).to(dtype)


def assemble_normal_equations(xb, wb, ne_idx, nants):
    """Antenna-pair matrices from per-baseline sums ``xb``/``wb``
    ``[nsol, nbl, nchan, npol]``: one gather per array through
    :func:`ne_index_map`. Returns (x, xwt) ``[nsol, nants, nants, nchan,
    npol]``."""
    nsol, _, nchan, npol = xb.shape
    ext = torch.cat([xb.conj(), xb, torch.zeros_like(xb[:, :1])], dim=1)
    x = ext[:, ne_idx].reshape(nsol, nants, nants, nchan, npol)
    extw = torch.cat([wb, wb, torch.zeros_like(wb[:, :1])], dim=1)
    xwt = extw[:, ne_idx].reshape(nsol, nants, nants, nchan, npol)
    return x, xwt


def baseline_sums(point_vis: Visibility, gain_table: GainTable):
    """Per solution interval and baseline, the sums of vis * weight and of
    the weights over its times (and over the channels when the table has
    one channel; per channel for a "B" table): (xb, wb) ``[nsol, nbl,
    nchan_sol, npol]``."""
    w_t = _interval_weights(
        point_vis.time, gain_table.time, gain_table.interval,
        point_vis.weight.dtype,
    )
    fw = point_vis.flagged_weight
    xw = point_vis.vis * fw
    if gain_table.nchan == 1:
        xb = torch.einsum("st,tbfp->sbp", w_t.to(xw.dtype), xw)[:, :, None, :]
        wb = torch.einsum("st,tbfp->sbp", w_t, fw)[:, :, None, :]
    else:
        xb = torch.einsum("st,tbfp->sbfp", w_t.to(xw.dtype), xw)
        wb = torch.einsum("st,tbfp->sbfp", w_t, fw)
    return xb, wb


def build_normal_equations(point_vis: Visibility, gain_table: GainTable):
    """The sums of :func:`baseline_sums` placed in the ``[nants, nants]``
    antenna matrix with the conjugate across the diagonal.

    :return: (x ``[nsol, nants, nants, nchan_sol, npol]``, xwt alike)
    """
    xb, wb = baseline_sums(point_vis, gain_table)
    ne_idx = torch.as_tensor(
        ne_index_map(
            point_vis.antenna1.cpu().numpy(),
            point_vis.antenna2.cpu().numpy(),
            point_vis.nants,
        ),
        device=xb.device,
    ).long()
    return assemble_normal_equations(xb, wb, ne_idx, point_vis.nants)


def finish_solution(gain, gwt, residual, xwt, phase_only, normalise_gains, eye=False):
    """What every solve does after StefCal: intervals with no data keep
    unit gain (every 2x2 entry one, as ``solve_gaintable`` does, or the
    identity with ``eye``, as the fused cycle does) and zero weight and
    residual; amplitude solves are divided by the mean (or median) gain
    amplitude over the whole table, off-diagonal entries included."""
    has_data = torch.sum(xwt.abs(), dim=(1, 2, 3, 4)) > 0.0
    hd = has_data[:, None, None, None, None]
    unit = torch.ones_like(gain)
    if eye:
        unit = torch.eye(gain.shape[-1], dtype=gain.dtype, device=gain.device).expand_as(gain)
    gain = torch.where(hd, gain, unit)
    gwt = torch.where(hd, gwt, torch.zeros_like(gwt))
    residual = torch.where(has_data[:, None, None, None], residual, 0.0)
    if normalise_gains in ("mean", "median") and not phase_only:
        a = gain.abs()
        gabs = a.mean() if normalise_gains == "mean" else _median(a)
        gain = gain / gabs
    return gain, gwt, residual


def _median(x):
    """numpy's median (the mean of the two middle values for an even
    count); torch.median takes the lower one."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def solve_gaintable(
    vis: Visibility,
    modelvis: Visibility | None = None,
    gain_table: GainTable | None = None,
    phase_only: bool = True,
    niter: int = 200,
    tol: float = 1e-6,
    crosspol: bool = False,
    normalise_gains: str | None = "mean",
    jones_type: str = "T",
    timeslice=None,
) -> GainTable:
    """Solve a gaintable that fits ``vis`` to ``modelvis`` (a point source
    at the phase centre when None), warm-started from ``gain_table``'s
    gains when one is given."""
    point_vis = divide_visibility(vis, modelvis) if modelvis is not None else vis
    if gain_table is None:
        gain_table = create_gaintable_from_visibility(
            vis, jones_type=jones_type, timeslice=timeslice
        )
    x, xwt = build_normal_equations(point_vis, gain_table)
    gain, gwt, residual = solve_gains_core(
        x,
        xwt,
        gain_table.gain,
        niter=niter,
        tol=tol,
        phase_only=phase_only,
        crosspol=crosspol,
        npol=vis.npol,
    )
    gain, gwt, residual = finish_solution(
        gain, gwt, residual, xwt, phase_only, normalise_gains
    )
    return gain_table.replace(gain=gain, weight=gwt, residual=residual)
