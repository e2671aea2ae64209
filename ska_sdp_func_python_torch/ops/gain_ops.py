"""Gain application and gaintable algebra: scalar gains (stokesI) and
2x2 Jones matrices (npol 2 and 4).

Counterpart of ``ska_sdp_func_python_tpu/ops/gain_ops.py``. A gaintable
has one solution channel ("T", "G"), which serves every visibility
channel, or one per visibility channel ("B"). 2x2 inverses are closed
form with a determinant guard, and the products are broadcast
elementwise sums, not batched matrix products.
"""

from __future__ import annotations

import torch

from ..models.gaintable import GainTable
from ..models.visibility import Visibility

__all__ = [
    "apply_gaintable",
    "apply_jones",
    "multiply_gaintables",
    "concatenate_gaintables",
]


def _inv2x2(m, min_det: float = 0.0):
    """Closed-form inverse of every 2x2 matrix of ``m`` ``[..., 2, 2]``.
    Returns (inverse, invertible mask ``|det| > min_det``); a singular
    matrix's inverse is zero."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    ok = det.abs() > min_det
    safe = torch.where(ok, det, torch.ones_like(det))
    inv = torch.stack(
        [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
    ) / safe[..., None, None]
    return torch.where(ok[..., None, None], inv, 0.0), ok


def _congruence(g1, v22, g2):
    """g1 @ v22 @ g2^H for 2x2 matrices ``[..., 2, 2]``, as broadcast sums
    over the inner indices."""
    a = (g1[..., :, :, None] * v22[..., None, :, :]).sum(dim=-2)  # g1 v
    return (a[..., :, None, :] * g2.conj()[..., None, :, :]).sum(dim=-1)


def _gain_row_of_time(vis_time, gt_time, gt_interval):
    """Map each vis time to its gaintable row: |t - t_row| < interval/2.
    Returns (row_idx [ntime], has_row [ntime])."""
    d = (vis_time[None, :] - gt_time[:, None]).abs()
    member = d < (gt_interval[:, None] / 2.0)
    has_row = member.any(dim=0)
    # first member row (argmax over a bool tensor is not first-index
    # stable on every backend, so take it from the integer form)
    row_idx = member.to(torch.int8).argmax(dim=0)
    return row_idx, has_row


def apply_gaintable(
    vis: Visibility,
    gt: GainTable,
    inverse: bool = False,
    use_flags: bool = False,
) -> Visibility:
    """Apply (or with ``inverse`` undo) a gaintable: V' = g_i V g_j^H.
    npol 1: the scalar product; npol 2: the diagonal of G1 diag(V) G2^H;
    npol 4: the 2x2 congruence. Under ``inverse`` singular gains zero
    the visibilities and weights they touch."""
    row_idx, has_row = _gain_row_of_time(vis.time, gt.time, gt.interval)
    gain_t = gt.gain[row_idx]  # [ntime, nants, nchan_gt, nrec, nrec]
    if gt.nchan == 1 and vis.nchan > 1:
        gain_t = gain_t.expand(-1, -1, vis.nchan, -1, -1)
    a1, a2 = vis.antenna1.long(), vis.antenna2.long()
    g1 = gain_t[:, a1]  # [ntime, nbl, nchan, nrec, nrec]
    g2 = gain_t[:, a2]
    original = vis.flagged_vis if use_flags else vis.vis
    weight = vis.flagged_weight if use_flags else vis.weight
    if vis.npol == 1:
        lg1, lg2 = g1[..., 0, 0], g2[..., 0, 0]
        if inverse:
            ok1, ok2 = lg1.abs() > 0.0, lg2.abs() > 0.0
            one = torch.ones_like(lg1)
            lg1 = torch.where(ok1, 1.0 / torch.where(ok1, lg1, one), 0.0)
            lg2 = torch.where(ok2, 1.0 / torch.where(ok2, lg2, one), 0.0)
        smueller = lg1 * lg2.conj()  # [ntime, nbl, nchan]
        okm = (smueller.abs() > 0.0)[..., None]
        applied = torch.where(okm, original * smueller[..., None], 0.0)
    elif vis.npol in (2, 4):
        if inverse:
            g1, ok1 = _inv2x2(g1)
            g2, ok2 = _inv2x2(g2)
            okm = (ok1 & ok2)[..., None]
        else:
            okm = torch.ones(
                original.shape[:-1] + (1,), dtype=torch.bool, device=vis.device
            )
        if vis.npol == 2:
            # sum_q G1[p, q] V[q] conj(G2[p, q])
            applied = (g1 * original[..., None, :] * g2.conj()).sum(dim=-1)
        else:
            v22 = original.reshape(original.shape[:-1] + (2, 2))
            applied = _congruence(g1, v22, g2).reshape(original.shape)
        applied = torch.where(okm, applied, 0.0)
    else:
        raise ValueError(f"Unsupported npol {vis.npol}")
    new_wt = torch.where(okm, weight, 0.0)
    keep = has_row[:, None, None, None]
    return vis.replace(
        vis=torch.where(keep, applied.to(vis.vis.dtype), vis.vis),
        weight=torch.where(keep, new_wt, vis.weight),
    )


def apply_jones(ej, cfs, inverse: bool = False, min_det: float = 1e-6):
    """ej @ cfs @ ej^H for 2x2 matrices batched over leading axes, or with
    ``inverse`` ej^-1 @ cfs @ ej^-H where |det ej| > ``min_det`` (cfs
    unchanged elsewhere)."""
    if inverse:
        inv, ok = _inv2x2(ej, min_det=min_det)
        return torch.where(ok[..., None, None], _congruence(inv, cfs, inv), cfs)
    return _congruence(ej, cfs, ej)


def multiply_gaintables(
    gt: GainTable, dgt: GainTable, time_tolerance: float = 1e-3
) -> GainTable:
    """gt * dgt: scalar gains elementwise; 2x2 gains as gt^T dgt (the JAX
    package's ``...ik,...ij->...kj``); weights elementwise."""
    if gt.nrec == dgt.nrec == 2:
        gain = (gt.gain[..., :, :, None] * dgt.gain[..., :, None, :]).sum(dim=-3)
    elif gt.nrec == dgt.nrec == 1:
        gain = gt.gain * dgt.gain
    else:
        raise ValueError("Gain tables have different structures")
    return gt.replace(gain=gain, weight=gt.weight * dgt.weight)


def concatenate_gaintables(gt_list) -> GainTable:
    """Concatenate gaintables along time."""
    if not gt_list:
        raise ValueError("GainTable list is empty")

    def cat(name):
        return torch.cat([getattr(g, name) for g in gt_list], dim=0)

    return gt_list[0].replace(
        **{k: cat(k) for k in ("gain", "weight", "residual", "time", "interval")}
    )
