"""Gain application for scalar (stokesI) gains.

Counterpart of ``ska_sdp_func_python_tpu/ops/gain_ops.py``; the 2x2 Jones
paths raise.
"""

from __future__ import annotations

import torch

from ..config import not_ported
from ..models.gaintable import GainTable
from ..models.visibility import Visibility

__all__ = ["apply_gaintable"]


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
    """V' = g_i V conj(g_j) for scalar gains (or its inverse)."""
    if vis.npol != 1:
        raise not_ported("Jones gain application (npol > 1)", "S7x")
    row_idx, has_row = _gain_row_of_time(vis.time, gt.time, gt.interval)
    gain_t = gt.gain[row_idx]  # [ntime, nants, nchan_gt, 1, 1]
    if gt.nchan == 1 and vis.nchan > 1:
        gain_t = gain_t.expand(-1, -1, vis.nchan, -1, -1)
    a1, a2 = vis.antenna1.long(), vis.antenna2.long()
    lg1 = gain_t[:, a1][..., 0, 0]
    lg2 = gain_t[:, a2][..., 0, 0]
    original = vis.flagged_vis if use_flags else vis.vis
    weight = vis.flagged_weight if use_flags else vis.weight
    if inverse:
        ok1, ok2 = lg1.abs() > 0.0, lg2.abs() > 0.0
        one = torch.ones_like(lg1)
        lg1 = torch.where(ok1, 1.0 / torch.where(ok1, lg1, one), 0.0)
        lg2 = torch.where(ok2, 1.0 / torch.where(ok2, lg2, one), 0.0)
    smueller = lg1 * lg2.conj()  # [ntime, nbl, nchan]
    okm = (smueller.abs() > 0.0)[..., None]
    applied = torch.where(okm, original * smueller[..., None], 0.0)
    new_wt = torch.where(okm, weight, 0.0)
    keep = has_row[:, None, None, None]
    return vis.replace(
        vis=torch.where(keep, applied.to(vis.vis.dtype), vis.vis),
        weight=torch.where(keep, new_wt, vis.weight),
    )
