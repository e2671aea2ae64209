"""Chain calibration: Jones terms solved and applied in the order of a
context string ("T", "G", "B"), each gated on the self-cal iteration.

Counterpart of ``ska_sdp_func_python_tpu/ops/calibration_chain.py``.
"""

from __future__ import annotations

import logging

from ..models.gaintable import GainTable, create_gaintable_from_visibility
from .gain_ops import apply_gaintable
from .solvers import solve_gaintable

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = [
    "create_calibration_controls",
    "apply_calibration_chain",
    "calibrate_chain",
    "solve_calibrate_chain",
]


def create_calibration_controls() -> dict:
    """Default controls: T = atmospheric phase, G = electronic gain,
    B = bandpass."""
    return {
        "T": {
            "shape": "scalar",
            "timeslice": "auto",
            "phase_only": True,
            "first_selfcal": 0,
        },
        "G": {
            "shape": "vector",
            "timeslice": 60.0,
            "phase_only": False,
            "first_selfcal": 0,
        },
        "B": {
            "shape": "vector",
            "timeslice": 1e5,
            "phase_only": False,
            "first_selfcal": 0,
        },
    }


def _as_dict(gaintables, calibration_context) -> dict:
    """Gaintables as a dict by Jones type: a dict is copied, a GainTable
    or a list keeps the tables whose type is in the context."""
    if gaintables is None:
        return {}
    if isinstance(gaintables, GainTable):
        gaintables = [gaintables]
    if isinstance(gaintables, dict):
        return dict(gaintables)
    return {
        gt.jones_type: gt
        for gt in gaintables
        if gt.jones_type in calibration_context
    }


def _solve_term(vis, model_vis, gaintable, control, tol):
    return solve_gaintable(
        vis,
        model_vis,
        gain_table=gaintable,
        phase_only=control["phase_only"],
        crosspol=control["shape"] == "matrix",
        timeslice=control["timeslice"],
        tol=tol,
    )


def apply_calibration_chain(
    vis,
    gaintables,
    calibration_context: str = "T",
    controls: dict | None = None,
    iteration: int = 0,
):
    """Apply each gaintable whose term is active at ``iteration``, in the
    order of the tables."""
    if controls is None:
        controls = create_calibration_controls()
    gt = _as_dict(gaintables, calibration_context)
    for c in gt:
        if iteration >= controls[c]["first_selfcal"]:
            vis = apply_gaintable(vis, gt[c])
    return vis


def calibrate_chain(
    vis,
    model_vis,
    gaintables=None,
    calibration_context: str = "T",
    controls: dict | None = None,
    iteration: int = 0,
    tol: float = 1e-6,
):
    """Solve each active term in context order on the visibilities the
    terms before it corrected, warm-started from ``gaintables``, and
    inverse-apply it before the next term. Returns (corrected vis, dict
    of GainTables)."""
    if controls is None:
        controls = create_calibration_controls()
    avis = vis
    gt = _as_dict(gaintables, calibration_context)
    for c in calibration_context:
        if iteration >= controls[c]["first_selfcal"]:
            if c not in gt:
                gt[c] = create_gaintable_from_visibility(
                    avis, timeslice=controls[c]["timeslice"], jones_type=c
                )
            gt[c] = _solve_term(avis, model_vis, gt[c], controls[c], tol)
            avis = apply_gaintable(avis, gt[c], inverse=True)
    return avis, gt


def solve_calibrate_chain(
    vis,
    model_vis,
    gaintables=None,
    calibration_context: str = "T",
    controls: dict | None = None,
    iteration: int = 0,
    tol: float = 1e-6,
):
    """Solve, without applying, each active term on ``vis``; a term is
    left as it is when there is no weight or no model data. Returns a
    dict of GainTables."""
    if controls is None:
        controls = create_calibration_controls()
    gt = _as_dict(gaintables, calibration_context)
    for c in calibration_context:
        if c not in gt:
            gt[c] = create_gaintable_from_visibility(
                vis, timeslice=controls[c]["timeslice"], jones_type=c
            )
        if iteration >= controls[c]["first_selfcal"]:
            has_weight = float(vis.flagged_weight.abs().max()) > 0.0
            has_model = model_vis is None or float(model_vis.vis.abs().max()) > 0.0
            if has_weight and has_model:
                gt[c] = _solve_term(vis, model_vis, gt[c], controls[c], tol)
            else:
                log.info("No model data: cannot solve for Jones matrix %s", c)
    return gt
