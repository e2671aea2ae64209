"""Parset-driven gain calibration.

Counterpart of ``ska_sdp_func_python_tpu/ops/gaincal_engine.py``: the
reference hands the T/G/B calibration controls to DP3's ``gaincal`` step
as parsets; here the same parsets drive the port's own solver
(``solvers.solve_gaintable``) and ``apply_gaintable``, one Jones term
after another, with no external process.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.visibility import Visibility
from .calibration_chain import create_calibration_controls
from .gain_ops import apply_gaintable
from .solvers import solve_gaintable

__all__ = ["Parset", "create_parset_from_context", "gaincal", "dp3_gaincal"]


@dataclasses.dataclass
class Parset:
    """Ordered key/value pairs of one calibration step."""

    entries: dict = dataclasses.field(default_factory=dict)

    def add(self, key: str, value: str):
        self.entries[key] = value

    def get(self, key: str, default=None):
        return self.entries.get(key, default)


def create_parset_from_context(
    vis: Visibility,
    calibration_context: str,
    global_solution: bool = True,
    solutions_filename: str = "gaincal.h5",
    skymodel_filename: str = "skymodel.db",
) -> list:
    """One parset per Jones term of ``calibration_context``, from the
    calibration controls: solution interval in integrations, channels
    per solution (0: all), the DP3 caltype of the term's shape and phase
    mode, and the term's name."""
    parsets = []
    controls = create_calibration_controls()
    for c in list(calibration_context):
        parset = Parset()
        parset.add("gaincal.parmdb", solutions_filename)
        parset.add("gaincal.sourcedb", skymodel_filename)
        timeslice = controls[c]["timeslice"]
        if timeslice == "auto" or timeslice is None:
            parset.add("gaincal.solint", "1")
        else:
            dt = float(vis.integration_time[0])
            parset.add("gaincal.solint", str(int(np.round(timeslice / dt))))
        parset.add("gaincal.nchan", "0" if global_solution else "1")
        parset.add("gaincal.applysolution", "true")
        shape = controls[c]["shape"]
        if controls[c]["phase_only"]:
            caltype = {"scalar": "scalarphase", "vector": "diagonalphase",
                       "matrix": "fulljones"}[shape]
        else:
            caltype = {"scalar": "scalar", "vector": "diagonal", "matrix": "fulljones"}[shape]
        parset.add("gaincal.caltype", caltype)
        parset.add("gaincal.jones", c)
        parsets.append(parset)
    return parsets


def gaincal(
    vis: Visibility,
    modelvis: Visibility | None,
    calibration_context: str = "T",
    global_solution: bool = True,
    niter: int = 50,
    tol: float = 1e-6,
) -> Visibility:
    """Solve each parset's Jones term against ``modelvis`` (None: a unit
    point source at the phase centre) and apply its inverse, in turn.
    Returns the calibrated visibilities."""
    parsets = create_parset_from_context(vis, calibration_context, global_solution)
    controls = create_calibration_controls()
    out = vis
    for parset in parsets:
        c = parset.get("gaincal.jones")
        caltype = parset.get("gaincal.caltype")
        jones_type = c if c in ("T", "G", "B") else "T"
        if parset.get("gaincal.nchan") == "1":
            jones_type = "B"
        gt = solve_gaintable(
            out,
            modelvis,
            phase_only=caltype in ("scalarphase", "diagonalphase"),
            crosspol=caltype == "fulljones",
            niter=niter,
            tol=tol,
            jones_type=jones_type,
            timeslice=controls[c]["timeslice"],
        )
        if parset.get("gaincal.applysolution") == "true":
            out = apply_gaintable(out, gt, inverse=True)
    return out


def dp3_gaincal(
    vis,
    calibration_context,
    global_solution=True,
    skymodel_filename=None,
    solutions_filename=None,
    modelvis=None,
    **kwargs,
):
    """The reference's DP3 entry, served by :func:`gaincal`; the DP3 sky
    model file becomes an explicit ``modelvis`` (None: a unit point
    source, DP3's default test model)."""
    return gaincal(
        vis, modelvis, calibration_context=calibration_context,
        global_solution=global_solution, **kwargs,
    )
