"""Visibility geometry: the helpers of ``utils.geometry`` over a
Visibility's times and phase centre.

Counterpart of ``ska_sdp_func_python_tpu/ops/visibility_geometry.py``.
``location`` is (lat, lon, alt) in (rad, rad, m); the results are host
numpy f64 (see ``utils.geometry``).
"""

from __future__ import annotations

from ..models.visibility import Visibility
from ..utils.geometry import (
    calculate_azel,
    calculate_hourangles,
    calculate_parallactic_angles,
    calculate_transit_time,
)

__all__ = [
    "calculate_visibility_hourangles",
    "calculate_visibility_parallactic_angles",
    "calculate_visibility_azel",
    "calculate_visibility_transit_time",
    "get_direction_time_location",
]


def calculate_visibility_hourangles(vis: Visibility, location):
    """Hour angle of the phase centre at each time."""
    return calculate_hourangles(location, vis.time, vis.phasecentre)


def calculate_visibility_parallactic_angles(vis: Visibility, location):
    """Parallactic angle of the phase centre at each time."""
    return calculate_parallactic_angles(location, vis.time, vis.phasecentre)


def calculate_visibility_azel(vis: Visibility, location):
    """(azimuth, elevation) of the phase centre at each time."""
    return calculate_azel(location, vis.time, vis.phasecentre)


def calculate_visibility_transit_time(vis: Visibility, location):
    """UTC seconds of the phase centre's next transit after the first
    time."""
    return calculate_transit_time(location, vis.time[0], vis.phasecentre)


def get_direction_time_location(bvis: Visibility):
    """(location, times, phase centre) of a Visibility; the location is
    its configuration's, None when it carries none (as a Visibility built
    by ``create_visibility`` does not)."""
    location = getattr(getattr(bvis, "configuration", None), "location", None)
    return location, bvis.time, bvis.phasecentre
