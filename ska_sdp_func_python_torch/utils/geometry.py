"""Observation geometry: sidereal time, hour angles, parallactic angles,
az/el and transit times.

Counterpart of ``ska_sdp_func_python_tpu/utils/geometry.py``, computed as
the JAX package computes it (the IAU 1982 GMST polynomial, no astropy), in
host numpy f64: times are absolute epochs (UTC seconds since the MJD
epoch, ~5e9 s) whose sub-second part f32 cannot hold. Tensor times are
read to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .coordinates import hadec_to_azel, parallactic_angle

__all__ = [
    "greenwich_mean_sidereal_time",
    "calculate_hourangles",
    "calculate_parallactic_angles",
    "calculate_azel",
    "calculate_transit_time",
    "utc_to_ms_epoch",
]

_SECONDS_PER_DAY = 86400.0
_MJD_J2000 = 51544.5  # MJD of the J2000.0 epoch


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def greenwich_mean_sidereal_time(ms_epoch_seconds):
    """GMST in radians from UTC seconds since the MJD epoch."""
    d = _host64(ms_epoch_seconds) / _SECONDS_PER_DAY - _MJD_J2000
    gmst_deg = 280.46061837 + 360.98564736629 * d
    return np.deg2rad(np.mod(gmst_deg, 360.0))


def calculate_hourangles(location, ms_epoch_seconds, direction):
    """Hour angle, wrapped to [-pi, pi], of ``direction`` = (ra, dec) rad
    seen from ``location`` = (lat, lon, alt) at UTC seconds."""
    _, lon, _ = location
    ra = _host64(direction)[..., 0]
    ha = greenwich_mean_sidereal_time(ms_epoch_seconds) + lon - ra
    return np.arctan2(np.sin(ha), np.cos(ha))


def calculate_parallactic_angles(location, ms_epoch_seconds, direction):
    """Parallactic angles of ``direction`` at the given times."""
    dec = _host64(direction)[..., 1]
    ha = calculate_hourangles(location, ms_epoch_seconds, direction)
    return parallactic_angle(ha, dec, float(location[0]))


def calculate_azel(location, ms_epoch_seconds, direction):
    """(azimuth, elevation) of ``direction`` at the given times."""
    dec = _host64(direction)[..., 1]
    ha = calculate_hourangles(location, ms_epoch_seconds, direction)
    return hadec_to_azel(ha, dec, float(location[0]))


def calculate_transit_time(location, ms_epoch_seconds, direction):
    """UTC seconds of the next transit (ha == 0) after
    ``ms_epoch_seconds``."""
    ha = calculate_hourangles(location, ms_epoch_seconds, direction)
    sidereal_rate = 2.0 * np.pi / (_SECONDS_PER_DAY * 360.98564736629 / 360.0)
    dt = np.mod(-ha, 2.0 * np.pi) / sidereal_rate
    return _host64(ms_epoch_seconds) + dt


def utc_to_ms_epoch(mjd):
    """MJD (days) -> Measurement-Set epoch seconds."""
    return _host64(mjd) * _SECONDS_PER_DAY
