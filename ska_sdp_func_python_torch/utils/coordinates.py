"""Coordinate support: the helpers ``create_visibility`` and the DFT use.

Counterpart of ``ska_sdp_func_python_tpu/utils/coordinates.py``.

Astrometry contract (kept from the JAX package): sky directions and phase
centres are host numpy float64 and the direction-cosine transforms run in
host f64 whatever the device precision. An absolute direction error of
eps32 (~1e-8 rad) would cost ``2*pi*|uvw|*eps`` of visibility phase, so f32
trigonometry is never used here.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "enu_to_xyz",
    "xyz_to_uvw",
    "hadec_to_azel",
    "radec_to_lmn",
    "lmn_to_radec",
]


def enu_to_xyz(e, n, u, lat):
    """ENU -> celestial XYZ (host f64)."""
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    return -sin_lat * n + cos_lat * u, e, cos_lat * n + sin_lat * u


def xyz_to_uvw(xyz, ha, dec):
    """Earth XYZ -> uvw towards (ha, dec) (host f64)."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    u = x * np.cos(ha) - y * np.sin(ha)
    v0 = x * np.sin(ha) + y * np.cos(ha)
    w = z * np.sin(dec) - v0 * np.cos(dec)
    v = z * np.cos(dec) + v0 * np.sin(dec)
    return np.stack([u, v, w], axis=-1)


def hadec_to_azel(ha, dec, latitude):
    """Hour angle / declination -> azimuth / elevation (host f64)."""
    az = np.arctan2(
        -np.cos(dec) * np.sin(ha),
        np.cos(latitude) * np.sin(dec)
        - np.sin(latitude) * np.cos(dec) * np.cos(ha),
    )
    el = np.arcsin(
        np.sin(latitude) * np.sin(dec)
        + np.cos(latitude) * np.cos(dec) * np.cos(ha)
    )
    return az, el


def radec_to_lmn(ra, dec, ra0, dec0):
    """(ra, dec) -> direction cosines (l, m, n-1) about a phase centre,
    in host f64."""
    ra, dec, ra0, dec0 = (
        np.asarray(x, np.float64) for x in (ra, dec, ra0, dec0)
    )
    dra = ra - ra0
    l = np.cos(dec) * np.sin(dra)
    m = np.sin(dec) * np.cos(dec0) - np.cos(dec) * np.sin(dec0) * np.cos(dra)
    n = np.sin(dec) * np.sin(dec0) + np.cos(dec) * np.cos(dec0) * np.cos(dra)
    return l, m, n - 1.0


def lmn_to_radec(l, m, ra0, dec0):
    """Inverse of :func:`radec_to_lmn`, in host f64."""
    l, m, ra0, dec0 = (np.asarray(x, np.float64) for x in (l, m, ra0, dec0))
    n = np.sqrt(1.0 - l**2 - m**2)
    dec = np.arcsin(m * np.cos(dec0) + n * np.sin(dec0))
    ra = ra0 + np.arctan2(l, n * np.cos(dec0) - m * np.sin(dec0))
    return ra, dec
