"""Coordinate support: array geometry, uvw frames, direction cosines and
point-source phasors.

Counterpart of ``ska_sdp_func_python_tpu/utils/coordinates.py``.

Astrometry contract (kept from the JAX package): sky directions and phase
centres are host numpy float64 and the direction-cosine transforms
(``radec_to_lmn``, ``lmn_to_radec``, ``skycoord_to_lmn``,
``lmn_to_skycoord``) run in host f64 whatever the device precision. An
absolute direction error of eps32 (~1e-8 rad) would cost
``2*pi*|uvw|*eps`` of visibility phase, so f32 trigonometry is never used
there.

The frame rotations take numpy arrays (computed in host f64) or tensors
(computed in the tensor's dtype on its device; numpy and scalar arguments
follow the tensor). The phasors (``simulate_point``,
``simulate_point_antenna``, ``visibility_shift``) return tensors and form
their phases with the split-compensated ``config.frac_dot_turns``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import expi, frac_dot_turns

__all__ = [
    "lla_to_ecef",
    "ecef_to_enu",
    "enu_to_ecef",
    "enu_to_xyz",
    "xyz_at_latitude",
    "xyz_to_uvw",
    "uvw_to_xyz",
    "eci_to_uvw",
    "baselines",
    "xyz_to_baselines",
    "radec_to_lmn",
    "lmn_to_radec",
    "skycoord_to_lmn",
    "simulate_point",
    "visibility_shift",
    "uvw_transform",
    "parallactic_angle",
    "pa_z",
    "hadec_to_azel",
    "azel_to_hadec",
    "ecef_to_lla",
    "enu_to_eci",
    "eci_to_enu",
    "uvw_to_eci",
    "lmn_to_skycoord",
    "simulate_point_antenna",
]

_WGS84_A = 6378137.0
_WGS84_B = 6356752.31424518


def _lib(*xs):
    """(module, converter) of the arguments: torch when any is a tensor
    (the others converted to its floating dtype and device), else numpy
    f64."""
    t = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if t is None:
        return np, lambda x: np.asarray(x, np.float64)
    dtype = t.dtype if t.is_floating_point() else torch.float64
    return torch, lambda x: torch.as_tensor(x, dtype=dtype, device=t.device)


def lla_to_ecef(lat, lon, alt):
    """WGS84 geodetic (lat, lon rad, alt m) -> ECEF cartesian (x, y, z)."""
    xp, a = _lib(lat, lon, alt)
    lat, lon, alt = a(lat), a(lon), a(alt)
    n = _WGS84_A**2 / xp.sqrt(
        _WGS84_A**2 * xp.cos(lat) ** 2 + _WGS84_B**2 * xp.sin(lat) ** 2
    )
    x = (n + alt) * xp.cos(lat) * xp.cos(lon)
    y = (n + alt) * xp.cos(lat) * xp.sin(lon)
    z = ((_WGS84_B**2 / _WGS84_A**2) * n + alt) * xp.sin(lat)
    return x, y, z


def ecef_to_enu(location, xyz):
    """ECEF -> local ENU about ``location = (lat, lon, alt)`` (rad, rad, m)."""
    lat, lon, alt = location
    xp, a = _lib(xyz)
    xyz = a(xyz)
    cx, cy, cz = lla_to_ecef(float(lat), float(lon), float(alt))
    d = xyz - a(np.stack([cx, cy, cz])).reshape(1, 3)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    e = -sin_lon * d[..., 0] + cos_lon * d[..., 1]
    n = (
        -sin_lat * cos_lon * d[..., 0]
        - sin_lat * sin_lon * d[..., 1]
        + cos_lat * d[..., 2]
    )
    u = (
        cos_lat * cos_lon * d[..., 0]
        + cos_lat * sin_lon * d[..., 1]
        + sin_lat * d[..., 2]
    )
    return xp.stack([e, n, u], axis=-1)


def enu_to_ecef(location, enu):
    """Local ENU -> ECEF about ``location = (lat, lon, alt)``."""
    lat, lon, alt = location
    xp, a = _lib(enu)
    enu = a(enu)
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    x0, y0, z0 = lla_to_ecef(float(lat), float(lon), float(alt))
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    x = x0 - sin_lon * e - sin_lat * cos_lon * n + cos_lat * cos_lon * u
    y = y0 + cos_lon * e - sin_lat * sin_lon * n + cos_lat * sin_lon * u
    z = z0 + cos_lat * n + sin_lat * u
    return xp.stack([x, y, z], axis=-1)


def enu_to_xyz(e, n, u, lat):
    """ENU -> celestial XYZ (TMS pp. 86-89)."""
    xp, a = _lib(e, n, u, lat)
    e, n, u, lat = a(e), a(n), a(u), a(lat)
    sin_lat, cos_lat = xp.sin(lat), xp.cos(lat)
    return -sin_lat * n + cos_lat * u, e, cos_lat * n + sin_lat * u


def xyz_at_latitude(local_xyz, lat):
    """Rotate local XYZ into celestial XYZ at latitude ``lat``."""
    xp, a = _lib(local_xyz, lat)
    local_xyz, lat = a(local_xyz), a(lat)
    x, y, z = local_xyz[..., 0], local_xyz[..., 1], local_xyz[..., 2]
    lat2 = np.pi / 2 - lat
    y2 = -z * xp.sin(lat2) + y * xp.cos(lat2)
    z2 = z * xp.cos(lat2) + y * xp.sin(lat2)
    return xp.stack([x, y2, z2], axis=-1)


def xyz_to_uvw(xyz, ha, dec):
    """Earth XYZ -> uvw towards (ha, dec)."""
    xp, a = _lib(xyz, ha, dec)
    xyz, ha, dec = a(xyz), a(ha), a(dec)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    u = x * xp.cos(ha) - y * xp.sin(ha)
    v0 = x * xp.sin(ha) + y * xp.cos(ha)
    w = z * xp.sin(dec) - v0 * xp.cos(dec)
    v = z * xp.cos(dec) + v0 * xp.sin(dec)
    return xp.stack([u, v, w], axis=-1)


def uvw_to_xyz(uvw, ha, dec):
    """Inverse of :func:`xyz_to_uvw`."""
    xp, a = _lib(uvw, ha, dec)
    uvw, ha, dec = a(uvw), a(ha), a(dec)
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    v0 = v * xp.sin(dec) - w * xp.cos(dec)
    z = v * xp.cos(dec) + w * xp.sin(dec)
    x = u * xp.cos(ha) + v0 * xp.sin(ha)
    y = -u * xp.sin(ha) + v0 * xp.cos(ha)
    return xp.stack([x, y, z], axis=-1)


def eci_to_uvw(xyz, ha, dec):
    """Earth-centred-inertial XYZ -> uvw towards (ha, dec)."""
    xp, a = _lib(xyz, ha, dec)
    xyz, ha, dec = a(xyz), a(ha), a(dec)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    u = xp.sin(ha) * x + xp.cos(ha) * y
    v = (
        -xp.sin(dec) * xp.cos(ha) * x
        + xp.sin(dec) * xp.sin(ha) * y
        + xp.cos(dec) * z
    )
    w = (
        xp.cos(dec) * xp.cos(ha) * x
        - xp.cos(dec) * xp.sin(ha) * y
        + xp.sin(dec) * z
    )
    return xp.stack([u, v, w], axis=-1)


def baselines(ants_uvw):
    """All upper-triangle baselines ant2 - ant1 of ``[nants, 3]``
    positions (a tensor stays on its device)."""
    nants = ants_uvw.shape[0]
    a1, a2 = np.triu_indices(nants, 1)
    if isinstance(ants_uvw, torch.Tensor):
        return ants_uvw[a2] - ants_uvw[a1]
    ants_uvw = np.asarray(ants_uvw)
    return ants_uvw[a2] - ants_uvw[a1]


def xyz_to_baselines(ants_xyz, ha_range, dec):
    """Baselines of ``ants_xyz`` at each hour angle of ``ha_range``,
    concatenated (host f64)."""
    return np.concatenate(
        [
            baselines(xyz_to_uvw(np.asarray(ants_xyz, np.float64), hax, dec))
            for hax in np.asarray(ha_range)
        ]
    )


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


def skycoord_to_lmn(pos, phasecentre):
    """(ra, dec) pairs ``[..., 2]`` (or a 2-tuple) -> (l, m, n-1), in host
    f64."""
    pos = np.asarray(pos, np.float64)
    pc = np.asarray(phasecentre, np.float64)
    return radec_to_lmn(pos[..., 0], pos[..., 1], pc[..., 0], pc[..., 1])


def lmn_to_skycoord(lmn, phasecentre):
    """Direction cosines (l, m, ...) -> (ra, dec) about a phase centre, in
    host f64."""
    return lmn_to_radec(lmn[0], lmn[1], phasecentre[0], phasecentre[1])


def _direction(l, m, like: torch.Tensor) -> torch.Tensor:
    """(l, m, n - 1) of a direction, formed in host f64, as a tensor like
    ``like``."""
    l, m = np.asarray(l, np.float64), np.asarray(m, np.float64)
    s = np.stack([l, m, np.sqrt(1.0 - l**2 - m**2) - 1.0])
    return torch.as_tensor(s, device=like.device).to(like.dtype)


def _as_real_tensor(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float64)


def simulate_point(dist_uvw, l, m) -> torch.Tensor:
    """Unit point-source phasor exp(-2 pi i (u l + v m + w (n - 1))) of
    ``[..., 3]`` uvw (in wavelengths) towards (l, m)."""
    dist_uvw = _as_real_tensor(dist_uvw)
    phase = -2.0 * np.pi * frac_dot_turns(dist_uvw, _direction(l, m, dist_uvw))
    return expi(phase)


def simulate_point_antenna(dist_uvw, l, m) -> torch.Tensor:
    """Per-antenna phasor of a unit point source at (l, m): the one-sided
    factor of :func:`simulate_point` (the same phase of one antenna's
    uvw)."""
    return simulate_point(dist_uvw, l, m)


def visibility_shift(uvw, vis, dl, dm) -> torch.Tensor:
    """``vis`` times exp(-2 pi i (u dl + v dm)): a shift by (dl, dm)."""
    uvw = _as_real_tensor(uvw)
    s = torch.as_tensor(
        np.stack([np.asarray(dl, np.float64), np.asarray(dm, np.float64)]),
        device=uvw.device,
    ).to(uvw.dtype)
    phase = -2.0 * np.pi * frac_dot_turns(uvw[..., 0:2], s)
    return torch.as_tensor(vis) * expi(phase)


def uvw_transform(uvw, transform_matrix):
    """uv times a 2x2 image-plane transform; w unchanged."""
    xp, a = _lib(uvw, transform_matrix)
    uvw = a(uvw)
    uv1 = uvw[..., 0:2] @ a(transform_matrix)
    return xp.concatenate([uv1, uvw[..., 2:3]], axis=-1)


def parallactic_angle(ha, dec, lat):
    """Parallactic angle of (ha, dec) seen from latitude ``lat``."""
    xp, a = _lib(ha, dec, lat)
    ha, dec, lat = a(ha), a(dec), a(lat)
    return xp.arctan2(
        xp.cos(lat) * xp.sin(ha),
        xp.sin(lat) * xp.cos(dec) - xp.cos(lat) * xp.sin(dec) * xp.cos(ha),
    )


def pa_z(ha, dec, lat):
    """(parallactic angle, zenith angle) of (ha, dec) from latitude
    ``lat``."""
    xp, a = _lib(ha, dec, lat)
    ha, dec, lat = a(ha), a(dec), a(lat)
    sinz = xp.sin(dec) * xp.sin(lat) + xp.cos(dec) * xp.cos(lat) * xp.cos(ha)
    return parallactic_angle(ha, dec, lat), xp.arcsin(sinz)


def hadec_to_azel(ha, dec, latitude):
    """Hour angle / declination -> azimuth / elevation."""
    xp, a = _lib(ha, dec, latitude)
    ha, dec, latitude = a(ha), a(dec), a(latitude)
    az = xp.arctan2(
        -xp.cos(dec) * xp.sin(ha),
        xp.cos(latitude) * xp.sin(dec)
        - xp.sin(latitude) * xp.cos(dec) * xp.cos(ha),
    )
    el = xp.arcsin(
        xp.sin(latitude) * xp.sin(dec)
        + xp.cos(latitude) * xp.cos(dec) * xp.cos(ha)
    )
    return az, el


def azel_to_hadec(az, el, latitude):
    """Azimuth / elevation -> hour angle / declination."""
    xp, a = _lib(az, el, latitude)
    az, el, latitude = a(az), a(el), a(latitude)
    ha = xp.arctan2(
        -xp.cos(el) * xp.sin(az),
        xp.cos(latitude) * xp.sin(el)
        - xp.sin(latitude) * xp.cos(el) * xp.cos(az),
    )
    dec = xp.arcsin(
        xp.sin(latitude) * xp.sin(el)
        + xp.cos(latitude) * xp.cos(el) * xp.cos(az)
    )
    return ha, dec


def ecef_to_lla(x, y, z):
    """ECEF -> (lat rad, lon rad, alt m), Bowring's method."""
    xp, a = _lib(x, y, z)
    x, y, z = a(x), a(y), a(z)
    e2 = (_WGS84_A**2 - _WGS84_B**2) / _WGS84_A**2
    ep2 = (_WGS84_A**2 - _WGS84_B**2) / _WGS84_B**2
    p = xp.sqrt(x**2 + y**2)
    lon = xp.arctan2(y, x)
    theta = xp.arctan2(z * _WGS84_A, p * _WGS84_B)
    lat = xp.arctan2(
        z + ep2 * _WGS84_B * xp.sin(theta) ** 3,
        p - e2 * _WGS84_A * xp.cos(theta) ** 3,
    )
    n = _WGS84_A / xp.sqrt(1.0 - e2 * xp.sin(lat) ** 2)
    alt = p / xp.cos(lat) - n
    return lat, lon, alt


def enu_to_eci(enu, lat):
    """[east, north, up] -> earth-centred-inertial [x, y, z]."""
    xp, a = _lib(enu, lat)
    enu, lat = a(enu), a(lat)
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    x = -xp.sin(lat) * n + u * xp.cos(lat)
    z = n * xp.cos(lat) + u * xp.sin(lat)
    return xp.stack([x, e, z], axis=-1)


def eci_to_enu(eci, lat):
    """Inverse of :func:`enu_to_eci`."""
    xp, a = _lib(eci, lat)
    eci, lat = a(eci), a(lat)
    x, y, z = eci[..., 0], eci[..., 1], eci[..., 2]
    n = -xp.sin(lat) * x + z * xp.cos(lat)
    u = xp.cos(lat) * x + z * xp.sin(lat)
    return xp.stack([y, n, u], axis=-1)


def uvw_to_eci(uvw, ha, dec):
    """uvw -> ECI: the identity, as in the reference (its rotation is not
    applied there either)."""
    return uvw
