"""Array configuration model and observation simulation.

Counterpart of ``ska_sdp_func_python_tpu/models/configuration.py``: the same
synthetic SKA-LOW-like log-spiral layout (no data files), computed on the
host in f64, and ``create_visibility`` that simulates an empty observation
on a chosen device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import not_ported
from .visibility import Visibility, create_visibility_from_arrays

__all__ = ["Configuration", "create_named_configuration", "create_visibility"]


@dataclasses.dataclass
class Configuration:
    """Antenna array: celestial XYZ positions [nants, 3] (metres), names,
    diameters and site location (lat rad, lon rad, alt m)."""

    name: str
    xyz: np.ndarray
    names: list
    diameter: np.ndarray
    location: tuple

    @property
    def nants(self) -> int:
        return self.xyz.shape[0]


_LOW_LOCATION = (np.deg2rad(-26.824722), np.deg2rad(116.764444), 300.0)


def _log_spiral_layout(nants, rmax, rmin=35.0, arms=3, seed=1):
    """Multi-arm log-spiral + dense core, SKA-LOW-flavoured (the same
    draws as the JAX package's layout for the same seed)."""
    rng = np.random.default_rng(seed)
    ncore = nants // 2
    narm = nants - ncore
    r_core = rmin * np.sqrt(rng.uniform(0, 1, ncore))
    th_core = rng.uniform(0, 2 * np.pi, ncore)
    pts = [np.stack([r_core * np.cos(th_core), r_core * np.sin(th_core)], -1)]
    per_arm = narm // arms
    rem = narm - per_arm * arms
    for arm in range(arms):
        n = per_arm + (1 if arm < rem else 0)
        t = np.linspace(0.05, 1.0, n)
        r = rmin + (rmax - rmin) * t**1.5
        th = 2 * np.pi * arm / arms + 3.0 * t + rng.normal(0, 0.05, n)
        pts.append(np.stack([r * np.cos(th), r * np.sin(th)], -1))
    return np.concatenate(pts)[:nants]


def create_named_configuration(
    name: str = "LOW", rmax: float | None = None
) -> Configuration:
    """Synthetic "LOW" configuration (512 stations of 38 m); ``rmax``
    keeps the stations within that radius."""
    from ..utils.coordinates import enu_to_xyz

    if not name.startswith("LOW"):
        raise not_ported(f"configuration {name!r}", "S11")
    nants, diam, location, default_r = 512, 38.0, _LOW_LOCATION, 40000.0
    enu2d = _log_spiral_layout(nants, default_r)
    if rmax is not None:
        enu2d = enu2d[np.hypot(enu2d[:, 0], enu2d[:, 1]) <= rmax]
    x, y, z = enu_to_xyz(
        enu2d[:, 0], enu2d[:, 1], np.zeros(enu2d.shape[0]), location[0]
    )
    xyz = np.stack([x, y, z], -1)
    n = xyz.shape[0]
    return Configuration(
        name=name,
        xyz=xyz,
        names=[f"{name}_{i:03d}" for i in range(n)],
        diameter=np.full(n, diam),
        location=location,
    )


def create_visibility(
    config: Configuration,
    times,
    frequency,
    channel_bandwidth=None,
    phasecentre=(0.0, np.deg2rad(-35.0)),
    polarisation_frame: str = "stokesI",
    weight: float = 1.0,
    elevation_limit=None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Visibility:
    """Simulate an empty observation at hour angles ``times`` (rad): uvw
    computed on the host in f64, then moved to ``device``.
    ``elevation_limit`` (rad) drops integrations below it."""
    from ..utils.coordinates import hadec_to_azel, xyz_to_uvw

    times = np.atleast_1d(np.asarray(times, dtype=float))
    frequency = np.atleast_1d(np.asarray(frequency, dtype=float))
    dec = float(phasecentre[1])
    if elevation_limit is not None:
        _, el = hadec_to_azel(times, dec, config.location[0])
        times = times[el >= elevation_limit]
    a1, a2 = np.triu_indices(config.nants, 1)
    uvw = np.stack(
        [xyz_to_uvw(config.xyz[a2] - config.xyz[a1], ha, dec) for ha in times]
    )
    vis = create_visibility_from_arrays(
        uvw=uvw,
        time=times * 86164.1 / (2 * np.pi),
        frequency=frequency,
        antenna1=a1,
        antenna2=a2,
        phasecentre=np.asarray(
            [float(phasecentre[0]), float(phasecentre[1])], np.float64
        ),
        polarisation_frame=polarisation_frame,
        channel_bandwidth=channel_bandwidth,
        nants=config.nants,
        dtype=dtype,
        device=device,
    )
    if weight != 1.0:
        vis = vis.replace(weight=vis.weight * weight)
    return vis
