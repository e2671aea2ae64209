"""Array configuration model and observation simulation.

Counterpart of ``ska_sdp_func_python_tpu/models/configuration.py``: the same
synthetic log-spiral layouts (no data files) of "LOW" (512 stations of 38
m) and "MID" (197 dishes of 15 m), computed on the host in f64, and
``create_visibility`` that simulates an empty observation on a chosen
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from .visibility import Visibility, create_visibility_from_arrays

__all__ = [
    "Configuration",
    "create_named_configuration",
    "create_visibility",
    "random_array_xyz",
]


def random_array_xyz(nants: int, rmax: float = 1000.0, seed: int = 42) -> np.ndarray:
    """A pseudo-random 2-D array of ``nants`` stations within ``rmax``
    metres, rotated to celestial XYZ at a LOW-like latitude ([nants, 3],
    f64): the layout of the JAX package's test observations
    (``tests/simul.py``), the same numbers for the same seed."""
    rng = np.random.default_rng(seed)
    r = rmax * np.sqrt(rng.uniform(0.1, 1.0, nants))
    th = rng.uniform(0, 2 * np.pi, nants)
    e, n = r * np.cos(th), r * np.sin(th)
    u = np.zeros(nants)
    lat = np.deg2rad(-26.82)
    x = -np.sin(lat) * n + np.cos(lat) * u
    y = e
    z = np.cos(lat) * n + np.sin(lat) * u
    return np.stack([x, y, z], axis=-1)


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
_MID_LOCATION = (np.deg2rad(-30.712925), np.deg2rad(21.443803), 1053.0)


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
    """Synthetic named configurations: "LOW"/"LOWBD2"... (512 stations of
    38 m out to 40 km) and "MID"... (197 dishes of 15 m out to 80 km), the
    JAX package's layouts; ``rmax`` keeps the stations within that
    radius. Any other name raises ``ValueError``."""
    from ..utils.coordinates import enu_to_xyz

    if name.startswith("LOW"):
        nants, diam, location, default_r = 512, 38.0, _LOW_LOCATION, 40000.0
    elif name.startswith("MID"):
        nants, diam, location, default_r = 197, 15.0, _MID_LOCATION, 80000.0
    else:
        raise ValueError(f"Unknown configuration {name}")
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
    computed on the host in f64, then moved to ``device`` (None: the CUDA
    card). ``elevation_limit`` (rad) drops integrations below it."""
    from ..utils.coordinates import hadec_to_azel, xyz_to_uvw

    device = resolve_device(device)
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
