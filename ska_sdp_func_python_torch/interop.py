"""Carry state from the JAX package into the port.

Each function takes an object of the JAX package (or anything with the
same fields), reads every field through ``np.asarray`` and builds the
port's object on a chosen device (None: the CUDA card), keeping the numpy
dtypes (a JAX object made under x64 arrives in f64; the time axes are f64
always, as in the port's models) and the shapes (2x2 gaintables of
polarised data included); polarisation frames arrive as their names. Nothing here imports JAX: the arrays arrive as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .models.components import SkyComponents
from .models.gaintable import GainTable
from .models.image import Image
from .models.polarisation import frame_name
from .models.visibility import Visibility

__all__ = [
    "to_visibility",
    "to_image",
    "to_gaintable",
    "to_skycomponents",
    "permutation_from_backsort_keys",
]


def _t(x, device):
    return torch.as_tensor(np.array(np.asarray(x)), device=device)


def to_visibility(vis, device=None) -> Visibility:
    device = resolve_device(device)
    return Visibility(
        vis=_t(vis.vis, device),
        weight=_t(vis.weight, device),
        imaging_weight=_t(vis.imaging_weight, device),
        flags=_t(vis.flags, device).to(torch.int32),
        uvw=_t(vis.uvw, device),
        time=_t(vis.time, device).to(torch.float64),
        integration_time=_t(vis.integration_time, device).to(torch.float64),
        frequency=_t(vis.frequency, device),
        channel_bandwidth=_t(vis.channel_bandwidth, device),
        antenna1=_t(vis.antenna1, device).to(torch.int32),
        antenna2=_t(vis.antenna2, device).to(torch.int32),
        phasecentre=np.asarray(vis.phasecentre, np.float64),
        polarisation_frame=frame_name(vis.polarisation_frame),
        nants=int(vis.nants),
        station_diameter=float(vis.station_diameter),
    )


def to_image(im, device=None) -> Image:
    device = resolve_device(device)
    return Image(
        pixels=_t(im.pixels, device),
        frequency=np.asarray(im.frequency, np.float64),
        channel_bandwidth=np.asarray(im.channel_bandwidth, np.float64),
        phasecentre=np.asarray(im.phasecentre, np.float64),
        clean_beam=None
        if im.clean_beam is None
        else np.asarray(im.clean_beam, np.float64),
        cellsize=float(im.cellsize),
        polarisation_frame=frame_name(im.polarisation_frame),
    )


def to_gaintable(gt, device=None) -> GainTable:
    device = resolve_device(device)
    return GainTable(
        gain=_t(gt.gain, device),
        weight=_t(gt.weight, device),
        residual=_t(gt.residual, device),
        time=_t(gt.time, device).to(torch.float64),
        interval=_t(gt.interval, device).to(torch.float64),
        frequency=_t(gt.frequency, device),
        jones_type=str(gt.jones_type),
        receptor_frame=str(gt.receptor_frame),
    )


def to_skycomponents(sc, device=None) -> SkyComponents:
    device = resolve_device(device)
    return SkyComponents(
        direction=np.asarray(sc.direction, np.float64),
        flux=_t(sc.flux, device),
        frequency=_t(sc.frequency, device),
        shape_params=_t(sc.shape_params, device),
        shape=str(sc.shape),
        polarisation_frame=frame_name(sc.polarisation_frame),
    )


def permutation_from_backsort_keys(keys) -> np.ndarray:
    """The int32 permutation (sorted position -> original index) from a
    JAX ``GridPlan``'s back-sort key row: ``geo[3, :n]`` holds the int32
    indices bit-cast to f32."""
    keys = np.ascontiguousarray(np.asarray(keys), dtype=np.float32)
    return keys.view(np.int32).copy()
