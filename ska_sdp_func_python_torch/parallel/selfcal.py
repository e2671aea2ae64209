"""Distributed self-calibration major cycles over a mesh.

Counterpart of ``ska_sdp_func_python_tpu/parallel/selfcal.py``. Per
major cycle, with visibility rows sharded over the "data" axis:

    model vis   = distributed_predict(model image) + DFT(components)
    gaintable   = distributed_solve_gaintable (normal equations summed)
    corrected   = apply_gaintable(inverse)            [row-local]
    residual    = corrected - model vis               [row-local]
    dirty       = distributed_invert (dirty image summed)
    model      += deconvolve(dirty, psf)              [replicated CLEAN]

The only reductions are the sums inside the solve and the invert.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ..models.components import SkyComponents
from ..models.image import Image
from ..models.visibility import Visibility
from ..ops.deconvolution import deconvolve_cube, restore_cube
from ..ops.dft import dft_skycomponent_visibility
from ..ops.gain_ops import apply_gaintable
from .distributed import distributed_invert, distributed_predict, distributed_solve_gaintable
from .mesh import Mesh

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["distributed_ical"]


def distributed_ical(
    vis: Visibility,
    model: Image,
    mesh: Mesh,
    components: Optional[SkyComponents] = None,
    nmajor: int = 5,
    axis: str = "data",
    phase_only: bool = True,
    jones_type: str = "T",
    timeslice=None,
    support: int = 8,
    nw: int = 1,
    do_wstacking: bool = False,
    **clean_kwargs,
):
    """Distributed ICAL over a mesh.

    :return: (model Image, residual Image, restored Image, GainTable)
    """
    imaging = dict(axis=axis, support=support, nw=nw, do_wstacking=do_wstacking)
    psf, _ = distributed_invert(vis, model, mesh, dopsf=True, **imaging)
    log.info("distributed_ical: PSF ready, %d shards, %d visibilities", mesh.nshards, vis.nvis)
    current = model.replace(pixels=torch.zeros_like(model.pixels))
    residual = gt = None
    for cycle in range(nmajor):
        mvis = vis.replace(vis=torch.zeros_like(vis.vis))
        if bool(current.pixels.abs().max() > 0.0):
            mvis = distributed_predict(mvis, current, mesh, **imaging)
        if components is not None and components.ncomp > 0:
            cvis = dft_skycomponent_visibility(vis.replace(vis=torch.zeros_like(vis.vis)), components)
            mvis = mvis.replace(vis=mvis.vis + cvis.vis)
        gt = distributed_solve_gaintable(
            vis, mvis, mesh, axis=axis, phase_only=phase_only,
            jones_type=jones_type, timeslice=timeslice,
        )
        corrected = apply_gaintable(vis, gt, inverse=True)
        rvis = corrected.replace(vis=corrected.vis - mvis.vis)
        residual, _ = distributed_invert(rvis, model, mesh, **imaging)
        comp, _ = deconvolve_cube(residual, psf, **clean_kwargs)
        current = current.replace(pixels=current.pixels + comp.pixels)
        if log.isEnabledFor(logging.INFO):
            log.info(
                "distributed_ical: cycle %d peak residual %.6f",
                cycle, float(residual.pixels.abs().max()),
            )
    restored = restore_cube(current, psf=psf, residual=residual)
    return current, residual, restored, gt
