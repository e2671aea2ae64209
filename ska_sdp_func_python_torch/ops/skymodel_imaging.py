"""Sky-model predict and invert: the body of a self-calibration major
cycle.

Counterpart of ``ska_sdp_func_python_tpu/ops/skymodel_imaging.py``: model
-> visibilities adds the components' DFT and the image's predict (K3, K4
and the FFTs on a plan), optionally under a per-time primary beam and a
mask, then applies the sky model's gaintable; visibilities -> image
applies the gaintable and inverts (K1 on a plan), accumulating
primary-beam flats when a beam is given.
"""

from __future__ import annotations

import torch

from ..models.components import SkyModel
from ..models.visibility import Visibility
from .dft import dft_skycomponent_visibility
from .gain_ops import apply_gaintable
from .imaging import invert_visibility, predict_visibility
from .skycomponent_ops import apply_beam_to_skycomponent
from .visibility_ops import concatenate_visibility

__all__ = ["skymodel_predict_calibrate", "skymodel_calibrate_invert"]


def _mask_tensor(mask, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mask, device=like.device).to(like.dtype)


def _mask_image(image, mask, pb=None):
    pixels = image.pixels
    if mask is not None:
        pixels = pixels * _mask_tensor(mask, pixels)
    if pb is not None:
        pixels = pixels * pb.pixels
    return image.replace(pixels=pixels)


def _time_slices(vis: Visibility):
    """One-integration Visibilities, in time order."""
    for t in range(vis.ntimes):
        sl = slice(t, t + 1)
        yield vis.replace(
            vis=vis.vis[sl], weight=vis.weight[sl],
            imaging_weight=vis.imaging_weight[sl], flags=vis.flags[sl],
            uvw=vis.uvw[sl], time=vis.time[sl],
            integration_time=vis.integration_time[sl],
        )


def skymodel_predict_calibrate(
    bvis: Visibility,
    skymodel: SkyModel,
    context: str = "ng",
    docal: bool = False,
    inverse: bool = True,
    get_pb=None,
    **kwargs,
) -> Visibility:
    """The visibilities of a sky model: its components' DFT (weighted by
    the mask and, with ``get_pb``, by each integration's primary beam)
    plus the predict of its image (masked and beam-weighted alike, when
    any pixel is non-zero); with ``docal``, the sky model's gaintable
    applied (``inverse`` as ``apply_gaintable``'s). ``kwargs`` go to
    ``predict_visibility``."""

    def predict_slice(vslice, pb=None):
        v = vslice.replace(vis=torch.zeros_like(vslice.vis))
        comps = skymodel.components
        if comps is not None and comps.ncomp > 0:
            if skymodel.mask is not None:
                pixels = skymodel.image.pixels
                mask_im = skymodel.image.replace(
                    pixels=_mask_tensor(skymodel.mask, pixels).expand(pixels.shape)
                )
                comps = apply_beam_to_skycomponent(comps, mask_im)
            if pb is not None:
                comps = apply_beam_to_skycomponent(comps, pb)
            v = dft_skycomponent_visibility(v, comps)
        image = skymodel.image
        if image is not None and bool(image.pixels.abs().max() > 0.0):
            model = _mask_image(image, skymodel.mask, pb)
            imgv = predict_visibility(
                vslice.replace(vis=torch.zeros_like(vslice.vis)), model,
                context=context, **kwargs,
            )
            v = v.replace(vis=v.vis + imgv.vis)
        return v

    if get_pb is not None:
        v = concatenate_visibility(
            [predict_slice(s, pb=get_pb(s, skymodel.image)) for s in _time_slices(bvis)],
            "time",
        )
    else:
        v = predict_slice(bvis)
    if docal and skymodel.gaintable is not None:
        v = apply_gaintable(v, skymodel.gaintable, inverse=inverse)
    return v


def skymodel_calibrate_invert(
    bvis: Visibility,
    skymodel: SkyModel,
    context: str = "ng",
    docal: bool = False,
    get_pb=None,
    normalise: bool = True,
    flat_sky: bool = False,
    **kwargs,
):
    """With ``docal`` apply the sky model's gaintable, then invert onto
    its image. Without ``get_pb``: returns (dirty image, masked by the sky
    model's mask, sumwt). With it: each integration's dirty image weighted
    by its flat (mask times primary beam) is summed, normalised by the sum
    of flat^2 times sumwt (by its square root with ``flat_sky``), and
    (image, image of the sqrt of that sum) is returned. ``kwargs`` go to
    ``invert_visibility``."""
    if skymodel.image is None:
        raise ValueError("skymodel image is None")
    vis = bvis
    if docal and skymodel.gaintable is not None:
        vis = apply_gaintable(vis, skymodel.gaintable)
    if get_pb is None:
        dirty, sumwt = invert_visibility(
            vis, skymodel.image, context=context, normalise=normalise, **kwargs
        )
        if skymodel.mask is not None:
            dirty = dirty.replace(pixels=dirty.pixels * _mask_tensor(skymodel.mask, dirty.pixels))
        return dirty, sumwt
    pixels = skymodel.image.pixels
    sum_dirty = torch.zeros_like(pixels)
    sum_flats = torch.zeros_like(pixels)
    for vslice in _time_slices(vis):
        pb = get_pb(vslice, skymodel.image)
        dirty, sumwt = invert_visibility(
            vslice, skymodel.image, context=context, normalise=False, **kwargs
        )
        flat = torch.ones_like(dirty.pixels)
        if skymodel.mask is not None:
            flat = flat * _mask_tensor(skymodel.mask, flat)
        if pb is not None:
            flat = flat * pb.pixels
        sum_dirty = sum_dirty + flat * dirty.pixels
        sum_flats = sum_flats + flat * flat * torch.as_tensor(
            sumwt, device=flat.device).to(flat.dtype)[:, :, None, None]
    out = skymodel.image.replace(pixels=sum_dirty)
    if normalise:
        norm = torch.sqrt(sum_flats) if flat_sky else sum_flats
        ok = norm > 0.0
        out = out.replace(pixels=torch.where(ok, out.pixels / torch.where(ok, norm, 1.0), 0.0))
        sum_flats = torch.sqrt(sum_flats)
    return out, skymodel.image.replace(pixels=sum_flats)
