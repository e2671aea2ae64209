"""Reductions over lists of invert and predict results.

Counterpart of ``ska_sdp_func_python_tpu/ops/imaging_helpers.py``: the
sums a pipeline takes over per-facet or per-channel results (plain
PyTorch, host-side control).
"""

from __future__ import annotations

import torch

from .imaging import normalise_sumwt
from .taylor import calculate_image_frequency_moments

__all__ = [
    "sum_invert_results",
    "remove_sumwt",
    "sum_predict_results",
    "threshold_list",
]


def sum_invert_results(image_list):
    """Sum of weights-weighted images over ``[(image, sumwt), ...]``,
    normalised by the summed weights. Returns (image, sumwt); ``None``
    items are skipped."""
    if len(image_list) == 1:
        return image_list[0][0], image_list[0][1]
    im0 = image_list[0][0]
    pixels = torch.zeros_like(im0.pixels)
    sumwt = torch.zeros_like(torch.as_tensor(image_list[0][1]))
    for item in image_list:
        if item is None:
            continue
        img, swt = item
        swt = torch.as_tensor(swt)
        pixels = pixels + swt[..., None, None] * img.pixels
        sumwt = sumwt + swt
    return normalise_sumwt(im0.replace(pixels=pixels), sumwt), sumwt


def remove_sumwt(results):
    """[(image, sumwt), ...] -> [image, ...]."""
    return [d[0] for d in results]


def sum_predict_results(results):
    """The Visibility whose visibilities are the sum over ``results``
    (``None`` items skipped; the first one's metadata)."""
    total = None
    for result in results:
        if result is None:
            continue
        total = result if total is None else total.replace(vis=total.vis + result.vis)
    return total


def threshold_list(
    imagelist,
    threshold: float,
    fractional_threshold: float,
    use_moment0: bool = True,
):
    """The minor cycle's threshold over a list of image cubes: the larger
    of ``threshold`` and ``fractional_threshold`` times the peak, the peak
    of |moment 0 / nchan| (``use_moment0``) or of the middle channel."""
    peak = 0.0
    for result in imagelist:
        if use_moment0:
            moments = calculate_image_frequency_moments(result)
            this_peak = float(
                torch.max(torch.abs(moments.pixels[0] / result.pixels.shape[0]))
            )
        else:
            ref_chan = result.pixels.shape[0] // 2
            this_peak = float(torch.max(torch.abs(result.pixels[ref_chan])))
        peak = max(peak, this_peak)
    return max(peak * fractional_threshold, threshold)
