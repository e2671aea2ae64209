"""Quality-assessment summaries of images, gaintables and visibilities as
plain dictionaries (host numpy statistics of the tensors).

Counterpart of ``ska_sdp_func_python_tpu/utils/qa.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["qa_image", "qa_gain_table", "qa_visibility"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def qa_image(im, context: str = "") -> dict:
    """Image statistics: shape, max, min, max |x|, rms, sum, median |x|
    and median."""
    pixels = _host(im.pixels)
    return {
        "context": context,
        "shape": tuple(pixels.shape),
        "max": float(np.max(pixels)),
        "min": float(np.min(pixels)),
        "maxabs": float(np.max(np.abs(pixels))),
        "rms": float(np.std(pixels)),
        "sum": float(np.sum(pixels)),
        "medianabs": float(np.median(np.abs(pixels))),
        "median": float(np.median(pixels)),
    }


def qa_gain_table(gt, context: str = "") -> dict:
    """Gaintable statistics: amplitude extremes, rms and median, phase
    extreme and rms, and the largest residual."""
    gain = _host(gt.gain)
    amp = np.abs(gain)
    phase = np.angle(gain)
    return {
        "context": context,
        "shape": tuple(gain.shape),
        "maxabs-amp": float(np.max(amp)),
        "minabs-amp": float(np.min(amp)),
        "rms-amp": float(np.std(amp)),
        "medianabs-amp": float(np.median(amp)),
        "maxabs-phase": float(np.max(np.abs(phase))),
        "rms-phase": float(np.std(phase)),
        "residual": float(np.max(_host(gt.residual))),
    }


def qa_visibility(vis, context: str = "") -> dict:
    """Visibility statistics: |V| extremes, rms and median, the summed
    unflagged weight and the flagged fraction."""
    data = _host(vis.vis)
    return {
        "context": context,
        "shape": tuple(data.shape),
        "maxabs": float(np.max(np.abs(data))),
        "minabs": float(np.min(np.abs(data))),
        "rms": float(np.std(data)),
        "medianabs": float(np.median(np.abs(data))),
        "sum_weight": float(np.sum(_host(vis.flagged_weight))),
        "fraction_flagged": float(np.mean(_host(vis.flags) > 0)),
    }
