"""Roofline accounting of the port's work on the card.

Counterpart of ``ska_sdp_func_python_tpu/utils/roofline.py``, with its
names and keys; the peaks and the models are the card's and the port's:

- the peaks are one NVIDIA H100 SXM's published rates at its full power
  limit (NVIDIA's data sheet): 3.35 TB/s of HBM, 67 TFLOP/s in f32 and
  34 TFLOP/s in f64 outside the tensor cores. :data:`CARD` names the card
  and power limit, as ``nvidia-smi --query-gpu=name,power.limit`` prints
  them, that these peaks and ``chip_smoke.py``'s bounds assume;
- the models count the port's work as ``chip_smoke.py``'s bounds count
  it: every input read once and every output written once (``bytes``),
  and the arithmetic the function needs (``useful_flops``).
  ``executed_flops`` adds what the kernels issue beyond it: K1 walks
  every residue class of its period (the taps' width) for every entry,
  where only the window's cells do work.

:func:`roofline` folds a model and a measured time into fractions of the
peaks; ``mxu_frac`` and ``mxu_frac_useful`` keep the JAX names and read
the card's f32 (or f64) peak.
"""

from __future__ import annotations

import math

from ..ops.gridding_fused import tap_width, window_span

__all__ = [
    "CARD",
    "H100_PEAK_F32_FLOPS",
    "H100_PEAK_F64_FLOPS",
    "H100_HBM_BYTES_PER_S",
    "invert_model",
    "predict_model",
    "hogbom_model",
    "solver_model",
    "fused_cycle_model",
    "roofline",
]

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
H100_PEAK_F32_FLOPS = 67e12
H100_PEAK_F64_FLOPS = 34e12
H100_HBM_BYTES_PER_S = 3.35e12


def _complex_mac_flops() -> int:
    # a complex multiply-accumulate: 4 real products and 4 real sums
    return 8


def _fft_flops(npad: int) -> float:
    """5 N log2 N for one complex 2-D FFT of N = npad^2 points."""
    n = npad * npad
    return 5.0 * n * math.log2(n)


def invert_model(
    nvis: int,
    npixel: int,
    npad: int,
    support: int = 8,
    nw: int = 8,
    tile: int = 64,
    chunk: int = 2048,
    planes_touched: int = 2,
) -> dict:
    """Operations and bytes of one plan-path w-stacked invert: K1 (per
    entry its value, corner, 2 x span taps and plane fraction in; per
    window cell one tap product and, on each plane it adds to, a complex
    scale and add; the ``nw`` int64 planes written), then per plane an
    inverse FFT (read and written) and its w-beam multiply-accumulate, and
    the ``npixel``^2 f32 image written. ``tile`` and ``chunk`` only
    partition the work."""
    s = window_span(support)
    per_entry = 8 + 4 + 4 + 2 * 4 * s + (4 if planes_touched == 2 else 0)
    grid_ops = nvis * (s * s * (1 + 4 * planes_touched) + 5)
    grid_executed = nvis * (tap_width(s) ** 2 * (1 + 4 * planes_touched) + 5)
    plane_bytes = npad * npad * 8
    tail_ops = nw * (_fft_flops(npad) + npad * npad * _complex_mac_flops())
    return {
        "useful_flops": grid_ops + tail_ops,
        "executed_flops": grid_executed + tail_ops,
        "bytes": nvis * per_entry + nw * plane_bytes  # K1: entries in, planes out
        + nw * 3 * plane_bytes  # FFT in and out, the w-beam sum in
        + npixel * npixel * 4,
    }


def predict_model(
    nvis: int,
    npixel: int,
    npad: int,
    support: int = 8,
    nw: int = 8,
    planes_touched: int = 2,
) -> dict:
    """Operations and bytes of one plan-path w-stacked predict: the image
    in, per plane its w-beam product and FFT (written and read), then K3
    (per entry its corner, 2 x span taps, plane and fraction in and its
    value out; per plane read span row sums of span complex-by-real
    products and one of span) and K4's permutation of the values to
    natural order."""
    s = window_span(support)
    plane_bytes = npad * npad * 8
    per_entry = 4 + 4 + 2 * 4 * s + 8 + 4 + (4 if planes_touched == 2 else 0)
    degrid_ops = nvis * (planes_touched * (s * s * 4 + s * 4) + 6)
    head_ops = nw * (_fft_flops(npad) + npad * npad * 6)
    return {
        "useful_flops": degrid_ops + head_ops,
        "executed_flops": degrid_ops + head_ops,
        "bytes": npixel * npixel * 4 + nw * 2 * plane_bytes + nw * plane_bytes
        + nvis * per_entry + nvis * (4 + 8 + 8),
    }


def hogbom_model(niter: int, patch: int = 512) -> dict:
    """Hogbom's ``niter`` minor cycles on a ``patch``^2 f32 image: per
    iteration a search of the image (2 operations a pixel) and a PSF
    subtraction over it (2 a pixel); the dirty image and PSF read once and
    the residual written once (the loop keeps them on chip)."""
    img = patch * patch
    per_iter = img * 2 + img * 2
    return {
        "useful_flops": niter * per_iter,
        "executed_flops": niter * per_iter,
        "bytes": 3 * img * 4,
    }


def solver_model(niter: int, nsol: int, nants: int, nchan: int = 1) -> dict:
    """The batched StefCal solve: per iteration each antenna's update is a
    length-``nants`` complex dot over the normal equations (``[nsol,
    nants, nants, nchan]`` complex64), read once."""
    per_iter = nsol * nants * nants * nchan * _complex_mac_flops() * 2
    return {
        "useful_flops": niter * per_iter,
        "executed_flops": niter * per_iter,
        "bytes": nsol * nants * nants * nchan * 8 * 2,
    }


def roofline(model: dict, time_s: float, dtype: str = "f32") -> dict:
    """A model and a measured time as fractions of the card's peaks
    (``dtype`` "f32" or "f64" picks the operation peak)."""
    peak = H100_PEAK_F64_FLOPS if dtype == "f64" else H100_PEAK_F32_FLOPS
    return {
        "useful_gflop": round(model["useful_flops"] / 1e9, 2),
        "moved_gb": round(model["bytes"] / 1e9, 3),
        "mxu_frac": round(model["executed_flops"] / time_s / peak, 4),
        "mxu_frac_useful": round(model["useful_flops"] / time_s / peak, 4),
        "hbm_frac": round(model["bytes"] / time_s / H100_HBM_BYTES_PER_S, 4),
    }


def fused_cycle_model(
    nvis: int,
    npixel: int,
    npad: int,
    nants: int,
    nsol: int,
    support: int = 8,
    nw: int = 8,
    clean_niter: int = 300,
    solver_niter: int = 30,
) -> dict:
    """One fused self-cal major cycle (``pipeline.ical``'s): predict,
    normal equations, StefCal, gain apply, K4's two permutations of the
    values, invert and Hogbom. Per visibility the normal equations and
    the apply take one complex product and accumulate each (2 complex
    MACs) and read 8 words; each K4 permutation reads the index and one
    complex64 payload and writes the payload."""
    parts = (
        invert_model(nvis, npixel, npad, support=support, nw=nw),
        predict_model(nvis, npixel, npad, support=support, nw=nw),
        solver_model(solver_niter, nsol, nants),
        hogbom_model(clean_niter, patch=npixel),
    )
    ne_flops = nvis * 2 * _complex_mac_flops()
    extra_bytes = 2 * nvis * (4 + 8 + 8) + nvis * 8 * 4
    return {
        "useful_flops": sum(p["useful_flops"] for p in parts) + ne_flops,
        "executed_flops": sum(p["executed_flops"] for p in parts) + ne_flops,
        "bytes": sum(p["bytes"] for p in parts) + extra_bytes,
    }
