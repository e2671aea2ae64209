"""Beamformer calibration utilities: calibration solutions re-channelised
onto the correlator-beamformer's channels.

Counterpart of ``ska_sdp_func_python_tpu/ops/beamformer_utils.py``. The
delay expansion and the Jones products are tensor operations on the
gaintable's device; the spectral resamplers (the polynomial, linear and
cubic-spline interpolator classes) stay host numpy and scipy, as in the
JAX package, and their result returns to the gaintable's device.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import expi
from ..models.gaintable import GainTable

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = [
    "set_beamformer_frequencies",
    "expand_delay_phase",
    "multiply_gaintable_jones",
    "resample_bandpass",
    "PolynomialInterpolator",
    "NumpyLinearInterpolator",
    "ScipySplineInterpolator",
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def set_beamformer_frequencies(gain_table: GainTable, array: str = "LOW"):
    """The beamformer's channel frequencies over the gaintable's band, as
    host f64: LOW, multiples of 781.25 kHz (400 MHz / 512); MID, steps of
    300 MHz / 4096 from the first channel. One channel, or an unknown
    array, returns the gaintable's frequencies (with a warning)."""
    frequency_gt = _host(gain_table.frequency).astype(np.float64)
    if len(frequency_gt) <= 1:
        log.warning("Cannot rechannelise %d channel[s]", len(frequency_gt))
        return frequency_gt
    if array == "LOW":
        df = 781.25e3
        start = df * np.round(frequency_gt.min() / df)
    elif array == "MID":
        df = 300.0e6 / 4096
        start = frequency_gt.min()
    else:
        log.warning("Unknown array: %s. Frequencies unchanged", array)
        return frequency_gt
    return np.arange(start, frequency_gt.max(), df)


def expand_delay_phase(
    gain_table: GainTable, frequency, reference_to_centre: bool = True
) -> GainTable:
    """A one-channel delay ("K") gaintable expanded to a "B" bandpass on
    ``frequency``: phase(f) = (f / f0) phase(f0), or ((f - f0) / f0)
    phase(f0) with ``reference_to_centre``; unit weights, zero residual."""
    if gain_table.jones_type != "K":
        raise ValueError(f"Wrong Jones type: {gain_table.jones_type} != K")
    if gain_table.nchan != 1:
        raise ValueError("Expect a single frequency")
    dev = gain_table.gain.device
    frequency = torch.atleast_1d(torch.as_tensor(frequency, device=dev))
    f0 = gain_table.frequency[0]
    phase0 = torch.angle(gain_table.gain)[:, :, 0]  # [t, ant, rec, rec]
    freq = frequency - f0 if reference_to_centre else frequency
    gain = expi((freq / f0)[None, None, :, None, None].to(phase0.dtype)
                * phase0[:, :, None, :, :])
    shape = gain.shape
    return GainTable(
        gain=gain,
        weight=torch.ones(shape, dtype=gain_table.weight.dtype, device=dev),
        residual=torch.zeros((shape[0], shape[2], shape[3], shape[4]),
                             dtype=gain_table.residual.dtype, device=dev),
        time=gain_table.time,
        interval=gain_table.interval,
        frequency=frequency,
        jones_type="B",
        receptor_frame=gain_table.receptor_frame,
    )


def multiply_gaintable_jones(
    gain_table1: GainTable, gain_table2: GainTable, elementwise: bool = False
) -> GainTable:
    """The Jones product g1 @ g2 of two gaintables (elementwise with
    ``elementwise``), a one-channel table broadcast over the other's
    channels; frequency, weight and residual come from the table of many
    channels (the second when both have one)."""
    if gain_table1.jones_type == "K" or gain_table2.jones_type == "K":
        raise ValueError("Cannot multiply delays. Use expand_delay_phase")
    g1, g2 = gain_table1.gain, gain_table2.gain
    if g1.shape[0] != g2.shape[0]:
        raise ValueError("time axes differ")
    if g1.shape[1] != g2.shape[1]:
        raise ValueError("antenna axes differ")
    nchan = max(g1.shape[2], g2.shape[2])
    if g1.shape[2] not in (1, nchan) or g2.shape[2] not in (1, nchan):
        raise ValueError("frequency axes incompatible")
    g1 = g1.expand(*g1.shape[:2], nchan, *g1.shape[3:])
    g2 = g2.expand(*g2.shape[:2], nchan, *g2.shape[3:])
    gain = g1 * g2 if elementwise else torch.einsum("...ij,...jk->...ik", g1, g2)
    src = gain_table1 if gain_table1.gain.shape[2] > 1 else gain_table2
    jones_type = (
        gain_table1.jones_type if gain_table1.jones_type == gain_table2.jones_type else "B"
    )
    return GainTable(
        gain=gain,
        weight=src.weight.expand(gain.shape),
        residual=src.residual,
        time=gain_table1.time,
        interval=gain_table1.interval,
        frequency=src.frequency,
        jones_type=jones_type,
        receptor_frame=gain_table1.receptor_frame,
    )


class PolynomialInterpolator:
    """Piecewise polynomial fit of the real and imaginary parts over
    frequency sub-bands (split at the channel indices ``edges``), degree
    ``polydeg`` (3) or fewer where a sub-band has fewer channels; host
    numpy."""

    def __init__(self):
        self.edges = None
        self.polydeg = 3

    def set_edges(self, edges, nchan):
        self.edges = list(edges)

    def set_polydeg(self, polydeg):
        self.polydeg = int(polydeg)

    def interp(self, freq_in, values, freq_out):
        freq_in = np.asarray(freq_in)
        freq_out = np.asarray(freq_out)
        values = np.asarray(values)
        edges = self.edges or []
        bounds = [0] + [e for e in edges if 0 < e < len(freq_in)] + [len(freq_in)]
        out = np.zeros(freq_out.shape, dtype=values.dtype)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            fi = freq_in[lo:hi]
            sel = (freq_out >= fi[0]) & (freq_out <= fi[-1])
            if lo == bounds[0]:
                sel |= freq_out < fi[0]
            if hi == bounds[-1]:
                sel |= freq_out > fi[-1]
            deg = min(self.polydeg, len(fi) - 1)
            cr = np.polynomial.polynomial.polyfit(fi, values[lo:hi].real, deg)
            ci = np.polynomial.polynomial.polyfit(fi, values[lo:hi].imag, deg)
            out[sel] = np.polynomial.polynomial.polyval(
                freq_out[sel], cr
            ) + 1j * np.polynomial.polynomial.polyval(freq_out[sel], ci)
        return out


class NumpyLinearInterpolator:
    """Linear interpolation of the real and imaginary parts (host
    ``np.interp``)."""

    def interp(self, freq_in, values, freq_out):
        return np.interp(freq_out, freq_in, np.real(values)) + 1j * np.interp(
            freq_out, freq_in, np.imag(values)
        )


class ScipySplineInterpolator:
    """Cubic-spline interpolation of the real and imaginary parts (host
    ``scipy.interpolate.CubicSpline``)."""

    def interp(self, freq_in, values, freq_out):
        from scipy.interpolate import CubicSpline

        sr = CubicSpline(freq_in, np.real(values))
        si = CubicSpline(freq_in, np.imag(values))
        return sr(freq_out) + 1j * si(freq_out)


def resample_bandpass(
    frequency_out, gain_table: GainTable, alg: str = "polyfit", edges=None,
    polydeg=None,
) -> GainTable:
    """The gaintable's spectra re-channelised onto ``frequency_out`` by
    ``alg``: "polyfit" (:class:`PolynomialInterpolator`, with ``edges``
    and ``polydeg``), "interp" (linear) or "cubicspl"; unit weights, zero
    residual."""
    frequency_gt = _host(gain_table.frequency)
    if alg == "polyfit":
        interpolator = PolynomialInterpolator()
        if edges is not None:
            interpolator.set_edges(edges, len(frequency_gt))
        if polydeg is not None:
            interpolator.set_polydeg(polydeg)
    elif alg == "interp":
        interpolator = NumpyLinearInterpolator()
    elif alg == "cubicspl":
        interpolator = ScipySplineInterpolator()
    else:
        raise ValueError(f"unknown resampler {alg}")
    gain = _host(gain_table.gain)
    ntime, nants, _, nrec, _ = gain.shape
    frequency_out = np.asarray(frequency_out)
    out = np.zeros((ntime, nants, len(frequency_out), nrec, nrec), dtype=gain.dtype)
    for t in range(ntime):
        for a in range(nants):
            for r1 in range(nrec):
                for r2 in range(nrec):
                    out[t, a, :, r1, r2] = interpolator.interp(
                        frequency_gt, gain[t, a, :, r1, r2], frequency_out
                    )
    dev = gain_table.gain.device
    return GainTable(
        gain=torch.as_tensor(out, device=dev),
        weight=torch.ones(out.shape, dtype=gain_table.weight.dtype, device=dev),
        residual=torch.zeros((ntime, len(frequency_out), nrec, nrec),
                             dtype=gain_table.residual.dtype, device=dev),
        time=gain_table.time,
        interval=gain_table.interval,
        frequency=torch.as_tensor(frequency_out, device=dev),
        jones_type=gain_table.jones_type,
        receptor_frame=gain_table.receptor_frame,
    )
