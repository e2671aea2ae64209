"""Dtype and precision policy of the PyTorch port.

Counterpart of ``ska_sdp_func_python_tpu/config.py``. On the device the
port computes in float32/complex64; float64/complex128 is opt-in by handing
a constructor f64 inputs (the tests do, to compare with the JAX package run
under x64). Working dtypes are derived from the inputs, never from global
state.

TF32 keeps about three decimal digits; it is Hopper's version of the bf16
single-pass trap, so both of PyTorch's TF32 switches are pinned off when
this module is imported.
"""

from __future__ import annotations

import torch

__all__ = [
    "complex_of",
    "real_of",
    "frac_dot_turns",
    "expi",
    "not_ported",
    "default_device",
    "resolve_device",
    "plan_cache_size",
    "set_plan_cache_size",
    "UNPORTED",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Plans kept by invert_visibility/predict_visibility when no plan is
# passed, keyed on the identity of the Visibility's uvw and frequency
# tensors. Each holds the sorted plan on the device (~100 bytes per
# visibility), so the default is small; 0 disables the cache.
_PLAN_CACHE_SIZE: int = 2


def plan_cache_size() -> int:
    return _PLAN_CACHE_SIZE


def set_plan_cache_size(n: int) -> None:
    global _PLAN_CACHE_SIZE
    _PLAN_CACHE_SIZE = int(n)
    if _PLAN_CACHE_SIZE <= 0:
        from .ops import imaging

        imaging._PLAN_CACHE.clear()


def real_of(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching ``dtype`` (f64 for f64/c128, else f32)."""
    if dtype in (torch.float64, torch.complex128):
        return torch.float64
    return torch.float32


def complex_of(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype matching ``dtype`` (c128 for f64/c128, else c64)."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def expi(phase: torch.Tensor) -> torch.Tensor:
    """exp(1j * phase) for a real tensor."""
    return torch.polar(torch.ones_like(phase), phase)


def frac_dot_turns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fractional part, in turns, of ``sum_k a[..., k] * b[..., k]``.

    Interferometric phases span thousands of turns, so a plain f32 dot
    followed by cos/sin loses ``|phase| * eps``. In f32 each product is
    formed as four error-free partials through Dekker's 12-bit split
    (hi*hi, hi*lo, lo*hi exact in f32; lo*lo negligible) and each partial
    is reduced mod 1 exactly, which keeps the summed fraction accurate to a
    few f32 ulps whatever the phase magnitude. In f64 the plain reduced dot
    is already accurate. Same contract as the JAX package's
    ``config.frac_dot_turns``: ``a`` and ``b`` broadcast with the
    contraction axis last; returns turns reduced to roughly [-2, 2].
    """
    if torch.promote_types(a.dtype, b.dtype) == torch.float64:
        d = (a * b).sum(-1)
        return d - torch.round(d)

    def frac(x):
        return x - torch.round(x)

    def split(x):
        c = 4097.0 * x  # 2**12 + 1
        hi = c - (c - x)
        return hi, x - hi

    total = None
    for k in range(a.shape[-1]):
        xh, xl = split(a[..., k].to(torch.float32))
        yh, yl = split(b[..., k].to(torch.float32))
        t = frac(xh * yh) + frac(xh * yl) + frac(xl * yh) + xl * yl
        total = t if total is None else total + t
    return frac(total)


def default_device() -> torch.device:
    """The device the port's constructors use when the caller names none:
    the CUDA card. Raises when there is none; the CPU is taken only when
    the caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for
    None."""
    return default_device() if device is None else torch.device(device)


def not_ported(what: str, slice_: str) -> NotImplementedError:
    """The error every branch outside the ported slice raises: names the
    ROADMAP slice that will bring it."""
    return NotImplementedError(
        f"{what} is not ported yet; it comes with ROADMAP slice {slice_}"
    )


def _slice(slice_: str, names: str) -> dict:
    return {name: slice_ for name in names.split()}


# The public names of the JAX package's ``ops`` and ``models`` namespaces
# that the port does not have yet, each with the ROADMAP slice that brings
# it. Every other name of those namespaces (and of ``io`` and
# ``pipeline``) is exported by the port under its JAX name; a test holds
# the two lists apart, so a name leaves this table when its slice lands.
UNPORTED: dict = {
    # S11: the periphery, on no pipeline path
    **_slice("S11", """
        PolynomialInterpolator NumpyLinearInterpolator ScipySplineInterpolator
        set_beamformer_frequencies expand_delay_phase multiply_gaintable_jones
        resample_bandpass
        coordinates coordinates2 coordinate_bounds coordinates2_offset
        coordinateBounds coordinates2Offset extract_oversampled
        dft_cpu_looped dft_gpu_raw_kernel
        convolutional_grid convolutional_degrid
        convert_stokes_to_polimage convert_polimage_to_stokes
        calculate_skycomponent_list_taylor_terms
        find_skycomponents_frequency_taylor_terms
        gather_skycomponents_from_channels interpolate_skycomponents_frequency
        transpose_skycomponents_to_channels
        apply_beam_to_skycomponent apply_voltage_pattern_to_skycomponent
        filter_skycomponents_by_flux find_nearest_skycomponent
        find_nearest_skycomponent_index find_separation_skycomponents
        find_skycomponent_matches select_components_by_separation
        remove_neighbouring_components find_skycomponents insert_skycomponent
        voronoi_decomposition image_voronoi_iter
        partition_skycomponent_neighbours fit_skycomponent
        fit_skycomponent_spectral_index calculate_skycomponent_taylor_terms
        find_skycomponent_matches_atomic select_neighbouring_components
        skymodel_predict_calibrate skymodel_calibrate_invert
        Parset create_parset_from_context gaincal dp3_gaincal
        convolution_mapping_visibility spatial_mapping
        create_pswf_convolutionfunction create_awterm_convolutionfunction
        create_griddata_from_image grid_visibility_to_griddata
        degrid_visibility_from_griddata grid_visibility_weight_to_griddata
        griddata_merge_weights griddata_visibility_reweight
        fft_griddata_to_image fft_image_to_griddata
        predict_awprojection invert_awprojection
        get_direction_time_location calculate_visibility_hourangles
        calculate_visibility_parallactic_angles calculate_visibility_azel
        calculate_visibility_transit_time
        concatenate_visibility concatenate_visibility_frequency
        remove_continuum_visibility integrate_visibility_by_channel
        average_visibility_by_channel calculate_visibility_uvw_lambda
        GridData SkyModel
    """),
}
