"""Operations of the PyTorch port (plain PyTorch around hand-written
Hopper kernels: grid, degrid, permute, hogbom, hogbom_complex, msclean,
msmfs, unit_tiles).

Every ported public name of the JAX package's ``ops`` namespace is
exported here under its JAX name; the names still to port are listed,
with the ROADMAP slice that brings them, in ``config.UNPORTED``.
"""

from .accuracy import GriddingAccuracy, gridding_params_for_epsilon, nw_for_epsilon
from .calibration_chain import (
    apply_calibration_chain,
    calibrate_chain,
    create_calibration_controls,
    solve_calibrate_chain,
)
from .cleaners import (
    calculate_scale_inverse_moment_moment_hessian,
    calculate_scale_moment_residual,
    calculate_scale_scale_moment_moment_psf,
    convolve_convolve_scalestack,
    convolve_scalestack,
    create_scalestack,
    hogbom,
    hogbom_complex,
    msclean,
    msmfsclean,
)
from .deconvolution import (
    bound_psf,
    common_arguments,
    convert_clean_beam_to_degrees,
    convert_clean_beam_to_pixels,
    deconvolve_cube,
    find_window,
    fit_psf,
    restore_cube,
)
from .dft import (
    dft_kernel,
    dft_skycomponent_visibility,
    extract_direction_and_flux,
    idft_visibility_skycomponent,
)
from .fft import extract_mid, fft, ifft, pad_mid
from .gain_ops import (
    apply_gaintable,
    apply_jones,
    concatenate_gaintables,
    multiply_gaintables,
)
from .gridding import grid_correction, grid_weights_nearest, reweight_imaging_weights
from .gridding_plan import degrid_with_plan, grid_with_plan, make_grid_plan
from .imaging import (
    ImagingPlan,
    VisibilityImagingPlan,
    create_image_from_visibility,
    invert_ng,
    invert_visibility,
    invert_wg,
    invert_with_plan,
    make_imaging_plan,
    make_visibility_plan,
    normalise_sumwt,
    predict_ng,
    predict_visibility,
    predict_wg,
    predict_with_plan,
    rad_deg_arcsec,
    shift_vis_to_image,
)
from .permute import permute_apply
from .pswf import grdsf, w_beam
from .skycomponent_ops import restore_skycomponent
from .solvers import build_normal_equations, solve_gaintable, solve_gains_core
from .taylor import (
    calculate_image_frequency_moments,
    calculate_image_from_frequency_taylor_terms,
)
from .visibility_ops import (
    calculate_visibility_phasor,
    convert_visibility_stokesI_to_polframe,
    convert_visibility_to_stokes,
    convert_visibility_to_stokesI,
    divide_visibility,
    expand_polarizations,
    phaserotate_visibility,
    subtract_visibility,
)
from .weighting import weight_visibility

__all__ = [
    "GriddingAccuracy",
    "gridding_params_for_epsilon",
    "nw_for_epsilon",
    "apply_calibration_chain",
    "calibrate_chain",
    "create_calibration_controls",
    "solve_calibrate_chain",
    "calculate_scale_inverse_moment_moment_hessian",
    "calculate_scale_moment_residual",
    "calculate_scale_scale_moment_moment_psf",
    "convolve_convolve_scalestack",
    "convolve_scalestack",
    "create_scalestack",
    "hogbom",
    "hogbom_complex",
    "msclean",
    "msmfsclean",
    "bound_psf",
    "common_arguments",
    "convert_clean_beam_to_degrees",
    "convert_clean_beam_to_pixels",
    "deconvolve_cube",
    "find_window",
    "fit_psf",
    "restore_cube",
    "dft_kernel",
    "dft_skycomponent_visibility",
    "extract_direction_and_flux",
    "idft_visibility_skycomponent",
    "extract_mid",
    "fft",
    "ifft",
    "pad_mid",
    "apply_gaintable",
    "apply_jones",
    "concatenate_gaintables",
    "multiply_gaintables",
    "grid_correction",
    "grid_weights_nearest",
    "reweight_imaging_weights",
    "degrid_with_plan",
    "grid_with_plan",
    "make_grid_plan",
    "ImagingPlan",
    "VisibilityImagingPlan",
    "create_image_from_visibility",
    "invert_ng",
    "invert_visibility",
    "invert_wg",
    "invert_with_plan",
    "make_imaging_plan",
    "make_visibility_plan",
    "normalise_sumwt",
    "predict_ng",
    "predict_visibility",
    "predict_wg",
    "predict_with_plan",
    "rad_deg_arcsec",
    "shift_vis_to_image",
    "permute_apply",
    "grdsf",
    "w_beam",
    "restore_skycomponent",
    "build_normal_equations",
    "solve_gaintable",
    "solve_gains_core",
    "calculate_image_frequency_moments",
    "calculate_image_from_frequency_taylor_terms",
    "calculate_visibility_phasor",
    "convert_visibility_stokesI_to_polframe",
    "convert_visibility_to_stokes",
    "convert_visibility_to_stokesI",
    "divide_visibility",
    "expand_polarizations",
    "phaserotate_visibility",
    "subtract_visibility",
    "weight_visibility",
]
