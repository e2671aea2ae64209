"""Operations of the PyTorch port (plain PyTorch around hand-written
Hopper kernels: grid, degrid, permute, hogbom, hogbom_complex, msclean,
msmfs)."""

from .calibration_chain import (
    apply_calibration_chain,
    calibrate_chain,
    create_calibration_controls,
    solve_calibrate_chain,
)
from .cleaners import hogbom
from .deconvolution import bound_psf, fit_psf, restore_cube
from .dft import dft_skycomponent_visibility, idft_visibility_skycomponent
from .gain_ops import (
    apply_gaintable,
    apply_jones,
    concatenate_gaintables,
    multiply_gaintables,
)
from .gridding_plan import degrid_with_plan, grid_with_plan, make_grid_plan
from .imaging import (
    create_image_from_visibility,
    invert_visibility,
    invert_with_plan,
    make_imaging_plan,
    make_visibility_plan,
    predict_visibility,
    predict_with_plan,
)
from .permute import permute_apply
from .skycomponent_ops import restore_skycomponent
from .solvers import build_normal_equations, solve_gaintable, solve_gains_core
from .visibility_ops import (
    convert_visibility_stokesI_to_polframe,
    convert_visibility_to_stokes,
    convert_visibility_to_stokesI,
    divide_visibility,
    expand_polarizations,
    subtract_visibility,
)

__all__ = [
    "apply_calibration_chain",
    "calibrate_chain",
    "create_calibration_controls",
    "solve_calibrate_chain",
    "hogbom",
    "bound_psf",
    "fit_psf",
    "restore_cube",
    "dft_skycomponent_visibility",
    "idft_visibility_skycomponent",
    "apply_gaintable",
    "apply_jones",
    "concatenate_gaintables",
    "multiply_gaintables",
    "degrid_with_plan",
    "grid_with_plan",
    "make_grid_plan",
    "create_image_from_visibility",
    "invert_visibility",
    "invert_with_plan",
    "make_imaging_plan",
    "make_visibility_plan",
    "predict_visibility",
    "predict_with_plan",
    "permute_apply",
    "restore_skycomponent",
    "build_normal_equations",
    "solve_gaintable",
    "solve_gains_core",
    "convert_visibility_stokesI_to_polframe",
    "convert_visibility_to_stokes",
    "convert_visibility_to_stokesI",
    "divide_visibility",
    "expand_polarizations",
    "subtract_visibility",
]
