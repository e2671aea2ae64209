"""Operations of the PyTorch port (plain PyTorch around four hand-written
Hopper kernels: grid, degrid, permute, hogbom)."""

from .calibration_chain import create_calibration_controls
from .cleaners import hogbom
from .deconvolution import bound_psf, fit_psf, restore_cube
from .dft import dft_skycomponent_visibility
from .gain_ops import apply_gaintable
from .gridding_plan import degrid_with_plan, grid_with_plan, make_grid_plan
from .imaging import (
    create_image_from_visibility,
    invert_visibility,
    invert_with_plan,
    make_imaging_plan,
    make_visibility_plan,
    predict_with_plan,
)
from .permute import permute_apply
from .solvers import solve_gains_core

__all__ = [
    "create_calibration_controls",
    "hogbom",
    "bound_psf",
    "fit_psf",
    "restore_cube",
    "dft_skycomponent_visibility",
    "apply_gaintable",
    "degrid_with_plan",
    "grid_with_plan",
    "make_grid_plan",
    "create_image_from_visibility",
    "invert_visibility",
    "invert_with_plan",
    "make_imaging_plan",
    "make_visibility_plan",
    "predict_with_plan",
    "permute_apply",
    "solve_gains_core",
]
