"""Data models of the PyTorch port: dataclasses of tensors.

Every ported public name of the JAX package's ``models`` namespace is
exported here under its JAX name.
"""

from .components import SkyComponents, SkyModel
from .configuration import (
    Configuration,
    create_named_configuration,
    create_visibility,
    random_array_xyz,
)
from .gaintable import GainTable, create_gaintable_from_visibility
from .griddata import GridData
from .image import Image, create_image
from .polarisation import (
    PolarisationFrame,
    congruent_polarisation,
    convert_circular_to_stokes,
    convert_circular_to_stokesI,
    convert_linear_to_stokes,
    convert_linear_to_stokesI,
    convert_pol_frame,
    convert_stokes_to_circular,
    convert_stokes_to_linear,
    convert_stokesI_to_polframe,
    correlate_polarisation,
)
from .visibility import C_M_S, Visibility, create_visibility_from_arrays

__all__ = [
    "SkyComponents",
    "SkyModel",
    "Configuration",
    "create_named_configuration",
    "create_visibility",
    "random_array_xyz",
    "GainTable",
    "create_gaintable_from_visibility",
    "GridData",
    "Image",
    "create_image",
    "PolarisationFrame",
    "congruent_polarisation",
    "convert_circular_to_stokes",
    "convert_circular_to_stokesI",
    "convert_linear_to_stokes",
    "convert_linear_to_stokesI",
    "convert_pol_frame",
    "convert_stokes_to_circular",
    "convert_stokes_to_linear",
    "convert_stokesI_to_polframe",
    "correlate_polarisation",
    "C_M_S",
    "Visibility",
    "create_visibility_from_arrays",
]
