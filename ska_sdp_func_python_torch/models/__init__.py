"""Data models of the PyTorch port: dataclasses of tensors."""

from .components import SkyComponents
from .configuration import (
    Configuration,
    create_named_configuration,
    create_visibility,
    random_array_xyz,
)
from .gaintable import GainTable, create_gaintable_from_visibility
from .image import Image, create_image
from .polarisation import convert_pol_frame
from .visibility import C_M_S, Visibility, create_visibility_from_arrays

__all__ = [
    "SkyComponents",
    "Configuration",
    "create_named_configuration",
    "create_visibility",
    "random_array_xyz",
    "GainTable",
    "create_gaintable_from_visibility",
    "Image",
    "create_image",
    "convert_pol_frame",
    "C_M_S",
    "Visibility",
    "create_visibility_from_arrays",
]
