"""Host and device utilities of the PyTorch port: coordinates, observation
geometry and array helpers.

Every ported public name of the JAX package's ``utils`` namespace is
exported here under its JAX name (see ``config.UNPORTED`` for the rest).
"""

from . import arrays, coordinates, geometry
from .arrays import *  # noqa: F401,F403
from .coordinates import *  # noqa: F401,F403
from .geometry import *  # noqa: F401,F403

__all__ = [*arrays.__all__, *coordinates.__all__, *geometry.__all__]
