"""Host and device utilities of the PyTorch port: coordinates, observation
geometry, array helpers, quality summaries and profiling.

Every public name of the JAX package's ``utils`` namespace is exported
here under its JAX name; ``utils.roofline`` is imported by name, as in the
JAX package.
"""

from . import arrays, coordinates, geometry, profiling, qa
from .arrays import *  # noqa: F401,F403
from .coordinates import *  # noqa: F401,F403
from .geometry import *  # noqa: F401,F403
from .profiling import metrics, profile_trace, reset_metrics, timer  # noqa: F401
from .qa import qa_gain_table, qa_image, qa_visibility  # noqa: F401

__all__ = [*arrays.__all__, *coordinates.__all__, *geometry.__all__,
           *qa.__all__, *profiling.__all__]
