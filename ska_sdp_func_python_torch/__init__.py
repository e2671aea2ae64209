"""PyTorch + CUDA port of ska_sdp_func_python_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package grows beside it, one
slice at a time (see ROADMAP.md). It imports ``torch`` and never ``jax``.

Layout:
    models/    data models (Visibility, GainTable, Image, ...)
    ops/       operations and the kernels' wrappers (DFT, gridding,
               solvers, CLEAN)
    io/        the native visibility store and gain-solution files
    csrc/      the hand-written CUDA kernels (built by ``kernels``)
    pipeline   the self-calibration and continuum-imaging cycles
    streaming  the out-of-core self-calibration cycle over a store
"""

from . import config  # noqa: F401  (pins TF32 off on import)

__version__ = "0.1.0"

from . import io, models, ops  # noqa: E402,F401
from . import pipeline, streaming  # noqa: E402,F401
