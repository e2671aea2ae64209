"""PyTorch + CUDA port of ska_sdp_func_python_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package grows beside it, one
slice at a time (see ROADMAP.md). It imports ``torch`` and never ``jax``.
"""

from . import config  # noqa: F401  (pins TF32 off on import)

__version__ = "0.1.0"
