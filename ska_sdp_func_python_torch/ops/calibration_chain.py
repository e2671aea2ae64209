"""Chain-calibration controls.

Counterpart of ``create_calibration_controls`` in
``ska_sdp_func_python_tpu/ops/calibration_chain.py``.
"""

from __future__ import annotations

__all__ = ["create_calibration_controls"]


def create_calibration_controls() -> dict:
    """Default controls: T = atmospheric phase, G = electronic gain,
    B = bandpass."""
    return {
        "T": {
            "shape": "scalar",
            "timeslice": "auto",
            "phase_only": True,
            "first_selfcal": 0,
        },
        "G": {
            "shape": "vector",
            "timeslice": 60.0,
            "phase_only": False,
            "first_selfcal": 0,
        },
        "B": {
            "shape": "vector",
            "timeslice": 1e5,
            "phase_only": False,
            "first_selfcal": 0,
        },
    }
