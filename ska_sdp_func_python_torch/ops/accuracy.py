"""Epsilon-driven gridder parameter selection.

Counterpart of ``ska_sdp_func_python_tpu/ops/accuracy.py``, with its own
copy of the regime table. ``gridding_params_for_epsilon(eps)`` picks the
cheapest (support, padding, coordinate mode, gridder path) whose non-w
error floor fits half the budget (the whole budget for 2-d imaging), and
``nw_for_epsilon`` scales the w-plane count of the polynomial
w-interpolation laws.

The JAX package unlocks its double-precision rows with ``jax_enable_x64``;
the port unlocks them with an f64 Visibility
(``create_visibility(..., dtype=torch.float64)``): the tiled path then
computes in f64 on the card, from host-f64 pixel coordinates, with
complex128 values, the f64 ES kernel and f64 FFTs. The floors of the
table were measured for the JAX package (its README and
``bench_accuracy.py``); the port's delivered errors on the card are its
own measurements (``chip_smoke.py``).
"""

from __future__ import annotations

import math
import typing

__all__ = [
    "GriddingAccuracy",
    "gridding_params_for_epsilon",
    "nw_for_epsilon",
]

# w-interpolation error at nw == the heuristic plane count (4 wmax fov^2):
# linear ~E0_W (nw_est / nw)^2, quadratic ~E0_W3 (nw_est / nw)^3
E0_W = 4.0e-5
E0_W3 = 4.0e-6


class GriddingAccuracy(typing.NamedTuple):
    """Resolved gridding configuration for a requested epsilon."""

    regime: str
    support: int
    padding: float
    # "device": pixel coordinates from the Visibility's device uvw;
    # "host64": from host f64 uvw (split (hi, lo) f32 pairs for an f32
    # Visibility, f64 for an f64 one)
    coords: str
    # None: the default path (plans on the card); "tiled": the tiled core
    # path in the Visibility's precision (the deep rows)
    gridder: str | None
    # non-w error floor of the regime; the w budget is handled by nw
    floor_eps: float
    requires_f64: bool = False
    # the requested epsilon this resolution serves (set by the resolver)
    epsilon: float = 0.0
    # "linear", "quadratic" or "eskernel" w-gridding
    w_interp: str = "linear"

    @property
    def nw_min(self) -> int:
        """Minimum w-plane count for a heuristic estimate of 1."""
        return nw_for_epsilon(1, self.epsilon) if self.epsilon else 1


# Every w-stacked row uses ES-kernel w-gridding: each visibility feeds
# `support` neighbouring planes with ES weights and the image is divided
# by the w-kernel's transform, which bounds the w error uniformly over the
# field. The f32 floors are the JAX package's edge-source measurements.
_REGIMES = (
    GriddingAccuracy(
        "fast-f32", 6, 1.25, "device", None, 3.0e-4,
        w_interp="eskernel",
    ),
    GriddingAccuracy(
        "compensated-f32", 8, 1.25, "host64", None, 1.2e-5,
        w_interp="eskernel",
    ),
    GriddingAccuracy(
        "precise-f32", 8, 2.0, "host64", None, 5.0e-6,
        w_interp="eskernel",
    ),
    GriddingAccuracy(
        "deep-f64", 8, 2.0, "host64", "tiled", 1.5e-7, True,
        w_interp="eskernel",
    ),
    GriddingAccuracy(
        "deep-f64-s12", 12, 2.0, "host64", "tiled", 5e-11,
        True, w_interp="eskernel",
    ),
    GriddingAccuracy(
        "deep-f64-s16", 16, 2.0, "host64", "tiled", 2e-12,
        True, w_interp="eskernel",
    ),
)
_N_F32 = 3  # the first three rows run on an f32 Visibility


def nw_for_epsilon(
    nw_est: int, epsilon: float, w_interp: str = "linear"
) -> int:
    """W-plane count so the polynomial w-interpolation error fits half the
    ``epsilon`` budget: ``nw_est * (E0 / (epsilon / 2))^(1 / order)``."""
    if w_interp == "quadratic":
        if epsilon >= 2 * E0_W3:
            return max(int(nw_est), 3)
        return max(
            int(math.ceil(nw_est * (E0_W3 / (0.5 * epsilon)) ** (1 / 3))),
            int(nw_est),
            3,
        )
    if epsilon >= 2 * E0_W:
        return max(int(nw_est), 1)
    return max(
        int(math.ceil(nw_est * math.sqrt(E0_W / (0.5 * epsilon)))),
        int(nw_est),
        2,
    )


def gridding_params_for_epsilon(
    epsilon: float, *, do_wstacking: bool = True, f64: bool = False
) -> GriddingAccuracy:
    """Map a requested gridding tolerance to a regime.

    :param epsilon: maximum acceptable error against an exact DFT
    :param f64: the Visibility is f64, which unlocks the deep rows
    :raises ValueError: below the f32 floor with an f32 Visibility, or
        below the validated f64 envelope
    """
    if epsilon <= 0:
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    budget = epsilon if not do_wstacking else 0.5 * epsilon
    n_avail = len(_REGIMES) if f64 else _N_F32
    for regime in _REGIMES[:n_avail]:
        if regime.floor_eps <= budget:
            return regime._replace(epsilon=epsilon)
    if not f64:
        raise ValueError(
            f"epsilon={epsilon:g} is below the f32 device floor "
            f"(~{_REGIMES[_N_F32 - 1].floor_eps:g} field-wide: f32 FFT "
            "error + f32 tap storage). Use an f64 Visibility "
            "(create_visibility(..., dtype=torch.float64)) to unlock the "
            "deep double-precision regimes (validated to ~1e-11)."
        )
    raise ValueError(
        f"epsilon={epsilon:g} is below the validated envelope "
        f"(~{_REGIMES[-1].floor_eps:g} at support 16 in f64). Use "
        "do_wstacking=False for 2d fields."
    )
