"""The port's epsilon resolver against the JAX package's.

The JAX package unlocks its double-precision rows with ``jax_enable_x64``;
the port with an f64 Visibility (``f64=True``). Over an epsilon ladder the
two pick the same regime, support, padding, coordinate mode, route and w
stencil, and the same w-plane counts; both raise where the request cannot
be met.
"""

import jax
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.ops.accuracy import (
    gridding_params_for_epsilon as jax_params,
    nw_for_epsilon as jax_nw_for_epsilon,
)
from ska_sdp_func_python_tpu.ops.imaging import (
    _nw_wkernel_for as jax_nw_wkernel_for,
    create_image_from_visibility as jax_create_image,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.accuracy import (
    GriddingAccuracy,
    gridding_params_for_epsilon,
    nw_for_epsilon,
)
from ska_sdp_func_python_torch.ops.imaging import _nw_wkernel_for

from simul import make_visibility

LADDER = [1e-2, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 3e-6, 1e-6, 3e-7, 1e-7, 5e-8,
          1e-8, 1e-9, 1e-10, 1e-11, 5e-12, 1e-12]
FIELDS = ("regime", "support", "padding", "coords", "gridder", "floor_eps",
          "w_interp", "epsilon", "nw_min")


def _resolve(fn, eps, **kw):
    try:
        return fn(eps, **kw)
    except ValueError as e:
        return str(e).split(" (")[0]


@pytest.mark.parametrize("do_wstacking", [True, False], ids=["wstack", "2d"])
@pytest.mark.parametrize("eps", LADDER)
def test_resolver_matches_jax_with_f64(eps, do_wstacking):
    ref = _resolve(jax_params, eps, do_wstacking=do_wstacking)
    out = _resolve(gridding_params_for_epsilon, eps, do_wstacking=do_wstacking, f64=True)
    if isinstance(ref, str):
        assert out == ref
        return
    assert isinstance(out, GriddingAccuracy)
    for f in FIELDS:
        assert getattr(out, f) == getattr(ref, f), f
    assert out.requires_f64 == ref.requires_x64


@pytest.mark.parametrize("eps", LADDER)
def test_resolver_with_f32_raises_where_jax_without_x64_raises(eps):
    try:
        jax.config.update("jax_enable_x64", False)
        ref = _resolve(jax_params, eps)
    finally:
        jax.config.update("jax_enable_x64", True)
    out = _resolve(gridding_params_for_epsilon, eps, f64=False)
    if isinstance(ref, str):
        assert isinstance(out, str) and "below the f32 device floor" in out
        assert "below the f32 device floor" in ref
    else:
        assert (out.regime, out.support, out.padding) == (ref.regime, ref.support, ref.padding)


@pytest.mark.parametrize("w_interp", ["linear", "quadratic"])
def test_nw_for_epsilon_matches_jax(w_interp):
    for nw_est in (1, 2, 8, 17):
        for eps in LADDER[:-1]:
            assert nw_for_epsilon(nw_est, eps, w_interp) == jax_nw_for_epsilon(
                nw_est, eps, w_interp
            ), (nw_est, eps)


def test_infeasible_and_invalid_requests_raise():
    with pytest.raises(ValueError, match="positive"):
        gridding_params_for_epsilon(0.0)
    with pytest.raises(ValueError, match="below the validated"):
        gridding_params_for_epsilon(1e-12, f64=True)
    with pytest.raises(ValueError, match="create_visibility"):
        gridding_params_for_epsilon(1e-7)


@pytest.mark.parametrize("npixel,rmax", [(128, 300.0), (256, 2000.0)])
def test_nw_wkernel_for_matches_jax(npixel, rmax):
    vis = make_visibility(nants=12, ntimes=5, nchan=1, rmax=rmax,
                          times=np.linspace(-np.pi / 4, np.pi / 4, 5))
    model = jax_create_image(vis, npixel=npixel, oversampling=2.0, nchan=1)
    cpu = torch.device("cpu")
    for support in (6, 8, 16):
        assert _nw_wkernel_for(
            interop.to_visibility(vis, device=cpu), interop.to_image(model, device=cpu), support
        ) == jax_nw_wkernel_for(vis, model, support)
