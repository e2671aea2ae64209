"""The imaging API at wide and odd supports against the JAX package's
(x64 on the CPU, its Pallas kernels in interpret mode), on the imaging
API's benign scene: ``invert_visibility`` and ``predict_visibility`` on
a support-24 plan, on the core route at support 24 and on the tiled
route at supports 7 and 17.

Tolerances: dirty images and predicted visibilities to 1e-5 of their
maximum (f32 gridding, as tests/test_torch_gridding.py).
"""

import numpy as np
import pytest

from ska_sdp_func_python_tpu.ops.imaging import (
    invert_visibility as jax_invert_visibility,
    make_visibility_plan as jax_make_visibility_plan,
    predict_visibility as jax_predict_visibility,
)
from ska_sdp_func_python_torch.ops.imaging import (
    invert_visibility,
    make_visibility_plan,
    predict_visibility,
)

from test_torch_imaging_api import _port, _scene


@pytest.fixture(scope="module")
def scene():
    # the imaging API's benign scene: 10 stations, a 1 Jy source at
    # (+12, +9) pixels of 128^2, padded to 256^2 (tile 64)
    return _scene(10, 3, 300.0, 128, 4.0, (12, 9))


def _api_check(scene, **kw):
    """invert_visibility and predict_visibility with ``kw`` against the
    JAX package's, to 1e-5 of the maximum."""
    vis, vis_dft, model = scene
    ref, _ = jax_invert_visibility(vis_dft, model, context="ng", **kw)
    out, _ = invert_visibility(*_port(vis_dft, model), context="ng", **kw)
    ref = np.asarray(ref.pixels)
    assert np.max(np.abs(out.pixels.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    pref = np.asarray(jax_predict_visibility(vis, model, context="ng", **kw).vis)
    pout = predict_visibility(*_port(vis, model), context="ng", **kw).vis.numpy()
    assert np.max(np.abs(pout - pref)) <= 1e-5 * np.max(np.abs(pref))


def test_imaging_on_a_support_24_plan_matches_jax(scene):
    vis, vis_dft, model = scene
    jplan = jax_make_visibility_plan(vis, model, context="ng", support=24)
    pvis, pmodel = _port(vis, model)
    pplan = make_visibility_plan(pvis, pmodel, context="ng", support=24)
    assert pplan.plans[0].gp.support == 24
    ref, _ = jax_invert_visibility(vis_dft, model, plan=jplan)
    out, _ = invert_visibility(*_port(vis_dft, model), plan=pplan)
    ref = np.asarray(ref.pixels)
    assert np.max(np.abs(out.pixels.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    pref = np.asarray(jax_predict_visibility(vis, model, plan=jplan).vis)
    pout = predict_visibility(pvis, pmodel, plan=pplan).vis.numpy()
    assert np.max(np.abs(pout - pref)) <= 1e-5 * np.max(np.abs(pref))


def test_core_route_at_support_24_matches_jax(scene):
    """The planless core route through a one-shot plan (the card's
    route) at support 24."""
    _api_check(scene, support=24, nw=4, gridder="fused")


def test_tiled_route_at_odd_and_wide_supports_matches_jax(scene):
    """The tiled core route (K9 on the card) at an odd support and at one
    past 16."""
    for support in (7, 17):
        _api_check(scene, support=support, nw=4, gridder="tiled")
