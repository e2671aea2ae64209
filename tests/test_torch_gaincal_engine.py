"""The parset-driven gain calibration (``gaincal``, ``dp3_gaincal``) of
the port against the JAX package's, on the same seeded observation (x64
on the CPU).

Tolerances: f64 to 1e-10 of the maximum; the corrected visibilities
within 1e-5 of the uncorrupted ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_python_tpu import ops as jops
from ska_sdp_func_python_tpu.models import (
    SkyComponents as JaxComponents,
    create_gaintable_from_visibility as jax_create_gaintable,
)
from ska_sdp_func_python_torch import interop, ops

from simul import make_visibility
from test_torch_skymodel import CPU, _close


@pytest.mark.parametrize("context", ["T", "TG"])
def test_gaincal_matches_jax(context):
    rng = np.random.default_rng(12)
    vis = make_visibility(nants=8, ntimes=2, nchan=1)
    comps = JaxComponents.from_lists([[0.0, np.deg2rad(-35.0)]], [[[1.0]]], vis.frequency)
    vis = jops.dft_skycomponent_visibility(vis, comps)
    gt = jax_create_gaintable(vis, jones_type="T")
    gt = gt.replace(gain=jnp.asarray(np.exp(1j * rng.normal(0, 0.2, gt.gain.shape[:3])))[..., None, None])
    corrupted = jops.apply_gaintable(vis, gt)
    pc, pv = interop.to_visibility(corrupted, device=CPU), interop.to_visibility(vis, device=CPU)
    ref = jops.gaincal(corrupted, vis, calibration_context=context)
    out = ops.gaincal(pc, pv, calibration_context=context)
    _close(out.vis, ref.vis)
    assert np.max(np.abs(out.vis.numpy() - np.asarray(vis.vis))) < 1e-5
    ref = jops.dp3_gaincal(corrupted, context, modelvis=vis)
    out = ops.dp3_gaincal(pc, context, modelvis=pv)
    _close(out.vis, ref.vis)
