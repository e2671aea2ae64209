"""The sky model's predict and invert (``skymodel_predict_calibrate``,
``skymodel_calibrate_invert``) of the port against the JAX package's,
with and without calibration and a primary beam, on
tests/test_torch_skymodel.py's observation (x64 on the CPU).

Tolerances: f64 to 1e-10 of the maximum (visibilities, images).
"""

import pytest

from ska_sdp_func_python_tpu import ops as jops
from ska_sdp_func_python_torch import interop, ops

from test_torch_skymodel import CPU, _close, _pb_pair, obs  # noqa: F401


@pytest.mark.parametrize("docal,pb", [(False, False), (True, True)],
                         ids=["plain", "docal-beam"])
def test_skymodel_predict_calibrate_matches_jax(obs, docal, pb):
    vis, sm, pvis, psm = obs
    jpb, ppb = _pb_pair() if pb else (None, None)
    kw = dict(context="ng", docal=docal, nw=4)
    ref = jops.skymodel_predict_calibrate(vis, sm, get_pb=jpb, **kw)
    out = ops.skymodel_predict_calibrate(pvis, psm, get_pb=ppb, **kw)
    _close(out.vis, ref.vis)
    assert float(out.vis.abs().max()) > 0.1


@pytest.mark.parametrize("pb,flat_sky", [(False, False), (True, True)])
def test_skymodel_calibrate_invert_matches_jax(obs, pb, flat_sky):
    vis, sm, pvis, psm = obs
    jpred = jops.skymodel_predict_calibrate(vis, sm, context="ng", docal=True, nw=4)
    ppred = interop.to_visibility(jpred, device=CPU)
    jpb, ppb = _pb_pair() if pb else (None, None)
    kw = dict(context="ng", docal=True, flat_sky=flat_sky, nw=4)
    ref, rflat = jops.skymodel_calibrate_invert(jpred, sm, get_pb=jpb, **kw)
    out, flat = ops.skymodel_calibrate_invert(ppred, psm, get_pb=ppb, **kw)
    _close(out.pixels, ref.pixels)
    if pb:
        _close(flat.pixels, rflat.pixels)
    else:
        _close(flat, rflat)
    with pytest.raises(ValueError):
        ops.skymodel_calibrate_invert(ppred, psm.replace(image=None))
