"""The rest of ``utils`` in the port: the array helpers and the quality
summaries against the JAX package on the same seeded numpy inputs (x64 on
the CPU), the profiling helpers, and the roofline models against counts
made by hand (the peaks are the card's, with no JAX counterpart).

Tolerances: f64 to 1e-12 of the maximum; summaries identical to 1e-12.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu import utils as jutils
from ska_sdp_func_python_tpu.ops import create_image_from_visibility as jax_create_image
from ska_sdp_func_python_tpu.models import create_gaintable_from_visibility as jax_create_gaintable
from ska_sdp_func_python_torch import interop, utils
from ska_sdp_func_python_torch.utils import roofline

from simul import make_visibility

CPU = torch.device("cpu")
TOL = 1e-12


def _close(out, ref, tol=TOL):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("n,chunk", [(17, 4), (16, 4), (10, 1), (7, 10)])
def test_average_chunks_matches_jax(n, chunk):
    rng = np.random.default_rng(n)
    arr = rng.normal(size=n) + 1j * rng.normal(size=n)
    wts = rng.uniform(0, 1, n)
    wts[:3] = 0.0  # a chunk of zero weight
    out, w = utils.average_chunks(torch.as_tensor(arr), torch.as_tensor(wts), chunk)
    ref, rw = jutils.average_chunks(jnp.asarray(arr), jnp.asarray(wts), chunk)
    _close(out, ref)
    _close(w, rw)


@pytest.mark.parametrize("chunks", [(2, 3), (1, 4), (5, 1)])
def test_average_chunks2_matches_jax(chunks):
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(9, 11))
    wts = rng.uniform(0, 1, (9, 11))
    out, w = utils.average_chunks2(torch.as_tensor(arr), torch.as_tensor(wts), chunks)
    ref, rw = jutils.average_chunks2(jnp.asarray(arr), jnp.asarray(wts), chunks)
    _close(out, ref)
    _close(w, rw)


@pytest.mark.parametrize("name", ["insert_function_sinc", "insert_function_L",
                                  "insert_function_pswf"])
def test_insert_functions_match_jax(name):
    x = np.linspace(-6.0, 6.0, 97)
    _close(getattr(utils, name)(torch.as_tensor(x)), getattr(jutils, name)(jnp.asarray(x)))


@pytest.mark.parametrize("x,y", [(20.3, 30.8), (1.4, 60.2), (60.5, 62.7), (33.0, 2.5)])
@pytest.mark.parametrize("fn", ["insert_function_L", "insert_function_pswf"])
def test_insert_array_matches_jax(x, y, fn):
    """Inside the image, and windows reaching past each edge (the JAX edge
    rule: the window moved into the image, or onto the far edge where it
    starts before the near one)."""
    rng = np.random.default_rng(3)
    im = rng.normal(size=(2, 1, 64, 64))
    flux = rng.uniform(0.5, 2.0, (2, 1))
    out = utils.insert_array(torch.as_tensor(im), x, y, torch.as_tensor(flux), 1.0, 5,
                             getattr(utils, fn))
    ref = jutils.insert_array(jnp.asarray(im), x, y, jnp.asarray(flux), 1.0, 5,
                              getattr(jutils, fn))
    _close(out, ref)


def test_qa_summaries_match_jax():
    rng = np.random.default_rng(4)
    vis = make_visibility(nants=5, ntimes=2, nchan=2)
    vis = vis.replace(vis=jnp.asarray(rng.normal(size=vis.vis.shape) + 1j * rng.normal(size=vis.vis.shape)),
                      flags=vis.flags.at[0, 0].set(1))
    im = jax_create_image(vis, npixel=32, oversampling=4.0)
    im = im.with_pixels(jnp.asarray(rng.normal(size=im.pixels.shape)))
    gt = jax_create_gaintable(vis, jones_type="G")
    gt = gt.replace(gain=jnp.asarray(np.exp(1j * rng.normal(size=gt.gain.shape))),
                    residual=jnp.asarray(rng.uniform(size=gt.residual.shape)))
    for fn, obj, conv in (("qa_image", im, interop.to_image),
                          ("qa_visibility", vis, interop.to_visibility),
                          ("qa_gain_table", gt, interop.to_gaintable)):
        out = getattr(utils, fn)(conv(obj, device=CPU), context="c")
        ref = getattr(jutils, fn)(obj, context="c")
        assert out.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], float):
                assert abs(out[k] - ref[k]) <= TOL * max(1.0, abs(ref[k])), k
            else:
                assert out[k] == ref[k], k


def test_timer_metrics_and_trace(tmp_path):
    """timer records into metrics (and a rate with items); on the CPU its
    sync does nothing; profile_trace writes a Chrome trace."""
    utils.reset_metrics()
    with utils.timer("stage", items=1000):
        torch.ones(100).sum()
    with utils.timer("stage", sync=False):
        pass
    m = utils.metrics()
    assert m["stage"]["count"] == 2 and m["stage.rate"]["count"] == 1
    assert m["stage"]["total"] == pytest.approx(m["stage"]["mean"] * 2)
    utils.reset_metrics()
    assert utils.metrics() == {}
    with utils.profile_trace(str(tmp_path / "prof")):
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_roofline_counts_match_hand_counts():
    """Each model against a count made by hand from its docstring's rule,
    at support 8 (span 8, taps 8 wide) and 7 (span 8) and 24 (span 24,
    taps 32 wide); the fractions against the card's peaks."""
    n, npix, npad, nw = 1000, 64, 128, 4
    fft = 5 * npad**2 * math.log2(npad**2)
    for support, span, width in ((8, 8, 8), (7, 8, 8), (24, 24, 32)):
        m = roofline.invert_model(n, npix, npad, support=support, nw=nw)
        grid_ops = n * (span * span * 9 + 5)
        tail = nw * (fft + npad**2 * 8)
        assert m["useful_flops"] == grid_ops + tail
        assert m["executed_flops"] == n * (width * width * 9 + 5) + tail
        assert m["bytes"] == n * (20 + 8 * span) + nw * npad**2 * 8 * 4 + npix**2 * 4
        p = roofline.predict_model(n, npix, npad, support=support, nw=nw)
        assert p["useful_flops"] == n * (2 * (span * span * 4 + span * 4) + 6) + nw * (fft + npad**2 * 6)
        assert p["bytes"] == (npix**2 * 4 + nw * npad**2 * 24 + n * (24 + 8 * span) + n * 20)
    h = roofline.hogbom_model(10, patch=32)
    assert h == {"useful_flops": 10 * 4 * 1024, "executed_flops": 10 * 4 * 1024,
                 "bytes": 3 * 1024 * 4}
    s = roofline.solver_model(5, 3, 10, 2)
    assert s["useful_flops"] == 5 * 3 * 100 * 2 * 16 and s["bytes"] == 3 * 100 * 2 * 16
    c = roofline.fused_cycle_model(n, npix, npad, 10, 3, nw=nw, clean_niter=10, solver_niter=5)
    parts = (roofline.invert_model(n, npix, npad, nw=nw), roofline.predict_model(n, npix, npad, nw=nw),
             roofline.solver_model(5, 3, 10), roofline.hogbom_model(10, patch=npix))
    assert c["useful_flops"] == sum(q["useful_flops"] for q in parts) + n * 16
    assert c["bytes"] == sum(q["bytes"] for q in parts) + 2 * n * 20 + n * 32
    r = roofline.roofline({"useful_flops": 67e9, "executed_flops": 134e9, "bytes": 3.35e9}, 1e-3)
    assert r == {"useful_gflop": 67.0, "moved_gb": 3.35, "mxu_frac": 2.0,
                 "mxu_frac_useful": 1.0, "hbm_frac": 1.0}
    assert roofline.roofline({"useful_flops": 34e9, "executed_flops": 34e9, "bytes": 0.0},
                             1e-3, dtype="f64")["mxu_frac"] == 1.0
    assert roofline.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert not [k for k in vars(roofline) if k.startswith("V5E")]
