"""Parity of the port's polarised self-cal with the JAX package's: small
ports of ``tests/test_composite.py``'s polarised cases (npol 4 with a
diagonal "T", full-Jones "matrix" "T", and the "matrix" "T" + "B"
chain on an MFS image), an npol-2 "TG" chain, circular visibilities
with a Stokes model (which the JAX package's gate composes), and the
zero-PSF planes of an npol-4 msclean. Each configuration runs the port's
fused and composed cycles on the CPU (plain versions) beside the JAX
package's cycle of the same kind.

Tolerances, the JAX tests' own (``tests/test_composite.py``) unless the
measurement allowed tighter: gains 1e-4 (relative to their largest
amplitude, phase-referenced for diagonal terms), residual peaks 1e-3
(absolute for "matrix" chains, relative otherwise), restored peaks
0.05.
"""

import logging

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.models import SkyComponents, create_gaintable_from_visibility
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable as jax_apply_gaintable,
    create_image_from_visibility as jax_create_image_from_visibility,
    dft_skycomponent_visibility as jax_dft,
)
from ska_sdp_func_python_tpu.ops.calibration_chain import (
    create_calibration_controls as jax_controls,
)
from ska_sdp_func_python_tpu.ops.cleaners import msclean as jax_msclean
from ska_sdp_func_python_tpu.pipeline import ical as jax_ical
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.calibration_chain import create_calibration_controls
from ska_sdp_func_python_torch.pipeline import ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
HOGBOM = dict(context="ng", algorithm="hogbom", niter=200, gain=0.2, fractional_threshold=0.01)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _peak(im):
    return float(np.abs(_np(im.pixels)).max())


def _leaky(gt, rng):
    """Off-diagonal leakage of the 2x2 "T" Jones, as the JAX test adds it."""
    g = np.array(gt.gain)
    leak = 0.08 * (rng.normal(size=g[..., 0, 1].shape) + 1j * rng.normal(size=g[..., 0, 1].shape))
    g[..., 0, 1] = leak
    g[..., 1, 0] = np.conj(leak) * 0.7
    return gt.replace(gain=jnp.asarray(g))


def _observation(frame, nants=10, ntimes=3, nchan=1, model_frame=None, npixel=64,
                 flux=(2.0, 0.0, 0.0, 0.0), comp_frame="stokesIQUV", terms="T",
                 leak=False, seed=1805550721):
    """The JAX test observation: a polarised component at (+8, -5) px of
    an ``npixel``^2 image of one channel, seen by ``frame`` visibilities,
    corrupted by ``terms``
    ("T" phases 0.2 with 5% amplitudes when leaky, else 0.3; "G" 60 s
    phases 0.1, amplitudes 0.05; "B" phases 0.1, amplitudes 0.05)."""
    rng = np.random.default_rng(seed)
    vis = make_visibility(nants=nants, ntimes=ntimes, nchan=nchan, rmax=300.0,
                          phasecentre=PC, polarisation_frame=frame)
    mkw = {} if model_frame is None else {"polarisation_frame": model_frame}
    model = jax_create_image_from_visibility(vis, npixel=npixel, oversampling=4.0,
                                             nchan=1, **mkw)
    ra, dec = model.pixel_to_radec(npixel // 2 + 8, npixel // 2 - 5)
    comps = SkyComponents.from_lists(
        [[float(ra), float(dec)]], np.tile(np.asarray([[flux]]), (1, nchan, 1)),
        vis.frequency, polarisation_frame=comp_frame,
    )
    vis = jax_dft(vis, comps)
    corrupted = vis
    for t in terms:
        if t == "T":
            gt = create_gaintable_from_visibility(vis, "T")
            gt = (_leaky(_simulate_gaintable(gt, rng, 0.2, 0.05), rng) if leak
                  else _simulate_gaintable(gt, rng, 0.3))
        elif t == "G":
            gt = _simulate_gaintable(create_gaintable_from_visibility(vis, "G", timeslice=60.0),
                                     rng, 0.1, 0.05)
        else:
            gt = _simulate_gaintable(create_gaintable_from_visibility(vis, "B", timeslice=1e5),
                                     rng, 0.1, 0.05)
        corrupted = jax_apply_gaintable(corrupted, gt)
    return dict(
        vis=corrupted, model=model, comps=comps,
        pvis=interop.to_visibility(corrupted, device=CPU),
        pmodel=interop.to_image(model, device=CPU),
        pcomps=interop.to_skycomponents(comps, device=CPU),
    )


def _matrix_controls(make):
    controls = make()
    controls["T"] = dict(controls["T"], shape="matrix", phase_only=False)
    controls["B"] = dict(controls["B"], first_selfcal=0)
    return controls


def _runs(o, jax_kw, kw):
    """The JAX package's composed cycle (its oracle for the fused one, on
    the core path) and the port's fused and composed cycles."""
    ref = jax_ical(o["vis"], o["model"], components=o["comps"], fused=False, **jax_kw)
    fused = ical(o["pvis"], o["pmodel"], components=o["pcomps"], **kw)
    composed = ical(o["pvis"], o["pmodel"], components=o["pcomps"], fused=False, **kw)
    return ref, fused, composed


def _referenced(g):
    """Diagonal gains with station 0's phase taken out of each receptor."""
    g = _np(g)
    d = np.stack([g[..., 0, 0], g[..., 1, 1]], axis=-1) if g.shape[-1] == 2 else g[..., 0, 0]
    return d * np.exp(-1j * np.angle(d[:, :1]))


def _agree(a, b, terms, gains, resid, relative_resid=True, referenced=True, restored=True):
    for t in terms:
        ga, gb = _np(a[3][t].gain), _np(b[3][t].gain)
        assert ga.shape == gb.shape
        if referenced:
            ga, gb = _referenced(ga), _referenced(gb)
        rel = np.max(np.abs(ga - gb)) / max(np.max(np.abs(ga)), 1.0)
        assert rel < gains, (t, rel)
    r0, r1 = _peak(a[1]), _peak(b[1])
    bound = resid * max(r0, 1e-6) if relative_resid else resid
    assert abs(r0 - r1) < bound, (r0, r1)
    if restored:
        s0, s1 = _peak(a[2]), _peak(b[2])
        assert abs(s0 - s1) < 0.05, (s0, s1)


def test_ical_npol4_diagonal_matches_jax():
    """test_composite.py:507: linear visibilities and model, a diagonal
    "T", the sky seeded with its component; both receptors recover the
    source. Measured 1.9e-8 against the JAX composed gains (2.5e-16
    against its fused ones)."""
    o = _observation("linear")
    kw = dict(nmajor=2, calibration_context="T", **HOGBOM)
    ref, fused, composed = _runs(o, kw, kw)
    assert fused[3]["T"].gain.shape[-2:] == (2, 2)
    _agree(ref, fused, "T", gains=1e-6, resid=1e-6, relative_resid=False)
    _agree(fused, composed, "T", gains=1e-4, resid=1e-3, relative_resid=False)
    assert _peak(fused[1]) < 0.2
    # XX and YY each carry I + Q = 2.0 (restored adds the component)
    assert abs(_peak(fused[2]) - 2.0) < 0.2


def test_ical_full_jones_matches_jax():
    """test_composite.py:760: linear visibilities with 8% leakage, a
    "matrix" "T" (amplitude and phase): the Mueller leg of the fused
    cycle against the composed cycle and the JAX package's."""
    o = _observation("linear", model_frame="linear", flux=(2.0, 0.3, 0.15, 0.0), leak=True)
    kw = dict(nmajor=3, calibration_context="T", **HOGBOM)
    ref, fused, composed = _runs(
        o, dict(kw, controls=_matrix_controls(jax_controls)),
        dict(kw, controls=_matrix_controls(create_calibration_controls)),
    )
    for a, b in ((ref, fused), (ref, composed)):
        _agree(a, b, "T", gains=1e-4, resid=1e-3, relative_resid=False,
               referenced=False, restored=False)


def test_ical_full_jones_and_bandpass_on_mfs_matches_jax():
    """test_composite.py:825: the "matrix" "T" (Fc 1) chained with a
    per-channel "B" (Fc nchan) on two channels imaged MFS: the Mueller
    chain broadcasts the channel axis before it composes, and the MFS
    plan carries both channels in one row. One cycle, in which both terms
    solve and the chain composes: below the JAX test's 128^2 the amplitude
    self-cal of both packages runs away in a second cycle (the doubled
    gains of ROADMAP Queue 3)."""
    o = _observation("linear", nants=8, ntimes=2, nchan=2, model_frame="linear",
                     flux=(2.0, 0.3, 0.15, 0.0), terms="TB", leak=True)
    kw = dict(HOGBOM, nmajor=1, niter=100, calibration_context="TB")
    ref, fused, composed = _runs(
        o, dict(kw, controls=_matrix_controls(jax_controls)),
        dict(kw, controls=_matrix_controls(create_calibration_controls)),
    )
    assert fused[3]["B"].gain.shape[2] == 2
    for a, b in ((ref, fused), (ref, composed)):
        _agree(a, b, "TB", gains=1e-4, resid=1e-3, relative_resid=False,
               referenced=False, restored=False)


def test_ical_npol2_tg_matches_jax():
    """linearnp visibilities and model with a "TG" chain: each
    polarisation column reads its own receptor of the diagonal Jones.
    "G" solves per integration here: with empty "G" bins the JAX
    package's fused and composed cycles disagree (ROADMAP Queue 3), and
    the port follows each of them."""
    o = _observation("linearnp", flux=(2.0, 2.0), comp_frame="linearnp", terms="TG")
    kw = dict(nmajor=2, calibration_context="TG", **HOGBOM)
    jc, pc = jax_controls(), create_calibration_controls()
    for c in (jc, pc):
        c["G"] = dict(c["G"], timeslice="auto")
    ref, fused, composed = _runs(o, dict(kw, controls=jc), dict(kw, controls=pc))
    assert fused[3]["G"].gain.shape[-2:] == (2, 2) and fused[3]["G"].ntimes == 3
    for out in (fused, composed):
        _agree(ref, out, "TG", gains=1e-4, resid=1e-3)


def test_ical_circular_with_stokes_model_composes_as_jax(caplog):
    """Circular visibilities and a stokesIQUV model: the frames differ,
    so a fused request composes (the JAX package's gate); the composed
    cycle converts the model's predict to circular and the residual back
    to Stokes."""
    o = _observation("circular", model_frame="stokesIQUV", flux=(2.0, 0.2, 0.1, 0.05))
    kw = dict(nmajor=2, calibration_context="T", **HOGBOM)
    ref = jax_ical(o["vis"], o["model"], components=o["comps"], fused=False, **kw)
    with caplog.at_level(logging.WARNING, logger="ska-sdp-func-python-torch"):
        out = ical(o["pvis"], o["pmodel"], components=o["pcomps"], fused=True, **kw)
    assert any("not fusable" in r.getMessage() for r in caplog.records)
    assert out[1].polarisation_frame == "stokesIQUV"
    _agree(ref, out, "T", gains=1e-4, resid=1e-3)


def test_msclean_zero_psf_planes_clean_nothing():
    """At npol 4 only the first polarisation has a PSF. The JAX
    package's msclean turns an all-zero PSF plane into NaN components
    (a fault of the reference, ROADMAP Queue 3), so its fused msclean
    cycle cannot serve as the oracle here; the port's fused lanes clean
    nothing there, as its composed cycle (deconvolve_cube) does."""
    comps, _ = jax_msclean(jnp.ones((16, 16)), jnp.zeros((8, 8)), niter=5, scales=(0,))
    assert bool(jnp.isnan(comps).all())
    o = _observation("linear")
    kw = dict(nmajor=1, calibration_context="T", context="ng", algorithm="msclean",
              niter=50, gain=0.2, fractional_threshold=0.01, scales=[0, 3])
    fused = ical(o["pvis"], o["pmodel"], components=o["pcomps"], **kw)
    composed = ical(o["pvis"], o["pmodel"], components=o["pcomps"], fused=False, **kw)
    for out in (fused, composed):
        assert bool(torch.isfinite(out[0].pixels).all())
        assert float(out[0].pixels[0, 1:].abs().max()) == 0.0
    _agree(fused, composed, "T", gains=1e-4, resid=1e-3, relative_resid=False)


def test_ical_circular_tg_matches_jax():
    """Circular visibilities and model (npol 4, fusable) with a diagonal
    "TG" chain ("G" per integration): RR, RL, LR and LL each read their
    receptor pair."""
    o = _observation("circular", model_frame="circular", flux=(2.0, 0.1, 0.05, 0.2),
                     terms="TG")
    kw = dict(nmajor=2, calibration_context="TG", **HOGBOM)
    jc, pc = jax_controls(), create_calibration_controls()
    for c in (jc, pc):
        c["G"] = dict(c["G"], timeslice="auto")
    ref, fused, composed = _runs(o, dict(kw, controls=jc), dict(kw, controls=pc))
    for out in (fused, composed):
        _agree(ref, out, "TG", gains=1e-4, resid=1e-3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_checkpoint_resume_with_2x2_tables(tmp_path, fused):
    """A checkpoint of an npol-4 run holds 2x2 tables; resuming at cycle 1
    of 2 equals the uninterrupted run."""
    from ska_sdp_func_python_torch.pipeline import SelfCalState

    o = _observation("linear")
    kw = dict(calibration_context="T", components=o["pcomps"], fused=fused, **HOGBOM)
    full = ical(o["pvis"], o["pmodel"], nmajor=2, **kw)
    path = str(tmp_path / "selfcal.pkl")
    ical(o["pvis"], o["pmodel"], nmajor=1, checkpoint_path=path, **kw)
    state = SelfCalState.load(path, device="cpu")
    assert state.cycle == 1 and state.gaintables["T"].gain.shape[-2:] == (2, 2)
    res = ical(o["pvis"], o["pmodel"], nmajor=2, state=state, **kw)
    np.testing.assert_allclose(_np(res[0].pixels), _np(full[0].pixels), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(res[3]["T"].gain), _np(full[3]["T"].gain), rtol=0, atol=1e-6)
