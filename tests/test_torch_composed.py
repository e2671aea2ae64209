"""Parity of the port's composed self-cal and continuum cycles with the
JAX package's, and of its fused "TG" chain and sky components with its
own composed cycle, on the JAX package's composite-test observation (10
stations, 3 integrations, 128^2, a 2.0 Jy source corrupted by "T" phases
per integration and "G" gains in 60 s bins); checkpoints and the fuse
decision.

Tolerances, the JAX package's own fused-vs-composed bounds
(tests/test_composite.py): phase-referenced gains 1e-4, peak residual
1e-3 relative, restored peak 0.05; a resumed run equals the uninterrupted
one to 1e-6.
"""

import logging

import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.models import (
    SkyComponents,
    create_gaintable_from_visibility,
)
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable as jax_apply_gaintable,
    create_image_from_visibility as jax_create_image_from_visibility,
    dft_skycomponent_visibility as jax_dft,
)
from ska_sdp_func_python_tpu.pipeline import (
    continuum_imaging as jax_continuum_imaging,
    ical as jax_ical,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.calibration_chain import create_calibration_controls
from ska_sdp_func_python_torch.pipeline import SelfCalState, continuum_imaging, ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
TG = dict(
    calibration_context="TG", context="ng", algorithm="hogbom", niter=200,
    gain=0.2, fractional_threshold=0.01,
)


@pytest.fixture(scope="module")
def obs():
    """The 2.0 Jy source (and a 0.8 Jy one the component model leaves
    out), the "TG"-corrupted visibilities, and both on the port's side."""
    rng = np.random.default_rng(1805550721)
    vis = make_visibility(nants=10, ntimes=3, nchan=1, rmax=300.0, phasecentre=PC)
    model = jax_create_image_from_visibility(vis, npixel=128, oversampling=4.0, nchan=1)
    dirs = [model.pixel_to_radec(64 + 8, 64 - 5), model.pixel_to_radec(64 - 20, 64 + 12)]
    sky = SkyComponents.from_lists(
        [[float(r), float(d)] for r, d in dirs], [[[2.0]], [[0.8]]], vis.frequency
    )
    comps = SkyComponents.from_lists(
        [[float(dirs[0][0]), float(dirs[0][1])]], [[[2.0]]], vis.frequency
    )
    vis = jax_dft(vis, sky)
    gt_t = _simulate_gaintable(create_gaintable_from_visibility(vis, "T"), rng, 0.25)
    gt_g = _simulate_gaintable(
        create_gaintable_from_visibility(vis, "G", timeslice=60.0), rng, 0.1, 0.05
    )
    corrupted = jax_apply_gaintable(jax_apply_gaintable(vis, gt_t), gt_g)
    return dict(
        vis=vis, corrupted=corrupted, model=model, comps=comps,
        pvis=interop.to_visibility(vis, device=CPU),
        pcorrupted=interop.to_visibility(corrupted, device=CPU),
        pmodel=interop.to_image(model, device=CPU),
        pcomps=interop.to_skycomponents(comps, device=CPU),
    )


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _referenced(g):
    g = _np(g)[..., 0, 0]
    return g * np.exp(-1j * np.angle(g[:, :1]))


def _assert_bounds(ref, out, terms=""):
    """Phase-referenced gains 1e-4, peak residual 1e-3 relative, restored
    peak 0.05."""
    for t in terms:
        assert np.max(np.abs(_referenced(ref[3][t].gain) - _referenced(out[3][t].gain))) < 1e-4
    r0, r1 = (float(np.abs(_np(x[1].pixels)).max()) for x in (ref, out))
    assert abs(r0 - r1) < 1e-3 * max(r0, 1e-6), (r0, r1)
    s0, s1 = (float(_np(x[2].pixels).max()) for x in (ref, out))
    assert abs(s0 - s1) < 0.05, (s0, s1)


@pytest.fixture(scope="module")
def port_tg(obs):
    """The port's "TG" ical, 4 cycles, composed on its plan and fused."""
    return {
        fused: ical(obs["pcorrupted"], obs["pmodel"], nmajor=4, fused=fused, **TG)
        for fused in (False, True)
    }


CONTINUUM = dict(nmajor=3, context="ng", algorithm="hogbom", niter=200, gain=0.2,
                 fractional_threshold=0.01)


@pytest.fixture(scope="module")
def jax_continuum(obs):
    """The JAX package's composed continuum cycle with the component."""
    return jax_continuum_imaging(
        obs["vis"], obs["model"], components=obs["comps"], **CONTINUUM
    )


def test_composed_ical_tg_matches_jax(obs):
    """Both without a plan: the JAX package's composed cycle on the CPU,
    and the port's on the core path."""
    ref = jax_ical(obs["corrupted"], obs["model"], nmajor=4, **TG)
    out = ical(obs["pcorrupted"], obs["pmodel"], nmajor=4, use_plan=False, **TG)
    assert set(out[3]) == {"T", "G"}
    assert out[3]["G"].ntimes == ref[3]["G"].gain.shape[0]
    _assert_bounds(ref, out, "TG")
    assert float(out[1].pixels.abs().max()) < 0.2


def test_fused_ical_tg_matches_composed(port_tg):
    out = port_tg[True]
    _assert_bounds(port_tg[False], out, "TG")
    assert abs(float(out[2].pixels.max()) - 2.0) < 0.2


@pytest.mark.parametrize(
    "path", [{"use_plan": False}, {"fused": False}, {}],
    ids=["core path", "composed on the plan", "fused"],
)
def test_continuum_with_components_matches_jax(obs, jax_continuum, path):
    """The 2.0 Jy source as a component, restored through
    restore_skycomponent; CLEAN finds the 0.8 Jy one. Every path of the
    port against the JAX package's composed cycle."""
    out = continuum_imaging(
        obs["pvis"], obs["pmodel"], components=obs["pcomps"], **path, **CONTINUUM
    )
    _assert_bounds(jax_continuum, out)
    # the component is not in the CLEAN model, the restored image holds it
    assert float(out[0].pixels[0, 0, 59, 72].abs()) < 0.1
    assert abs(float(out[2].pixels[0, 0, 59, 72]) - 2.0) < 0.2


def test_ical_with_components_fused_matches_composed(obs):
    """The component model in the fused workspace (comp_s) against the
    composed cycle's predict."""
    kw = dict(nmajor=3, components=obs["pcomps"], **TG)
    ref = ical(obs["pcorrupted"], obs["pmodel"], fused=False, **kw)
    out = ical(obs["pcorrupted"], obs["pmodel"], **kw)
    _assert_bounds(ref, out, "TG")


@pytest.mark.parametrize("fused", [True, False])
def test_checkpoint_resume_matches_uninterrupted(obs, port_tg, tmp_path, fused):
    ckpt = str(tmp_path / "selfcal.pkl")
    full = port_tg[fused]
    ical(obs["pcorrupted"], obs["pmodel"], nmajor=2, fused=fused,
         checkpoint_path=ckpt, **TG)
    state = SelfCalState.load(ckpt, device="cpu")
    assert state.cycle == 2 and set(state.gaintables) == {"T", "G"}
    res = ical(obs["pcorrupted"], obs["pmodel"], nmajor=4, fused=fused, state=state, **TG)
    np.testing.assert_allclose(_np(res[0].pixels), _np(full[0].pixels), rtol=0, atol=1e-6)
    assert abs(float(res[1].pixels.abs().max()) - float(full[1].pixels.abs().max())) < 1e-6
    for t in "TG":
        np.testing.assert_allclose(
            _np(res[3][t].gain), _np(full[3][t].gain), rtol=0, atol=1e-6
        )
    # the standalone gain file holds the checkpoint's tables exactly (the
    # gains as complex64, the file's precision)
    state.export_gaintables(str(tmp_path / "gains.npz"))
    back = SelfCalState.import_gaintables(state.model, str(tmp_path / "gains.npz"), cycle=2)
    for t in "TG":
        np.testing.assert_array_equal(
            _np(back.gaintables[t].gain), _np(state.gaintables[t].gain).astype(np.complex64)
        )
        for f in ("weight", "residual", "time", "interval"):
            np.testing.assert_array_equal(
                _np(getattr(back.gaintables[t], f)), _np(getattr(state.gaintables[t], f))
            )


def test_fused_request_on_a_matrix_control_warns_and_composes(obs, caplog):
    """A "matrix" control at npol 1 cannot fuse: fused=True logs the JAX
    package's warning and runs the composed cycle (the scalar lane
    solves)."""
    controls = create_calibration_controls()
    controls["T"]["shape"] = "matrix"
    kw = dict(TG, calibration_context="T", controls=controls, nmajor=2)
    with caplog.at_level(logging.WARNING, logger="ska-sdp-func-python-torch"):
        out = ical(obs["pcorrupted"], obs["pmodel"], fused=True, **kw)
    assert any("not fusable" in r.getMessage() for r in caplog.records)
    ref = ical(obs["pcorrupted"], obs["pmodel"], fused=False, **kw)
    np.testing.assert_array_equal(_np(out[0].pixels), _np(ref[0].pixels))
    np.testing.assert_array_equal(_np(out[3]["T"].gain), _np(ref[3]["T"].gain))
