"""Parity of the port's calibration API with the JAX package's, in f64 on
the same seeded observation: gaintables for "T", "G" and "B", the
visibility arithmetic, the normal equations, ``solve_gaintable``, the
gain application and algebra, the calibration chain, the inverse DFT of
sky components and their restoration.

Tolerances: 1e-10 absolute (the solver bound; both sides run the same
f64 arithmetic and differ only in reduction order), exact for the
gaintable grids and concatenation (1e-15 for a product of gains, which
may round differently in the last bit), 1e-8 for the four-iteration chain, whose
warm-started solves compound the reduction-order differences.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.models import (
    SkyComponents as JaxSkyComponents,
    create_gaintable_from_visibility as jax_create_gaintable,
    create_image as jax_create_image,
)
from ska_sdp_func_python_tpu.ops import (
    apply_calibration_chain as jax_apply_calibration_chain,
    apply_gaintable as jax_apply_gaintable,
    calibrate_chain as jax_calibrate_chain,
    concatenate_gaintables as jax_concatenate_gaintables,
    dft_skycomponent_visibility as jax_dft,
    idft_visibility_skycomponent as jax_idft,
    multiply_gaintables as jax_multiply_gaintables,
    restore_skycomponent as jax_restore_skycomponent,
    solve_calibrate_chain as jax_solve_calibrate_chain,
)
from ska_sdp_func_python_tpu.ops.solvers import (
    build_normal_equations as jax_build_normal_equations,
    solve_gaintable as jax_solve_gaintable,
    solve_gains_core as jax_solve_gains_core,
)
from ska_sdp_func_python_tpu.ops.visibility_ops import (
    divide_visibility as jax_divide_visibility,
    subtract_visibility as jax_subtract_visibility,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models import create_gaintable_from_visibility
from ska_sdp_func_python_torch.ops import (
    apply_calibration_chain,
    apply_gaintable,
    build_normal_equations,
    calibrate_chain,
    concatenate_gaintables,
    divide_visibility,
    idft_visibility_skycomponent,
    multiply_gaintables,
    restore_skycomponent,
    solve_calibrate_chain,
    solve_gaintable,
    solve_gains_core,
    subtract_visibility,
)

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
NCHAN = 4
TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


def _same_table(port, ref, atol=TOL):
    """Gains, weights and residuals to ``atol``; the grid exactly."""
    for name in ("gain", "weight", "residual"):
        _close(getattr(port, name), getattr(ref, name), atol)
    for name in ("time", "interval", "frequency"):
        np.testing.assert_array_equal(_np(getattr(port, name)), _np(getattr(ref, name)))
    assert port.jones_type == ref.jones_type


@pytest.fixture(scope="module")
def obs():
    """Two point sources on 10 stations, 3 integrations, 4 channels, and
    the same observation corrupted by "T" (per integration), "G" (60 s
    bins, most of them empty) and "B" (one interval, per channel)."""
    rng = np.random.default_rng(1805550721)
    vis = make_visibility(nants=10, ntimes=3, nchan=NCHAN, rmax=300.0, phasecentre=PC)
    model = jax_create_image(
        64, 0.002, PC, frequency=np.asarray(vis.frequency), nchan=NCHAN
    )
    dirs = [model.pixel_to_radec(32 + 7, 32 - 5), model.pixel_to_radec(32 - 9, 32 + 4)]
    comps = JaxSkyComponents.from_lists(
        [[float(r), float(d)] for r, d in dirs],
        np.array([2.0, 0.7])[:, None, None] * np.ones((1, NCHAN, 1)),
        vis.frequency,
    )
    mvis = jax_dft(vis, comps)
    tables = {
        "T": _simulate_gaintable(jax_create_gaintable(mvis, "T"), rng, 0.3),
        "G": _simulate_gaintable(
            jax_create_gaintable(mvis, "G", timeslice=60.0), rng, 0.1, 0.05
        ),
        "B": _simulate_gaintable(
            jax_create_gaintable(mvis, "B", timeslice=1e5), rng, 0.25, 0.1
        ),
    }
    corrupted = mvis
    for t in "TGB":
        corrupted = jax_apply_gaintable(corrupted, tables[t])
    return dict(
        vis=corrupted, mvis=mvis, model=model, comps=comps, tables=tables,
        pvis=interop.to_visibility(corrupted, device=CPU),
        pmvis=interop.to_visibility(mvis, device=CPU),
    )


@pytest.mark.parametrize(
    "jones_type,timeslice", [("T", None), ("T", "auto"), ("G", 60.0), ("B", 1e5)]
)
def test_create_gaintable_matches_jax(obs, jones_type, timeslice):
    ref = jax_create_gaintable(obs["vis"], jones_type, timeslice=timeslice)
    out = create_gaintable_from_visibility(obs["pvis"], jones_type, timeslice=timeslice)
    _same_table(out, ref, atol=0.0)
    assert out.nchan == (NCHAN if jones_type == "B" else 1)
    back = interop.to_gaintable(ref, device=CPU)
    _same_table(back, ref, atol=0.0)


def test_subtract_and_divide_visibility_match_jax(obs):
    vis, mvis = obs["vis"], obs["mvis"]
    # a flagged sample in the model counts as zero model
    flags = np.zeros(mvis.flags.shape, np.int32)
    flags[1, 3, 2, 0] = 1
    mvis = mvis.replace(flags=jnp.asarray(flags))
    pmvis = interop.to_visibility(mvis, device=CPU)
    _close(
        subtract_visibility(obs["pvis"], pmvis).vis,
        jax_subtract_visibility(vis, mvis).vis,
    )
    ref = jax_divide_visibility(vis, mvis)
    out = divide_visibility(obs["pvis"], pmvis)
    _close(out.vis, ref.vis)
    _close(out.weight, ref.weight)
    assert float(out.weight[1, 3, 2, 0]) == 0.0


@pytest.mark.parametrize("jones_type,timeslice", [("G", 60.0), ("B", 1e5), ("T", 200.0)])
def test_build_normal_equations_matches_jax(obs, jones_type, timeslice):
    """One-channel tables sum the channels, "B" keeps them; a 200 s bin
    edge shows the inclusive interval membership."""
    point = jax_divide_visibility(obs["vis"], obs["mvis"])
    gt = jax_create_gaintable(obs["vis"], jones_type, timeslice=timeslice)
    ref = jax_build_normal_equations(point, gt)
    out = build_normal_equations(
        interop.to_visibility(point, device=CPU), interop.to_gaintable(gt, device=CPU)
    )
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        _close(o, r)


@pytest.mark.parametrize(
    "jones_type,timeslice,phase_only,normalise",
    [
        ("T", None, True, "mean"),
        ("G", 60.0, False, "mean"),
        ("G", 60.0, False, "median"),
        ("B", 1e5, False, "mean"),
    ],
)
def test_solve_gaintable_matches_jax(obs, jones_type, timeslice, phase_only, normalise):
    """Empty G intervals keep unit gain and zero weight, and still count
    in the normalisation."""
    kw = dict(
        phase_only=phase_only, jones_type=jones_type, timeslice=timeslice,
        normalise_gains=normalise, niter=100,
    )
    ref = jax_solve_gaintable(obs["vis"], obs["mvis"], **kw)
    out = solve_gaintable(obs["pvis"], obs["pmvis"], **kw)
    _same_table(out, ref)
    if jones_type == "G":
        empty = _np(out.weight).sum(axis=(1, 2, 3, 4)) == 0.0
        assert empty.sum() > out.ntimes // 2
        # a unit gain over the solved table's mean (median) amplitude
        g_empty = _np(out.gain)[empty]
        np.testing.assert_array_equal(g_empty, g_empty.flat[0])
        if normalise == "mean":
            assert g_empty.flat[0] != 1.0
            assert abs(np.abs(_np(out.gain)).mean() - 1.0) < 1e-12


def test_solve_gaintable_point_source_and_warm_start(obs):
    """No model: a point source at the phase centre; a given table is the
    warm start."""
    gt = jax_solve_gaintable(obs["vis"], obs["mvis"], niter=3)
    kw = dict(niter=5, tol=1e-12)
    _same_table(
        solve_gaintable(obs["pvis"], None, gain_table=interop.to_gaintable(gt, device=CPU), **kw),
        jax_solve_gaintable(obs["vis"], None, gain_table=gt, **kw),
    )


def test_crosspol_at_npol_1_runs_the_scalar_lane(obs):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 6, 1, 1)) + 1j * rng.normal(size=(2, 6, 6, 1, 1))
    xwt = rng.uniform(0.5, 2.0, x.shape)
    gain0 = np.ones((2, 6, 1, 1, 1), complex)
    kw = dict(niter=30, tol=1e-8, phase_only=False, crosspol=True, npol=1)
    ref = jax_solve_gains_core(jnp.asarray(x), jnp.asarray(xwt), jnp.asarray(gain0), **kw)
    out = solve_gains_core(torch.as_tensor(x), torch.as_tensor(xwt), torch.as_tensor(gain0), **kw)
    for o, r in zip(out, ref):
        _close(o, r)
    _same_table(
        solve_gaintable(obs["pvis"], obs["pmvis"], crosspol=True, phase_only=False),
        jax_solve_gaintable(obs["vis"], obs["mvis"], crosspol=True, phase_only=False),
    )


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_bandpass_gaintable_matches_jax(obs, inverse):
    gt = obs["tables"]["B"]
    ref = jax_apply_gaintable(obs["mvis"], gt, inverse=inverse)
    out = apply_gaintable(obs["pmvis"], interop.to_gaintable(gt, device=CPU), inverse=inverse)
    _close(out.vis, ref.vis)
    _close(out.weight, ref.weight)


def test_multiply_and_concatenate_gaintables_match_jax(obs):
    t, g = obs["tables"]["T"], obs["tables"]["G"]
    pt, pg = (interop.to_gaintable(x, device=CPU) for x in (t, g))
    # complex products may round differently in the last bit
    _same_table(multiply_gaintables(pt, pt), jax_multiply_gaintables(t, t), atol=1e-15)
    _same_table(concatenate_gaintables([pt, pg]), jax_concatenate_gaintables([t, g]), atol=0.0)
    with pytest.raises(ValueError):
        concatenate_gaintables([])


def test_calibrate_chain_tgb_matches_jax(obs):
    """Four self-cal iterations of the "TGB" chain, each warm-started from
    the last one's tables, then the solve-only and apply-only chains on
    the result."""
    jgt = pgt = None
    for it in range(4):
        jvis, jgt = jax_calibrate_chain(
            obs["vis"], obs["mvis"], gaintables=jgt, calibration_context="TGB",
            iteration=it,
        )
        pvis, pgt = calibrate_chain(
            obs["pvis"], obs["pmvis"], gaintables=pgt, calibration_context="TGB",
            iteration=it,
        )
        _close(pvis.vis, jvis.vis, 1e-8)
        for t in "TGB":
            _same_table(pgt[t], jgt[t], 1e-8)
    jsol = jax_solve_calibrate_chain(
        obs["vis"], obs["mvis"], gaintables=list(jgt.values()), calibration_context="GB"
    )
    psol = solve_calibrate_chain(
        obs["pvis"], obs["pmvis"], gaintables=list(pgt.values()), calibration_context="GB"
    )
    assert set(psol) == set(jsol) == {"G", "B"}
    for t in psol:
        _same_table(psol[t], jsol[t], 1e-8)
    _close(
        apply_calibration_chain(obs["pmvis"], psol, calibration_context="GB").vis,
        jax_apply_calibration_chain(obs["mvis"], jsol, calibration_context="GB").vis,
        1e-8,
    )


def test_solve_calibrate_chain_without_model_keeps_the_tables(obs):
    zero = obs["pmvis"].replace(vis=torch.zeros_like(obs["pmvis"].vis))
    gts = solve_calibrate_chain(obs["pvis"], zero, calibration_context="TG")
    for t in "TG":
        assert bool((gts[t].gain == 1.0).all())


def test_idft_visibility_skycomponent_matches_jax(obs):
    comps = obs["comps"]
    ref, rw = jax_idft(obs["vis"], comps)
    out, ow = idft_visibility_skycomponent(
        obs["pvis"], interop.to_skycomponents(comps, device=CPU)
    )
    _close(out.flux, ref.flux)
    _close(ow, rw)


@pytest.mark.parametrize("image_chans", [NCHAN, 1])
def test_restore_skycomponent_matches_jax(obs, image_chans):
    """Components of NCHAN channels on a cube, and their mean flux on a
    one-channel image; one-channel components on the cube."""
    model, comps = obs["model"], obs["comps"]
    rng = np.random.default_rng(5)
    im = model.replace(
        pixels=jnp.asarray(rng.normal(size=(image_chans,) + model.pixels.shape[1:]))
    )
    beam = {"bmaj": 0.6, "bmin": 0.35, "bpa": 25.0}
    for sc in (comps, comps.replace(flux=comps.flux[:, :1])):
        ref = jax_restore_skycomponent(im, sc, beam)
        out = restore_skycomponent(
            interop.to_image(im, device=CPU), interop.to_skycomponents(sc, device=CPU), beam
        )
        _close(out.pixels, ref.pixels)
        _close(out.clean_beam, ref.clean_beam, 0.0)
