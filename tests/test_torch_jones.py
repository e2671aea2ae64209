"""Parity of the port's 2x2 Jones algebra and matrix-lane solves with the
JAX package's, in f64 on the same seeded inputs: the closed-form 2x2
inverse, gain application at npol 2 and 4 (forward, inverse, singular
gains), ``apply_jones``, 2x2 ``multiply_gaintables``, the 2x2
gaintables, the normal equations, and the matrix lane of
``solve_gains_core`` and ``solve_gaintable`` at npol 2, 4 and 4 with
cross-polarisation, phase-only and not.

Tolerances: 1e-12 for the algebra (a few f64 products); 1e-10 for the
solves, the solver bound the JAX package holds against its reference;
masks, tables' grids and shapes exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.models import (
    SkyComponents as JaxSkyComponents,
    create_gaintable_from_visibility as jax_create_gaintable,
)
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable as jax_apply_gaintable,
    dft_skycomponent_visibility as jax_dft,
    multiply_gaintables as jax_multiply_gaintables,
)
from ska_sdp_func_python_tpu.ops.gain_ops import _inv2x2 as jax_inv2x2
from ska_sdp_func_python_tpu.ops.gain_ops import apply_jones as jax_apply_jones
from ska_sdp_func_python_tpu.ops.solvers import (
    build_normal_equations as jax_build_normal_equations,
    solve_gaintable as jax_solve_gaintable,
    solve_gains_core as jax_solve_gains_core,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models import create_gaintable_from_visibility
from ska_sdp_func_python_torch.ops import (
    apply_gaintable,
    build_normal_equations,
    multiply_gaintables,
    solve_gaintable,
    solve_gains_core,
)
from ska_sdp_func_python_torch.ops.gain_ops import _inv2x2, apply_jones

from simul import make_visibility

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, ref, atol=1e-12):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


def _c(rng, shape, scale=1.0):
    return scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))


def _jones(rng, shape, leak=0.1):
    """Near-unit 2x2 Jones ``shape + (2, 2)`` with complex leakage."""
    g = np.zeros(shape + (2, 2), complex)
    for r in range(2):
        g[..., r, r] = (1.0 + rng.normal(0, 0.1, shape)) * np.exp(1j * rng.normal(0, 0.3, shape))
    g[..., 0, 1] = _c(rng, shape, leak)
    g[..., 1, 0] = _c(rng, shape, leak)
    return g


def test_inv2x2_matches_jax():
    rng = np.random.default_rng(21)
    m = _c(rng, (6, 3, 2, 2))
    m[0, 0] = [[1.0, 2.0], [2.0, 4.0]]  # singular
    m[1, 1] = 0.0
    m[2, 2] = [[1e-4, 0.0], [0.0, 1e-4]]  # |det| 1e-8
    for min_det in (0.0, 1e-6):
        ri, rok = jax_inv2x2(jnp.asarray(m), min_det=min_det)
        oi, ook = _inv2x2(torch.as_tensor(m), min_det=min_det)
        np.testing.assert_array_equal(_np(ook), np.asarray(rok))
        _close(oi, ri)
    assert not bool(ook[2, 2]) and bool(_inv2x2(torch.as_tensor(m))[1][2, 2])


@pytest.fixture(scope="module")
def obs():
    """Polarised point sources on 7 stations, 3 integrations, 2 channels,
    in the linear, linearnp and circular frames, with 2x2 "T" and "B"
    tables (leaky, with a singular Jones for the inverse)."""
    rng = np.random.default_rng(1805550721)
    out = {}
    for frame in ("linear", "linearnp", "circular"):
        vis = make_visibility(nants=7, ntimes=3, nchan=2, rmax=300.0, phasecentre=PC,
                              polarisation_frame=frame)
        comps = JaxSkyComponents.from_lists(
            [[PC[0] + 0.01, PC[1] - 0.02], [PC[0] - 0.02, PC[1] + 0.01]],
            np.asarray([[[2.0, 0.3, 0.15, 0.05]], [[0.8, -0.1, 0.05, 0.0]]]),
            vis.frequency, polarisation_frame="stokesIQUV",
        )
        mvis = jax_dft(vis, comps)
        tables = {}
        for jt, ts in (("T", None), ("B", 1e5)):
            gt = jax_create_gaintable(mvis, jt, timeslice=ts)
            g = _jones(rng, gt.gain.shape[:3])
            tables[jt] = gt.replace(gain=jnp.asarray(g))
        out[frame] = dict(mvis=mvis, comps=comps, tables=tables,
                          pmvis=interop.to_visibility(mvis, device=CPU))
    return out


@pytest.mark.parametrize("frame", ["linear", "linearnp"])
@pytest.mark.parametrize("jones_type,timeslice", [("T", None), ("G", 60.0), ("B", 1e5)])
def test_create_gaintable_2x2_matches_jax(obs, frame, jones_type, timeslice):
    ref = jax_create_gaintable(obs[frame]["mvis"], jones_type, timeslice=timeslice)
    out = create_gaintable_from_visibility(obs[frame]["pmvis"], jones_type, timeslice=timeslice)
    assert out.nrec == 2
    for name in ("gain", "weight", "residual", "time", "interval", "frequency"):
        _close(getattr(out, name), getattr(ref, name), atol=0.0)


@pytest.mark.parametrize("frame", ["linear", "linearnp", "circular"])
@pytest.mark.parametrize("jones_type", ["T", "B"])
@pytest.mark.parametrize("inverse", [False, True])
def test_apply_gaintable_2x2_matches_jax(obs, frame, jones_type, inverse):
    """Forward and inverse; one singular Jones under ``inverse`` zeroes
    the visibilities and weights of its baselines."""
    o = obs[frame]
    gt = o["tables"][jones_type]
    g = np.array(gt.gain)
    g[0, 2, -1] = [[1.0, 2.0], [0.5, 1.0]]  # det 0
    gt = gt.replace(gain=jnp.asarray(g))
    vis = o["mvis"].replace(weight=jnp.asarray(np.random.default_rng(3).uniform(
        0.5, 2.0, o["mvis"].weight.shape)))
    ref = jax_apply_gaintable(vis, gt, inverse=inverse)
    out = apply_gaintable(interop.to_visibility(vis, device=CPU),
                          interop.to_gaintable(gt, device=CPU), inverse=inverse)
    _close(out.vis, ref.vis)
    _close(out.weight, ref.weight, atol=0.0)
    if inverse:
        assert float(np.abs(_np(out.weight)).min()) == 0.0


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_jones_matches_jax(inverse):
    rng = np.random.default_rng(5)
    ej = _jones(rng, (4, 3))
    ej[0, 0] = 0.0
    cfs = _c(rng, (4, 3, 2, 2))
    ref = jax_apply_jones(jnp.asarray(ej), jnp.asarray(cfs), inverse=inverse)
    out = apply_jones(torch.as_tensor(ej), torch.as_tensor(cfs), inverse=inverse)
    _close(out, ref)


def test_multiply_gaintables_2x2_matches_jax(obs):
    t = obs["linear"]["tables"]["T"]
    d = t.replace(gain=jnp.asarray(_jones(np.random.default_rng(6), t.gain.shape[:3])),
                  weight=t.weight * 0.5)
    ref = jax_multiply_gaintables(t, d)
    out = multiply_gaintables(interop.to_gaintable(t, device=CPU), interop.to_gaintable(d, device=CPU))
    _close(out.gain, ref.gain, atol=1e-15)
    _close(out.weight, ref.weight, atol=0.0)


@pytest.mark.parametrize("frame", ["linear", "linearnp"])
@pytest.mark.parametrize("jones_type,timeslice", [("T", None), ("B", 1e5)])
def test_build_normal_equations_2x2_matches_jax(obs, frame, jones_type, timeslice):
    o = obs[frame]
    gt = jax_create_gaintable(o["mvis"], jones_type, timeslice=timeslice)
    rx, rw = jax_build_normal_equations(o["mvis"], gt)
    ox, ow = build_normal_equations(o["pmvis"], interop.to_gaintable(gt, device=CPU))
    _close(ox, rx)
    _close(ow, rw)


LANES = [(2, False), (4, False), (4, True)]


@pytest.mark.parametrize("npol,crosspol", LANES, ids=["npol2", "npol4", "npol4-crosspol"])
@pytest.mark.parametrize("phase_only", [True, False])
def test_solve_gains_core_matrix_lane_matches_jax(npol, crosspol, phase_only):
    """Seeded normal equations of 6 stations and 3 intervals with
    cross-hand data; warm-started from diagonal gains; the intervals stop
    at different iterations."""
    rng = np.random.default_rng(31 + npol + 2 * crosspol)
    nsol, nants, nchan = 3, 6, 2
    g = _jones(rng, (nsol, nants, nchan), leak=0.0)
    v = np.einsum("sifpq,sjflq->sijfpl", g, np.conj(g)).reshape(nsol, nants, nants, nchan, 4)
    v = v + _c(rng, v.shape, 0.01 * (1 + np.arange(nsol))[:, None, None, None, None])
    x = v if npol == 4 else v[..., [0, 3]]
    xwt = rng.uniform(0.5, 2.0, x.shape)
    xwt[:, 2, 4] = 0.0
    gain0 = np.broadcast_to(np.eye(2, dtype=complex), (nsol, nants, nchan, 2, 2)).copy()
    kw = dict(niter=200, tol=1e-6, phase_only=phase_only, crosspol=crosspol, npol=npol)
    ref = jax_solve_gains_core(jnp.asarray(x), jnp.asarray(xwt), jnp.asarray(gain0), **kw)
    out = solve_gains_core(torch.as_tensor(x), torch.as_tensor(xwt), torch.as_tensor(gain0), **kw)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        _close(o, r, atol=TOL)


@pytest.mark.parametrize("frame,crosspol", [("linearnp", False), ("linear", False), ("linear", True)],
                         ids=["npol2", "npol4", "npol4-crosspol"])
@pytest.mark.parametrize("phase_only", [True, False])
def test_solve_gaintable_matrix_lane_matches_jax(obs, frame, crosspol, phase_only):
    """The "T" table of the corrupted observation against its model,
    warm-started from the unit table, normalised by the mean amplitude."""
    o = obs[frame]
    corrupted = jax_apply_gaintable(o["mvis"], o["tables"]["T"])
    kw = dict(phase_only=phase_only, crosspol=crosspol, niter=60, tol=1e-8)
    ref = jax_solve_gaintable(corrupted, o["mvis"], **kw)
    out = solve_gaintable(interop.to_visibility(corrupted, device=CPU), o["pmvis"], **kw)
    for name in ("gain", "weight", "residual"):
        _close(getattr(out, name), getattr(ref, name), atol=TOL)
