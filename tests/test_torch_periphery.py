"""The port's imaging periphery (S11a) against the JAX package: coordinates,
observation geometry, the MID configuration, the visibility algebra, the
image polarisation conversions, ``extract_oversampled``, the FFT
coordinate helpers and ``w_beam`` with a shifted centre.

The JAX side runs on the CPU under x64 (``tests/conftest.py``); the port
with ``device="cpu"``, from the same seeded numpy inputs. Tolerances:
f64 results agree to 1e-10 of their maximum, f32 results (an f32
Visibility's algebra) to 1e-5 of their maximum, the MID layout exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ska_sdp_func_python_tpu.ops as J
import ska_sdp_func_python_tpu.utils.coordinates as JC
import ska_sdp_func_python_tpu.utils.geometry as JG
from ska_sdp_func_python_tpu.models import (
    create_named_configuration as jax_configuration,
    create_visibility as jax_create_visibility,
)
from ska_sdp_func_python_tpu.ops.fft import extract_oversampled as jax_extract_oversampled
from ska_sdp_func_python_tpu.ops.pswf import w_beam as jax_w_beam
import ska_sdp_func_python_torch.ops as P
import ska_sdp_func_python_torch.utils.coordinates as PC
import ska_sdp_func_python_torch.utils.geometry as PG
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models import create_image, create_named_configuration

from simul import make_visibility

CPU = torch.device("cpu")
LOCATION = (np.deg2rad(-30.712925), np.deg2rad(21.443803), 1053.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(port, ref, tol=1e-10):
    """Every array of ``port`` within ``tol`` of the maximum of ``ref``."""
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b, tol)
        return
    a, b = _np(port), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))) if b.size else 0.0, 1e-300)
    assert np.max(np.abs(a - b)) <= tol * scale, (np.max(np.abs(a - b)), scale)


# ---------------------------------------------------------------------------
# coordinates

RNG = np.random.default_rng(7)
XYZ = RNG.uniform(-3000.0, 3000.0, (12, 3))
UVW = RNG.uniform(-2000.0, 2000.0, (5, 7, 3))
HA = RNG.uniform(-0.5, 0.5, 5)[:, None]
LAT, LON, ALT = LOCATION
ECEF = np.stack(JC.lla_to_ecef(LAT + RNG.uniform(-1e-3, 1e-3, 6),
                               LON + RNG.uniform(-1e-3, 1e-3, 6),
                               ALT + RNG.uniform(0, 50, 6)), -1)

# (name, argument builder): each function of both packages on the same
# numpy f64 inputs, the port's also on tensors
CASES = {
    "lla_to_ecef": lambda: (LAT + RNG.uniform(-0.1, 0.1, 4), LON, ALT),
    "ecef_to_enu": lambda: (LOCATION, np.asarray(ECEF)),
    "enu_to_ecef": lambda: (LOCATION, XYZ),
    "enu_to_xyz": lambda: (XYZ[:, 0], XYZ[:, 1], XYZ[:, 2], LAT),
    "xyz_at_latitude": lambda: (XYZ, LAT),
    "xyz_to_uvw": lambda: (XYZ, 0.3, -0.6),
    "uvw_to_xyz": lambda: (UVW, HA, -0.6),
    "eci_to_uvw": lambda: (XYZ, 0.3, -0.6),
    "uvw_transform": lambda: (UVW, np.array([[1.01, 0.02], [-0.03, 0.98]])),
    "parallactic_angle": lambda: (HA[:, 0], -0.6, LAT),
    "pa_z": lambda: (HA[:, 0], -0.6, LAT),
    "hadec_to_azel": lambda: (HA[:, 0], -0.6, LAT),
    "azel_to_hadec": lambda: (HA[:, 0] + 1.0, 0.7, LAT),
    "ecef_to_lla": lambda: tuple(np.asarray(ECEF).T),
    "enu_to_eci": lambda: (XYZ, LAT),
    "eci_to_enu": lambda: (XYZ, LAT),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_coordinate_transforms_match_jax(name):
    """Each frame transform of the port, on numpy inputs (host f64) and on
    f64 tensors, against the JAX function."""
    args = CASES[name]()
    ref = getattr(JC, name)(*args)
    _close(getattr(PC, name)(*args), ref)
    targs = tuple(
        torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args
    )
    _close(getattr(PC, name)(*targs), ref)


def test_baselines_directions_and_phasors_match_jax():
    """baselines, xyz_to_baselines, skycoord_to_lmn, lmn_to_skycoord,
    uvw_to_eci and the point-source phasors, in f64; the phasors also in
    f32 (the split-compensated phase) to 1e-5."""
    _close(PC.baselines(XYZ), JC.baselines(XYZ))
    _close(PC.baselines(torch.as_tensor(XYZ)), JC.baselines(XYZ))
    ha = np.linspace(-0.2, 0.2, 3)
    _close(PC.xyz_to_baselines(XYZ, ha, -0.6), JC.xyz_to_baselines(XYZ, ha, -0.6))
    pos = np.array([[0.01, -0.62], [0.02, -0.58]])
    pc = np.array([0.0, -0.6])
    _close(PC.skycoord_to_lmn(pos, pc), JC.skycoord_to_lmn(pos, pc))
    lmn = JC.skycoord_to_lmn(pos[0], pc)
    _close(PC.lmn_to_skycoord(lmn, pc), JC.lmn_to_skycoord(lmn, pc))
    _close(PC.uvw_to_eci(UVW, 0.1, 0.2), JC.uvw_to_eci(UVW, 0.1, 0.2))
    l, m = 0.012, -0.007
    for fn in ("simulate_point", "simulate_point_antenna"):
        ref = getattr(JC, fn)(UVW, l, m)
        _close(getattr(PC, fn)(torch.as_tensor(UVW), l, m), ref)
        _close(getattr(PC, fn)(torch.as_tensor(UVW, dtype=torch.float32), l, m), ref, 1e-5)
    vis = RNG.normal(size=UVW.shape[:-1]) + 1j * RNG.normal(size=UVW.shape[:-1])
    _close(PC.visibility_shift(torch.as_tensor(UVW), torch.as_tensor(vis), l, m),
           JC.visibility_shift(UVW, vis, l, m))


# ---------------------------------------------------------------------------
# geometry


def test_geometry_matches_jax():
    """GMST, hour angles, parallactic angles, az/el, transit time and the
    MJD epoch conversion from absolute epochs (MJD seconds), in host f64;
    tensor times on the device give the same."""
    t = 5.0e9 + np.linspace(0.0, 3600.0, 7)
    direction = np.array([1.1, -0.5])
    _close(PG.greenwich_mean_sidereal_time(t), JG.greenwich_mean_sidereal_time(t))
    for fn in ("calculate_hourangles", "calculate_parallactic_angles",
               "calculate_azel", "calculate_transit_time"):
        ref = getattr(JG, fn)(LOCATION, t, direction)
        _close(getattr(PG, fn)(LOCATION, t, direction), ref)
        _close(getattr(PG, fn)(LOCATION, torch.as_tensor(t), direction), ref)
    _close(PG.utc_to_ms_epoch(np.array([58000.25, 60000.5])),
           JG.utc_to_ms_epoch(np.array([58000.25, 60000.5])))


def test_visibility_geometry_matches_jax():
    vis = make_visibility(nants=4, ntimes=5, nchan=1)
    pvis = interop.to_visibility(vis, CPU)
    for fn in ("calculate_visibility_hourangles", "calculate_visibility_parallactic_angles",
               "calculate_visibility_azel", "calculate_visibility_transit_time"):
        _close(getattr(P, fn)(pvis, LOCATION), getattr(J, fn)(vis, LOCATION))
    loc, t, pc = P.get_direction_time_location(pvis)
    jloc, jt, jpc = J.get_direction_time_location(vis)
    assert loc is None and jloc is None
    _close(t, jt)
    _close(pc, jpc)


# ---------------------------------------------------------------------------
# configurations


@pytest.mark.parametrize("rmax", [None, 2000.0])
def test_mid_configuration_matches_jax(rmax):
    """"MID": the JAX package's 197 dishes of 15 m at its site, the same
    positions to the last bit (with and without a radius cut)."""
    a = create_named_configuration("MID", rmax=rmax)
    b = jax_configuration("MID", rmax=rmax)
    np.testing.assert_array_equal(a.xyz, np.asarray(b.xyz))
    assert a.names == b.names and a.location == b.location
    np.testing.assert_array_equal(a.diameter, b.diameter)
    if rmax is None:
        assert a.nants == 197 and np.all(a.diameter == 15.0)
    with pytest.raises(ValueError, match="Unknown configuration"):
        create_named_configuration("ASKAP")


def test_mid_observation_matches_jax():
    cfg = create_named_configuration("MID", rmax=3000.0)
    times = np.linspace(-0.3, 0.3, 4)
    ref = jax_create_visibility(jax_configuration("MID", rmax=3000.0), times, [1.4e9])
    out = interop.to_visibility(ref, CPU)
    from ska_sdp_func_python_torch.models import create_visibility

    vis = create_visibility(cfg, times, [1.4e9], dtype=torch.float64, device=CPU)
    _close(vis.uvw, out.uvw)
    _close(vis.time, out.time)


# ---------------------------------------------------------------------------
# visibility algebra


def _observation(dtype=torch.float64, nchan=4, ntimes=6, seed=3, flag_share=0.1):
    """(JAX vis, port vis) holding the same random visibilities, weights
    and a few flags (``flag_share`` of the samples), on a 6-station
    layout."""
    vis = make_visibility(nants=6, ntimes=ntimes, nchan=nchan, rmax=400.0)
    rng = np.random.default_rng(seed)
    shape = vis.vis.shape
    data = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    wt = rng.uniform(0.5, 2.0, shape)
    flags = (rng.uniform(size=shape) < flag_share).astype(np.int32)
    vis = vis.replace(vis=jnp.asarray(data), weight=jnp.asarray(wt),
                      imaging_weight=jnp.asarray(wt), flags=jnp.asarray(flags))
    pvis = interop.to_visibility(vis, CPU)
    if dtype == torch.float32:
        pvis = pvis.replace(
            vis=pvis.vis.to(torch.complex64), weight=pvis.weight.float(),
            imaging_weight=pvis.imaging_weight.float(), uvw=pvis.uvw.float(),
            frequency=pvis.frequency.float(), channel_bandwidth=pvis.channel_bandwidth.float(),
        )
    return vis, pvis


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_phaserotate_reprojects_uvw_like_jax(dtype, inverse):
    """``phaserotate_visibility(tangent=False)``: the visibilities, the
    re-projected uvw and the new phase centre as the JAX package's; a
    rotation to the new centre and back to the old returns the
    visibilities and uvw (the JAX package's round trip,
    tests/test_misc_ops.py:92-106)."""
    vis, pvis = _observation(dtype)
    new = (0.02, np.deg2rad(-34.0))
    ref = J.phaserotate_visibility(vis, new, tangent=False, inverse=inverse)
    out = P.phaserotate_visibility(pvis, new, tangent=False, inverse=inverse)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    _close(out.vis, ref.vis, tol)
    _close(out.uvw, ref.uvw, tol)
    _close(out.phasecentre, ref.phasecentre)
    assert out.uvw.dtype == pvis.uvw.dtype and out.time.dtype == torch.float64
    back = P.phaserotate_visibility(out, pvis.phasecentre, tangent=False, inverse=inverse)
    _close(back.vis, pvis.vis, tol)
    _close(back.uvw, pvis.uvw, tol)
    _close(back.phasecentre, pvis.phasecentre)


def test_concatenate_matches_jax():
    """``concatenate_visibility`` along time (the two halves give the
    whole) and frequency, and ``concatenate_visibility_frequency``."""
    vis, pvis = _observation()
    halves = [pvis.replace(**{f: getattr(pvis, f)[s] for f in
                              ("vis", "weight", "imaging_weight", "flags", "uvw", "time",
                               "integration_time")})
              for s in (slice(0, 3), slice(3, None))]
    whole = P.concatenate_visibility(halves, dim="time")
    for f in ("vis", "weight", "flags", "uvw", "time", "integration_time"):
        assert torch.equal(getattr(whole, f), getattr(pvis, f)), f
    parts = [pvis.replace(vis=pvis.vis[:, :, s], weight=pvis.weight[:, :, s],
                          imaging_weight=pvis.imaging_weight[:, :, s], flags=pvis.flags[:, :, s],
                          frequency=pvis.frequency[s], channel_bandwidth=pvis.channel_bandwidth[s])
             for s in (slice(0, 1), slice(1, None))]
    jparts = [vis.replace(vis=vis.vis[:, :, s], weight=vis.weight[:, :, s],
                          imaging_weight=vis.imaging_weight[:, :, s], flags=vis.flags[:, :, s],
                          frequency=vis.frequency[s], channel_bandwidth=vis.channel_bandwidth[s])
              for s in (slice(0, 1), slice(1, None))]
    out = P.concatenate_visibility_frequency(parts)
    ref = J.concatenate_visibility_frequency(jparts)
    for f in ("vis", "weight", "imaging_weight", "flags", "frequency", "channel_bandwidth"):
        _close(getattr(out, f), getattr(ref, f))
    with pytest.raises(ValueError):
        P.concatenate_visibility(parts, dim="baseline")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_channel_integration_and_averaging_match_jax(dtype):
    vis, pvis = _observation(dtype, nchan=5)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    fields = ("vis", "weight", "imaging_weight", "flags", "frequency", "channel_bandwidth")
    out, ref = P.integrate_visibility_by_channel(pvis), J.integrate_visibility_by_channel(vis)
    for f in fields:
        _close(getattr(out, f), getattr(ref, f), tol)
    outs, refs = P.average_visibility_by_channel(pvis, 2), J.average_visibility_by_channel(vis, 2)
    assert len(outs) == len(refs) == 3
    for o, r in zip(outs, refs):
        for f in fields:
            _close(getattr(o, f), getattr(r, f), tol)
    assert P.calculate_visibility_uvw_lambda(pvis) is pvis


@pytest.mark.parametrize("degree,mask", [(1, None), (2, [0, 1, 0, 0, 0, 0])])
def test_remove_continuum_matches_jax(degree, mask):
    """The weighted polynomial fit and subtraction; no flags, so that every
    spectrum's fit is well posed (a spectrum with fewer unflagged
    channels than coefficients has no unique fit in either package)."""
    vis, pvis = _observation(nchan=6, flag_share=0.0)
    # a smooth continuum under the noise
    f = np.asarray(vis.frequency)
    cont = (1.0 + 0.3 * (f - f.mean()) / f.std())[None, None, :, None]
    vis = vis.replace(vis=vis.vis + cont)
    pvis = pvis.replace(vis=pvis.vis + torch.as_tensor(cont))
    _close(P.remove_continuum_visibility(pvis, degree=degree, mask=mask).vis,
           J.remove_continuum_visibility(vis, degree=degree, mask=mask).vis)


# ---------------------------------------------------------------------------
# images, FFT helpers and the w-beam


@pytest.mark.parametrize("frame", ["linear", "circular", "stokesI"])
def test_image_polarisation_conversions_match_jax(frame):
    """``convert_stokes_to_polimage`` and back with
    ``convert_polimage_to_stokes`` (real and complex), and the clean-beam
    converters, against the JAX package's image_ops."""
    from ska_sdp_func_python_tpu.models import create_image as jax_create_image

    npol = 1 if frame == "stokesI" else 4
    src = "stokesI" if frame == "stokesI" else "stokesIQUV"
    px = np.random.default_rng(5).normal(size=(2, npol, 16, 16))
    jim = jax_create_image(16, 0.001, (0.0, -0.6), frequency=[1e8, 1.1e8],
                           polarisation_frame=src).with_pixels(jnp.asarray(px))
    pim = create_image(16, 0.001, (0.0, -0.6), frequency=[1e8, 1.1e8],
                       polarisation_frame=src, dtype=torch.float64, device=CPU)
    pim = pim.replace(pixels=torch.as_tensor(px))
    ref = J.convert_stokes_to_polimage(jim, frame)
    out = P.convert_stokes_to_polimage(pim, frame)
    assert out.polarisation_frame == ref.polarisation_frame
    _close(out.pixels, ref.pixels)
    for complex_image in (False, True):
        r = J.convert_polimage_to_stokes(ref, complex_image=complex_image)
        o = P.convert_polimage_to_stokes(out, complex_image=complex_image)
        assert o.polarisation_frame == r.polarisation_frame
        _close(o.pixels, r.pixels)
    beam = (2.5, 1.5, 0.3)
    from ska_sdp_func_python_tpu.ops.image_ops import (
        convert_clean_beam_to_degrees as jd,
        convert_clean_beam_to_pixels as jp,
    )

    deg = P.convert_clean_beam_to_degrees(pim, beam)
    assert deg == pytest.approx(jd(jim, beam), rel=1e-12)
    assert P.convert_clean_beam_to_pixels(pim, deg) == pytest.approx(jp(jim, deg), rel=1e-12)


@pytest.mark.parametrize("xf,yf", [(0, 0), (3, 5), (7, 1)])
def test_extract_oversampled_matches_jax(xf, yf):
    a = np.random.default_rng(9).normal(size=(128, 128)) + 1j
    ref = jax_extract_oversampled(jnp.asarray(a), xf, yf, 8, 8)
    _close(P.extract_oversampled(torch.as_tensor(a), xf, yf, 8, 8), ref)


@pytest.mark.parametrize("npixel", [16, 17])
def test_fft_coordinates_match_jax(npixel):
    assert P.coordinate_bounds(npixel) == J.coordinate_bounds(npixel)
    assert P.coordinateBounds is P.coordinate_bounds
    assert P.coordinates2Offset is P.coordinates2_offset
    _close(P.coordinates(npixel), J.coordinates(npixel))
    _close(P.coordinates2(npixel), J.coordinates2(npixel))
    for quadrant in (False, True):
        _close(P.coordinates2_offset(npixel, 5, 7, quadrant),
               J.coordinates2_offset(npixel, 5, 7, quadrant))
        _close(P.coordinates2_offset(npixel, None, None, quadrant),
               J.coordinates2_offset(npixel, None, None, quadrant))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("centre", [(None, None), (60, 70)])
def test_w_beam_shift_and_centre_match_jax(dtype, centre):
    """``w_beam`` with a centre (cx, cy) and ``remove_shift=True`` (the
    beam divided by its value at the last pixel), f64 to 1e-10 and f32 to
    1e-5 of the maximum."""
    cx, cy = centre
    w = 1234.5
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    for remove_shift in (False, True):
        ref = jax_w_beam(128, 0.05, w, cx=cx, cy=cy, remove_shift=remove_shift)
        out = P.w_beam(128, 0.05, torch.tensor(w, dtype=dtype), cx=cx, cy=cy,
                       remove_shift=remove_shift)
        _close(out, ref, tol)
