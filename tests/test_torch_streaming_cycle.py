"""The port's ``streamed_ical``: the "TB" cube against the JAX package's
(the third configuration of ``tests/test_torch_streaming.py``), against
the port's in-memory ``ical`` (MFS, and a full-Jones "matrix" term at npol
4), and on its own (the slab cache, the f16 wire, ``uvw_compute`` at
MJD-second times, the warm start and the refusals, a run of two
processes among them).

Bounds: against the JAX package as in ``tests/test_torch_streaming.py``
(gains 1e-4, peaks 1e-3 relative, components at the same pixels); against
the in-memory ``ical``, JAX tests/test_streaming_wide.py's (peak residuals
0.03 apart, restored peaks 0.06; its full-Jones test's 1e-3 on the
residual peak); cached and uncached runs equal exactly; the f16 wire's
residual image within 5e-3 of the f32 wire's maximum and its restored peak
within 5e-3; the geometry's uvw equal to the store's to 1e-6 in the
restored image; the warm start as JAX's test_streamed_warm_start_continues.
"""

import os

import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.io import write_visibility as jax_write_visibility
from ska_sdp_func_python_tpu.models import (
    SkyComponents,
    create_gaintable_from_visibility,
)
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable,
    create_image_from_visibility,
    dft_skycomponent_visibility,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.io import VisStore, write_visibility_arrays
from ska_sdp_func_python_torch.models import create_image, random_array_xyz
from ska_sdp_func_python_torch.ops import create_calibration_controls
from ska_sdp_func_python_torch.ops import (
    create_image_from_visibility as port_create_image_from_visibility,
)
from ska_sdp_func_python_torch.pipeline import ical
from ska_sdp_func_python_torch.streaming import streamed_ical
from ska_sdp_func_python_torch.utils.coordinates import xyz_to_uvw

from simul import make_visibility
from test_solvers import _simulate_gaintable
from test_torch_streaming import check_components, check_gains, check_peaks, run_case

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
CLEAN_KW = dict(nmajor=3, algorithm="hogbom", niter=150, gain=0.2, fractional_threshold=0.01)
SIDEREAL_DAY = 86164.1


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def cube_tb(tmp_path_factory):
    return run_case("cube_TB", tmp_path_factory.mktemp("cube"))


def test_cube_tb_gains_match_jax(cube_tb):
    check_gains(*cube_tb)


def test_cube_tb_peaks_match_jax(cube_tb):
    check_peaks(*cube_tb)


def test_cube_tb_components_match_jax(cube_tb):
    check_components(*cube_tb)


def _source_vis(rng, nchan=1, flux=1.5, nants=8, ntimes=6, npixel=64):
    """JAX tests/test_streaming_wide.py ``_source_vis`` corrupted by "T"
    phases N(0, 0.3): (corrupted JAX Visibility, JAX model)."""
    vis = make_visibility(nants=nants, ntimes=ntimes, nchan=nchan, rmax=300.0, phasecentre=PC)
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=4.0, nchan=nchan)
    ra, dec = model.pixel_to_radec(npixel // 2 + 5, npixel // 2 - 4)
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], [[[flux]] * nchan], vis.frequency)
    vis = dft_skycomponent_visibility(vis, comps)
    gt = _simulate_gaintable(create_gaintable_from_visibility(vis, "T"), rng, phase_error=0.3)
    return apply_gaintable(vis, gt), model


def _assert_match(res, mem, resid_tol=0.03, peak_tol=0.06):
    r_stream = float(res.residual.pixels.abs().max())
    r_mem = float(mem[1].pixels.abs().max())
    assert abs(r_stream - r_mem) < resid_tol, (r_stream, r_mem)
    p_stream = float(res.restored.pixels.max())
    p_mem = float(mem[2].pixels.max())
    assert abs(p_stream - p_mem) < peak_tol, (p_stream, p_mem)
    return r_stream, r_mem, p_stream


def test_mfs_matches_in_memory_ical(tmp_path):
    """A 3-channel store imaged MFS (one image channel) against the port's
    in-memory fused ``ical`` on the same visibilities (JAX
    test_streaming_wide.py test_mfs_multichannel)."""
    corrupted, _ = _source_vis(np.random.default_rng(20260413), nchan=3)
    path = str(tmp_path / "mfs.svis")
    jax_write_visibility(corrupted, path, chunk_times=2)
    pvis = interop.to_visibility(corrupted, device=CPU)
    model = port_create_image_from_visibility(pvis, npixel=64, oversampling=4.0, nchan=1)
    res = streamed_ical(path, model, PC, chunk_times=2, calibration_context="T", **CLEAN_KW)
    mem = ical(pvis, model, calibration_context="T", context="ng", **CLEAN_KW)
    _, _, peak = _assert_match(res, mem)
    assert abs(peak - 1.5) < 0.2, peak
    assert tuple(res.model.pixels.shape) == (1, 1, 64, 64)


def test_matrix_term_matches_in_memory_ical(tmp_path):
    """A full-Jones "matrix" "T" at npol 4 with 6% leakage and in-stream
    components, no CLEAN (JAX test_streaming_wide.py
    test_streamed_matrix_matches_memory): the Mueller correction of the
    slab leg against the in-memory fused cycle's."""
    rng = np.random.default_rng(20260414)
    vis = make_visibility(
        nants=8, ntimes=4, nchan=1, rmax=300.0, phasecentre=PC, polarisation_frame="linear"
    )
    model = create_image_from_visibility(
        vis, npixel=64, oversampling=4.0, nchan=1, polarisation_frame="linear"
    )
    ra, dec = model.pixel_to_radec(37, 28)
    comps = SkyComponents.from_lists(
        [[float(ra), float(dec)]], np.asarray([[[2.0, 0.3, 0.15, 0.0]]]), vis.frequency,
        polarisation_frame="stokesIQUV",
    )
    vis = dft_skycomponent_visibility(vis, comps)
    gt = _simulate_gaintable(
        create_gaintable_from_visibility(vis, "T"), rng, phase_error=0.2, amplitude_error=0.05
    )
    g = np.array(gt.gain)
    leak = 0.06 * (rng.normal(size=g[..., 0, 1].shape) + 1j * rng.normal(size=g[..., 0, 1].shape))
    g[..., 0, 1] = leak
    g[..., 1, 0] = np.conj(leak) * 0.5
    corrupted = apply_gaintable(vis, gt.replace(gain=g))
    controls = create_calibration_controls()
    controls["T"] = dict(controls["T"], shape="matrix", phase_only=False)
    path = str(tmp_path / "fj.svis")
    jax_write_visibility(corrupted, path, chunk_times=2)
    pmodel = interop.to_image(model, device=CPU)
    pcomps = interop.to_skycomponents(comps, device=CPU)
    kw = dict(nmajor=2, algorithm="hogbom", niter=0, gain=0.2, fractional_threshold=0.01)
    res = streamed_ical(
        path, pmodel, PC, chunk_times=2, calibration_context="T", controls=controls,
        components=pcomps, normalise_gains="mean", **kw,
    )
    mem = ical(
        interop.to_visibility(corrupted, device=CPU), pmodel, components=pcomps,
        calibration_context="T", controls=controls, context="ng", fused=True, **kw,
    )
    r_stream, r_mem, _ = _assert_match(res, mem)
    assert abs(r_stream - r_mem) < 1e-3, (r_stream, r_mem)
    assert tuple(res.gaintable.gain.shape[-2:]) == (2, 2)


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """The npol-1 observation of JAX test_streaming_wide.py (8 stations, 6
    integrations, 64^2, 1.5 Jy): (store path, port model)."""
    corrupted, model = _source_vis(np.random.default_rng(20260415))
    path = str(tmp_path_factory.mktemp("small") / "small.svis")
    jax_write_visibility(corrupted, path, chunk_times=2)
    return path, interop.to_image(model, device=CPU)


def test_cached_equals_uncached(small_store):
    """``cache_slabs=False`` (re-reading the store every cycle) gives what
    the cached run gives, exactly."""
    path, model = small_store
    kw = dict(chunk_times=2, calibration_context="T", **CLEAN_KW)
    cached = streamed_ical(path, model, PC, cache_slabs=True, **kw)
    streamed = streamed_ical(path, model, PC, cache_slabs=False, **kw)
    for a, b in ((cached.model, streamed.model), (cached.residual, streamed.residual)):
        np.testing.assert_array_equal(_np(a.pixels), _np(b.pixels))
    np.testing.assert_array_equal(_np(cached.gaintable.gain), _np(streamed.gaintable.gain))


def test_single_integration_slab_keeps_the_store_interval(small_store):
    """A last slab of one integration (ntime % chunk_times == 1): every row
    of the merged "T" table sits at a stored time; the first slab's
    intervals are its time spacing, the last repeated, and the single
    integration's is its spacing to the one before it, not 1 s."""
    path, model = small_store
    res = streamed_ical(path, model, PC, nmajor=1, chunk_times=5, calibration_context="T",
                        algorithm="hogbom", niter=10)
    with VisStore(path) as store:
        times = np.asarray(store.time)
    assert times.size % 5 == 1
    dt = np.diff(times)
    np.testing.assert_array_equal(_np(res.gaintable.time), times)
    np.testing.assert_array_equal(_np(res.gaintable.interval), [*dt[:4], dt[3], dt[4]])


def test_f16_wire_matches_f32(small_store):
    path, model = small_store
    kw = dict(chunk_times=2, calibration_context="T", **CLEAN_KW)
    r32 = streamed_ical(path, model, PC, **kw)
    r16 = streamed_ical(path, model, PC, wire_dtype="f16", **kw)
    a, b = _np(r32.residual.pixels), _np(r16.residual.pixels)
    assert np.max(np.abs(a - b)) < 5e-3 * np.max(np.abs(a)), np.max(np.abs(a - b))
    p32, p16 = float(r32.restored.pixels.max()), float(r16.restored.pixels.max())
    assert abs(p32 - p16) < 5e-3 * max(abs(p32), 1.0), (p32, p16)


def test_uvw_compute_at_mjd_epochs_matches_store(tmp_path):
    """A store whose times are MJD seconds (5.1e9 s plus the hour angles'
    seconds): ``uvw_compute`` gets each slab's times as f64 on the model's
    device, exactly as stored, and its earth-rotation uvw, computed from
    epoch-relative hour angles, gives the store-uvw run's images."""
    nants, epoch, dec = 8, 5.1e9, PC[1]
    ants = random_array_xyz(nants, rmax=300.0, seed=42)
    a1, a2 = np.triu_indices(nants, 1)
    has = np.linspace(-np.pi / 12, np.pi / 12, 6)
    uvw = np.stack([xyz_to_uvw(ants[a2] - ants[a1], ha, dec) for ha in has])
    times = epoch + has * SIDEREAL_DAY / (2 * np.pi)
    rng = np.random.default_rng(20260416)
    g = np.exp(1j * rng.normal(0, 0.3, (6, nants)))
    vis = (1.5 * g[:, a1] * np.conj(g[:, a2]))[:, :, None, None]
    path = str(tmp_path / "mjd.svis")
    write_visibility_arrays(
        path, uvw=uvw, time=times, frequency=np.asarray([1.0e8]), antenna1=a1,
        antenna2=a2, vis=vis.astype(np.complex64), chunk_times=2,
    )
    blines = torch.as_tensor(ants[a2] - ants[a1], dtype=torch.float64)
    seen = []

    def geometry(t):
        seen.append(t)
        # utils.coordinates.xyz_to_uvw in torch f64
        ha = (t - epoch) * (2 * np.pi / SIDEREAL_DAY)
        ch, sh = torch.cos(ha)[:, None], torch.sin(ha)[:, None]
        x, y, z = blines[:, 0], blines[:, 1], blines[:, 2]
        v0 = x * sh + y * ch
        u = x * ch - y * sh
        return torch.stack(
            [u, z * np.cos(dec) + v0 * np.sin(dec), z * np.sin(dec) - v0 * np.cos(dec)], dim=-1
        )

    model = create_image_from_visibility(
        make_visibility(nants=nants, ntimes=6, nchan=1, rmax=300.0, phasecentre=PC),
        npixel=64, oversampling=4.0, nchan=1,
    )
    pmodel = interop.to_image(model, device=CPU)
    kw = dict(chunk_times=2, calibration_context="T", **CLEAN_KW)
    r_store = streamed_ical(path, pmodel, PC, **kw)
    r_geom = streamed_ical(path, pmodel, PC, uvw_compute=geometry, **kw)
    got = torch.cat(seen[:3])
    assert got.dtype == torch.float64 and got.device == pmodel.pixels.device
    np.testing.assert_array_equal(got.numpy(), times)
    np.testing.assert_allclose(torch.cat([geometry(t) for t in seen[:3]]).numpy(), uvw,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(r_geom.restored.pixels), _np(r_store.restored.pixels),
                               rtol=0, atol=1e-6)
    assert np.unique(_np(r_store.gaintable.time)).size == 6


def test_warm_start_continues(small_store):
    """``model_init``: 2 + 2 warm-started cycles converge at least as well
    as 2 cold cycles and near a 4-cycle run (JAX
    test_streamed_warm_start_continues)."""
    path, model = small_store
    kw = dict(chunk_times=2, calibration_context="T", algorithm="hogbom", niter=150,
              gain=0.2, fractional_threshold=0.01)
    c2, r2, _, _ = streamed_ical(path, model, PC, nmajor=2, **kw)
    _, r4, _, _ = streamed_ical(path, model, PC, nmajor=4, **kw)
    _, rw, _, _ = streamed_ical(path, model, PC, nmajor=2, model_init=c2, **kw)
    p2, p4, pw = (float(r.pixels.abs().max()) for r in (r2, r4, rw))
    assert pw <= p2 * 1.01, (pw, p2)
    assert pw <= max(2.0 * p4, 0.05), (pw, p4)


def test_refusals(small_store):
    """A model whose npol or nchan the store does not have raises; so does
    a model built without a device when there is no card."""
    path, model = small_store
    pol = model.replace(
        pixels=model.pixels.expand(1, 4, -1, -1).clone(), polarisation_frame="linear"
    )
    with pytest.raises(ValueError, match="npol"):
        streamed_ical(path, pol, PC, nmajor=1, chunk_times=2)
    chans = model.replace(pixels=model.pixels.expand(2, 1, -1, -1).clone())
    with pytest.raises(ValueError, match="nchan"):
        streamed_ical(path, chans, PC, nmajor=1, chunk_times=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: models are made on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_image(64, model.cellsize, PC)


_TWO_RANKS = """
import sys
import numpy as np
import torch.distributed as dist
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.models import create_image
from ska_sdp_func_python_torch.streaming import streamed_ical
path, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
model = create_image(64, 1e-3, (0.0, np.deg2rad(-35.0)), device="cpu")
try:
    streamed_ical(path, model, model.phasecentre, nmajor=1, chunk_times=2)
except NotImplementedError as e:
    print(e)
finally:
    dist.destroy_process_group()
"""


def test_multi_process_run_raises_s13(small_store):
    """In a ``torch.distributed`` run of two processes (gloo on the CPU)
    ``streamed_ical`` refuses with the slice that brings the multi-process
    leg; ``distribute=False`` in one process streams every slab."""
    import socket
    import subprocess
    import sys

    path, model = small_store
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", _TWO_RANKS, path, port, str(rank)],
                         cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)
    ]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "S13" in out, (out, err)
    res = streamed_ical(path, model, PC, nmajor=1, chunk_times=2, distribute=False)
    assert res.gaintable.gain.shape[0] == 6
