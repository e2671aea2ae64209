"""The port's parallel layer (``ska_sdp_func_python_torch.parallel``) on
4 and 8 CPU shards in one process, against the JAX package's
single-device functions, its ``sharded_ical`` and the port's own
single-device ``ical`` (which the other port tests hold to the JAX
package).

Bounds, the JAX package's between its sharded and single-device runs
(tests/test_parallel.py): distributed invert, predict and solve 1e-10
(f64 on both sides); baseline-sharded self-cal phase-referenced gains
1e-4, peak residuals 1e-2, restored peaks 0.05; full Jones gains 1e-5
and peak residuals 1e-3; the channel-sharded cube 2e-3 in residual and
model. The scattered invert tail is held to the replicated one at 1e-6
of the image maximum, and a one-shard mesh to ``ical`` bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.models import (
    SkyComponents,
    create_gaintable_from_visibility,
)
from ska_sdp_func_python_tpu.ops import (
    apply_gaintable,
    create_image_from_visibility,
    dft_skycomponent_visibility,
    invert_visibility,
    predict_visibility,
    solve_gaintable,
)
from ska_sdp_func_python_tpu.parallel import make_mesh as jax_make_mesh
from ska_sdp_func_python_tpu.parallel import sharded_ical as jax_sharded_ical
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops import create_calibration_controls
from ska_sdp_func_python_torch.ops.imaging import (
    make_visibility_plan,
    uv_grids_to_dirty,
    uv_grids_to_dirty_scattered,
)
from ska_sdp_func_python_torch.parallel import (
    collectives,
    distributed_ical,
    distributed_invert,
    distributed_predict,
    distributed_solve_gaintable,
    make_mesh,
    redistribute_visibility,
    sharded_ical,
)
from ska_sdp_func_python_torch.parallel.mesh import Sharded
from ska_sdp_func_python_torch.pipeline import ical

from simul import make_visibility
from test_solvers import _simulate_gaintable

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
HOGBOM = dict(calibration_context="T", algorithm="hogbom", niter=200, gain=0.2,
              fractional_threshold=0.01)


def _mesh(n):
    return make_mesh(shape=(n,), devices=["cpu"])


def _obs(seed, npixel=128, corrupt=0.3):
    """JAX tests/test_parallel.py's ``_obs``: 10 stations, 4 times, a
    1.3 Jy source off centre; the visibility corrupted by "T" phases."""
    rng = np.random.default_rng(seed)
    vis = make_visibility(nants=10, ntimes=4, nchan=1, rmax=300.0, phasecentre=PC)
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=4.0, nchan=1)
    ra, dec = model.pixel_to_radec(npixel // 2 + 9, npixel // 2 - 6)
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], [[[1.3]]], vis.frequency)
    vis = dft_skycomponent_visibility(vis, comps)
    corrupted = vis
    if corrupt:
        gt = create_gaintable_from_visibility(vis, jones_type="T")
        corrupted = apply_gaintable(vis, _simulate_gaintable(gt, rng, phase_error=corrupt))
    return vis, corrupted, model


def _port(vis, model):
    return interop.to_visibility(vis, device=CPU), interop.to_image(model, device=CPU)


def _referenced(g):
    g = np.asarray(g)[..., 0, 0]
    return g * np.exp(-1j * np.angle(g[:, :1]))


def _agree(a, b, gain_tol=1e-4, res_tol=1e-2, restored_tol=0.05):
    """(model, residual, restored, gaintables) of two self-cal runs within
    the JAX package's sharded-vs-single-device bounds."""
    ga, gb = (_referenced(np.asarray(x[3]["T"].gain)) for x in (a, b))
    assert np.max(np.abs(ga - gb)) < gain_tol, np.max(np.abs(ga - gb))
    ra, rb = (float(np.max(np.abs(np.asarray(x[1].pixels)))) for x in (a, b))
    assert ra < 0.2 and abs(ra - rb) < res_tol, (ra, rb)
    sa, sb = (float(np.max(np.asarray(x[2].pixels))) for x in (a, b))
    assert abs(sa - sb) < restored_tol, (sa, sb)


@pytest.fixture(scope="module")
def small():
    """The 64^2 observation of the JAX reference run and the sharded
    self-cal tests."""
    _, corrupted, model = _obs(20261017, npixel=64)
    return corrupted, model


@pytest.fixture(scope="module")
def jax_sharded(small):
    """The JAX package's baseline-sharded ``sharded_ical`` on 4 of the
    conftest's 8 CPU devices, run once."""
    corrupted, model = small
    mesh = jax_make_mesh(shape=(4,), devices=jax.devices()[:4])
    return jax_sharded_ical(corrupted, model, mesh, nmajor=2, context="ng", **HOGBOM)


# ---- collectives ----


def test_collectives_ordered_float_and_exact_int_sums():
    mesh = _mesh(4)
    rng = np.random.default_rng(7)
    parts = [torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32)) for _ in range(4)]
    collectives.reset_collective_counts()
    total = collectives.psum(mesh, parts)
    ordered = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(total, ordered)
    cparts = [torch.complex(p, 2 * p) for p in parts]
    ctotal, ftotal = collectives.psum(mesh, [(c, p) for c, p in zip(cparts, parts)])
    assert torch.equal(ctotal, ((cparts[0] + cparts[1]) + cparts[2]) + cparts[3])
    assert torch.equal(ftotal, ordered)
    ints = [torch.as_tensor(rng.integers(-(2**60), 2**60, size=(8, 2))) for _ in range(4)]
    blocks = collectives.psum_scatter(mesh, ints, dim=0)
    exact = sum(x.numpy().astype(object) for x in ints)
    np.testing.assert_array_equal(torch.cat(blocks).numpy().astype(object), exact)
    assert [b.shape[0] for b in blocks] == [2] * 4
    assert torch.equal(collectives.pmax(mesh, parts), torch.stack(parts).amax(0))
    assert all(torch.equal(a, b) for a, b in zip(collectives.all_gather(mesh, parts), parts))
    counts = collectives.collective_counts()
    assert counts["psum"]["calls"] == 2
    assert counts["psum"]["bytes"] == 15 * 4 + 15 * (8 + 4)
    assert counts["psum_scatter"] == {"calls": 1, "bytes": 2 * 2 * 8, "comm_bytes": 0,
                                      "staged_bytes": 0}
    assert counts["pmax"]["calls"] == counts["all_gather"]["calls"] == 1


def test_mesh_layout_and_refusals():
    mesh = _mesh(8)
    assert mesh.nshards == 8 and mesh.local == tuple(range(8)) and mesh.group is None
    assert mesh.shape == {"data": 8} and not mesh.multiprocess
    with pytest.raises(ValueError, match="one axis"):
        make_mesh(shape=(2, 4), axis_names=("data", "freq"), devices=["cpu"])
    with pytest.raises(ValueError, match="devices"):
        make_mesh(shape=(4,), devices=["cpu", "cpu"])


# ---- the scattered invert tail ----


def test_scattered_tail_pads_the_w_beam_rows():
    """nw 11 over 8 shards: the grids pad to 16 planes and so do the w-beam
    rows. The JAX package pads the grids only, and ``dynamic_slice``
    clamps the last block's start (8 -> 5), so that block's w-beam rows
    shift by the 5 padded planes: its image is 1.7% off (ADVICE.md)."""
    vis, _, model = _obs(5, npixel=64, corrupt=0.0)
    pv, pm = _port(vis, model)
    plan = make_visibility_plan(pv, pm, nw=11).plans[0]
    assert plan.nw == 11
    rng = np.random.default_rng(11)
    shape = (11, plan.npad, plan.npad)
    grids = [
        torch.complex(*(torch.as_tensor(rng.normal(size=shape).astype(np.float32)) for _ in range(2)))
        for _ in range(8)
    ]
    mesh = _mesh(8)
    out = uv_grids_to_dirty_scattered(plan, grids, mesh)
    ref = uv_grids_to_dirty(plan, collectives.psum(mesh, grids))
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err < 1e-6, err


# ---- distributed invert, predict, solve, ical ----


@pytest.fixture(scope="module")
def obs128():
    vis, corrupted, model = _obs(41, corrupt=0.2)
    return vis, corrupted, model


def test_distributed_invert_matches_jax(obs128):
    vis, _, model = obs128
    ref, swt_ref = invert_visibility(vis, model, context="2d", support=8)
    pv, pm = _port(vis, model)
    dist, swt = distributed_invert(pv, pm, _mesh(8), support=8, do_wstacking=False)
    np.testing.assert_allclose(swt.numpy(), np.asarray(swt_ref))
    np.testing.assert_allclose(dist.pixels.numpy(), np.asarray(ref.pixels), atol=1e-10)


def test_distributed_predict_matches_jax(obs128):
    vis, _, model = obs128
    model_img = model.with_pixels(jnp.zeros_like(model.pixels).at[0, 0, 70, 40].set(1.0))
    ref = predict_visibility(vis, model_img, context="2d")
    pv, pm = _port(vis, model_img)
    dist = distributed_predict(pv, pm, _mesh(8))
    np.testing.assert_allclose(dist.vis.numpy(), np.asarray(ref.vis), atol=1e-10)


def test_distributed_solve_matches_jax(obs128):
    vis, corrupted, model = obs128
    ref = solve_gaintable(corrupted, vis, phase_only=True, jones_type="T")
    pc, _ = _port(corrupted, model)
    pv, _ = _port(vis, model)
    dist = distributed_solve_gaintable(pc, pv, _mesh(8), phase_only=True, jones_type="T")
    np.testing.assert_allclose(dist.gain.numpy(), np.asarray(ref.gain), atol=1e-10)
    np.testing.assert_allclose(dist.residual.numpy(), np.asarray(ref.residual), atol=1e-10)


def test_distributed_ical_recovers(obs128):
    _, corrupted, model = obs128
    pc, pm = _port(corrupted, model)
    _, residual, restored, _ = distributed_ical(
        pc, pm, _mesh(8), nmajor=3, algorithm="hogbom", niter=200, gain=0.2,
        fractional_threshold=0.01,
    )
    assert float(residual.pixels.abs().max()) < 0.2
    assert abs(float(restored.pixels.max()) - 1.3) < 0.15


# ---- sharded_ical ----


def test_one_shard_mesh_equals_ical_bit_for_bit(small):
    pv, pm = _port(*small)
    a = ical(pv, pm, nmajor=2, **HOGBOM)
    b = sharded_ical(pv, pm, _mesh(1), nmajor=2, **HOGBOM)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.pixels, y.pixels)
    assert torch.equal(a[3]["T"].gain, b[3]["T"].gain)


def test_baseline_sharded_matches_jax_sharded(small, jax_sharded):
    pv, pm = _port(*small)
    out = sharded_ical(pv, pm, _mesh(4), nmajor=2, **HOGBOM)
    _agree(jax_sharded, out)


@pytest.mark.parametrize("algorithm", ["hogbom", "msclean"])
def test_baseline_sharded_matches_ical(small, algorithm):
    """8 shards of 45 baselines (3 padded ones)."""
    pv, pm = _port(*small)
    kw = dict(HOGBOM, algorithm=algorithm, nmajor=3)
    collectives.reset_collective_counts()
    out = sharded_ical(pv, pm, _mesh(8), **kw)
    assert collectives.collective_counts()["psum_scatter"]["calls"] == 4  # PSF + 3 cycles
    _agree(ical(pv, pm, **kw), out)


def test_collective_audit_of_one_cycle(small):
    """JAX TestCollectiveAudit in the port's form: per cycle one normal
    equations psum, one psum of the sums of weights (with the grid
    bound's), ONE reduce-scatter of the w-plane grids (their blocks of
    nw_pad / 8 planes; the plain version's complex64 sums here, K1's
    int64 planes on the card, 16 bytes a cell) and one npixel^2 f32
    image psum; nothing else."""
    pv, pm = _port(*small)
    record = []
    sharded_ical(pv, pm, _mesh(8), nmajor=1, hlo_out=record, **dict(HOGBOM, niter=20))
    ops = [op for op, _, _ in record[0]]
    assert ops.count("psum_scatter") == 1, record
    assert ops.count("psum") == len(ops) - 1 <= 4, record
    plan = make_visibility_plan(pv, pm).plans[0]
    nw_pad = -(-plan.nw // 8) * 8
    rs = [r for r in record[0] if r[0] == "psum_scatter"][0]
    assert rs[2] == (nw_pad // 8) * plan.npad**2 * 8, (rs, plan.nw, plan.npad)
    assert ("psum", ("float32",), pm.npixel**2 * 4) in record[0], record


def test_full_jones_sharded_matches_ical():
    """JAX TestShardedFullJones: a "matrix" T with leakage on 4 shards."""
    rng = np.random.default_rng(12)
    vis = make_visibility(nants=10, ntimes=3, nchan=1, rmax=300.0, phasecentre=PC,
                          polarisation_frame="linear")
    model = create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=1,
                                         polarisation_frame="linear")
    ra, dec = model.pixel_to_radec(37, 28)
    comps = SkyComponents.from_lists([[float(ra), float(dec)]],
                                     np.asarray([[[2.0, 0.3, 0.15, 0.0]]]), vis.frequency,
                                     polarisation_frame="stokesIQUV")
    vis = dft_skycomponent_visibility(vis, comps)
    gt = _simulate_gaintable(create_gaintable_from_visibility(vis, jones_type="T"), rng,
                             phase_error=0.2, amplitude_error=0.05)
    g = np.array(gt.gain)
    leak = 0.06 * (rng.normal(size=g[..., 0, 1].shape) + 1j * rng.normal(size=g[..., 0, 1].shape))
    g[..., 0, 1], g[..., 1, 0] = leak, np.conj(leak) * 0.5
    corrupted = apply_gaintable(vis, gt.replace(gain=jnp.asarray(g)))
    pv, pm = _port(corrupted, model)
    controls = create_calibration_controls()
    controls["T"] = dict(controls["T"], shape="matrix", phase_only=False)
    kw = dict(nmajor=2, calibration_context="T", controls=controls,
              components=interop.to_skycomponents(comps, device=CPU), algorithm="hogbom",
              niter=100, gain=0.2, fractional_threshold=0.01)
    a = ical(pv, pm, **kw)
    b = sharded_ical(pv, pm, _mesh(4), **kw)
    dg = np.max(np.abs(a[3]["T"].gain.numpy() - b[3]["T"].gain.numpy()))
    assert dg < 1e-5, dg
    ra, rb = (float(x[1].pixels.abs().max()) for x in (a, b))
    assert abs(ra - rb) < 1e-3, (ra, rb)


@pytest.fixture(scope="module")
def cube():
    """JAX TestDistributedSelfcal._cube_obs: 8 stations, 3 times, 8
    channels, a 2.0 Jy source of index -0.7, "T" phases 0.3."""
    rng = np.random.default_rng(13)
    vis = make_visibility(nants=8, ntimes=3, nchan=8, rmax=300.0, phasecentre=PC)
    model = create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=8)
    ra, dec = model.pixel_to_radec(32 + 7, 32 - 5)
    flux = 2.0 * (np.asarray(vis.frequency) / 1.0e8) ** -0.7
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], flux[None, :, None], vis.frequency)
    vis = dft_skycomponent_visibility(vis, comps)
    gt = _simulate_gaintable(create_gaintable_from_visibility(vis, jones_type="T"), rng,
                             phase_error=0.3)
    return _port(apply_gaintable(vis, gt), model)


@pytest.mark.parametrize("clean", [
    dict(nmajor=3, algorithm="hogbom", niter=150, gain=0.2, fractional_threshold=0.01),
    dict(nmajor=2, algorithm="mmclean", nmoment=2, niter=100, gain=0.2, scales=[0, 3],
         fractional_threshold=0.01),
], ids=["hogbom", "mmclean"])
def test_channel_sharded_cube_matches_ical(cube, clean):
    pv, pm = cube
    a = ical(pv, pm, calibration_context="T", **clean)
    b = sharded_ical(pv, pm, _mesh(4), shard="channel", calibration_context="T", **clean)
    ga, gb = _referenced(a[3]["T"].gain), _referenced(b[3]["T"].gain)
    assert np.max(np.abs(ga - gb)) < 1e-4
    assert float(b[1].pixels.abs().max()) < 0.4
    np.testing.assert_allclose(b[1].pixels.numpy(), a[1].pixels.numpy(), atol=2e-3)
    np.testing.assert_allclose(b[0].pixels.numpy(), a[0].pixels.numpy(), atol=2e-3)


@pytest.mark.parametrize("case, match", [
    (dict(shard="diagonal"), "unknown shard axis"),
    (dict(window_shape="quarter", algorithm="hogbom-complex"), "windowed"),
    (dict(shard="channel", calibration_context="B"), "bandpass"),
    (dict(shard="channel", nchan=6), "not divisible"),
    (dict(shard="channel", mfs=True), "cube mode"),
    (dict(matrix=True, shard="channel"), "full-Jones"),
])
def test_sharded_ical_refusals(cube, case, match):
    pv, pm = cube
    case = dict(case)
    if case.pop("mfs", False):
        pm = pm.replace(pixels=pm.pixels[:1], frequency=pm.frequency[:1],
                        channel_bandwidth=pm.channel_bandwidth[:1])
    nchan = case.pop("nchan", None)
    if nchan:
        pv = pv.replace(vis=pv.vis[:, :, :nchan], weight=pv.weight[:, :, :nchan],
                        imaging_weight=pv.imaging_weight[:, :, :nchan],
                        flags=pv.flags[:, :, :nchan], frequency=pv.frequency[:nchan],
                        channel_bandwidth=pv.channel_bandwidth[:nchan])
        pm = pm.replace(pixels=pm.pixels[:nchan], frequency=pm.frequency[:nchan],
                        channel_bandwidth=pm.channel_bandwidth[:nchan])
    if case.pop("matrix", False):
        controls = create_calibration_controls()
        controls["T"] = dict(controls["T"], shape="matrix")
        case["controls"] = controls
    with pytest.raises(ValueError, match=match):
        sharded_ical(pv, pm, _mesh(4), nmajor=1, **case)


# ---- redistribute ----


def test_redistribute_round_trip(obs128):
    """Baseline-sharded -> time-sharded -> back: values unchanged bit for
    bit, the requested dimension split (JAX TestRedistribute)."""
    vis, _, model = obs128
    pv, _ = _port(vis, model)
    nt, nbl = pv.ntimes, pv.nbaselines
    padt, padb = (-nt) % 8, (-nbl) % 8

    def pad2(x):
        x = torch.cat([x, torch.zeros((padt,) + x.shape[1:], dtype=x.dtype)])
        return torch.cat([x, torch.zeros((x.shape[0], padb) + x.shape[2:], dtype=x.dtype)], dim=1)

    pv = pv.replace(
        vis=pad2(pv.vis), weight=pad2(pv.weight), imaging_weight=pad2(pv.imaging_weight),
        flags=pad2(pv.flags), uvw=pad2(pv.uvw),
        time=torch.cat([pv.time, torch.zeros(padt, dtype=pv.time.dtype)]),
        integration_time=torch.cat([pv.integration_time, torch.zeros(padt, dtype=pv.time.dtype)]),
        antenna1=torch.cat([pv.antenna1, torch.zeros(padb, dtype=pv.antenna1.dtype)]),
        antenna2=torch.cat([pv.antenna2, torch.zeros(padb, dtype=pv.antenna2.dtype)]),
    )
    mesh = _mesh(8)
    bl = redistribute_visibility(pv, mesh, to="baseline")
    assert isinstance(bl.vis, Sharded) and bl.vis.dim == 1 and bl.time.dim is None
    assert bl.vis.pieces[0].shape[1] == pv.nbaselines // 8
    t = redistribute_visibility(bl, mesh, to="time")
    assert t.vis.dim == 0 and t.vis.pieces[0].shape[0] == pv.ntimes // 8
    for name in ("vis", "uvw", "weight", "flags", "time", "antenna1"):
        assert torch.equal(getattr(t, name).gather(), getattr(pv, name)), name
