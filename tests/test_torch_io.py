"""The port's native visibility store and gain-solution files against the
JAX package's (files pass both ways, byte for byte and value for value),
``SelfCalState``'s gain files, the port's f64 time axis at MJD-second
epochs, and the port's public namespaces against the JAX package's.

Tolerances: store files are byte-identical and read back exactly (the
visibilities as the f32 the store holds); gain files pass exactly
(``.npz`` and HDF5), the h5parm export to the JAX package's own
round-trip bounds (1e-5 relative, 1e-6 absolute: gains pass as f32
amplitude and phase); times and intervals equal.
"""

import inspect

import numpy as np
import pytest
import torch

import ska_sdp_func_python_tpu.io as jax_io
import ska_sdp_func_python_tpu.models as jax_models
import ska_sdp_func_python_tpu.ops as jax_ops
import ska_sdp_func_python_tpu.parallel as jax_parallel
import ska_sdp_func_python_tpu.pipeline as jax_pipeline
import ska_sdp_func_python_tpu.utils as jax_utils
from ska_sdp_func_python_tpu.models import (
    create_gaintable_from_visibility as jax_create_gaintable,
    create_visibility_from_arrays as jax_create_visibility,
)
import ska_sdp_func_python_torch as port
from ska_sdp_func_python_torch import config, interop
from ska_sdp_func_python_torch.io import (
    VisStore,
    export_h5parm,
    import_h5parm,
    load_gaintable,
    load_gaintables,
    save_gaintable,
    save_gaintables,
    stream_visibility_chunks,
    write_visibility,
    write_visibility_arrays,
)
from ska_sdp_func_python_torch.models import (
    create_gaintable_from_visibility,
    create_image,
    create_visibility_from_arrays,
)
from ska_sdp_func_python_torch.pipeline import SelfCalState

from simul import make_visibility

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def observation():
    """The JAX store test's observation (6 stations, 10 integrations, 3
    channels) with random visibilities and weights, and one flag."""
    rng = np.random.default_rng(20260410)
    vis = make_visibility(nants=6, ntimes=10, nchan=3)
    shape = vis.vis.shape
    data = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    weight = rng.uniform(0.5, 2.0, size=shape)
    flags = np.zeros(shape, np.int32)
    flags[3, 2, 1, 0] = 1
    return vis.replace(vis=vis.vis + data, weight=weight, flags=flags)


@pytest.fixture(scope="module")
def stores(observation, tmp_path_factory):
    """The observation written by each package: {"jax": path, "port": path}."""
    root = tmp_path_factory.mktemp("stores")
    paths = {"jax": str(root / "jax.svis"), "port": str(root / "port.svis")}
    jax_io.write_visibility(observation, paths["jax"], chunk_times=4)
    write_visibility(interop.to_visibility(observation, device=CPU), paths["port"], chunk_times=4)
    return paths


def test_writers_give_identical_files(stores, observation, tmp_path):
    with open(stores["jax"], "rb") as a, open(stores["port"], "rb") as b:
        assert a.read() == b.read()
    # write_visibility_arrays (raw arrays, default weights and flags)
    o = observation
    args = dict(
        uvw=np.asarray(o.uvw), time=np.asarray(o.time), frequency=np.asarray(o.frequency),
        antenna1=np.asarray(o.antenna1), antenna2=np.asarray(o.antenna2),
        vis=np.asarray(o.vis).astype(np.complex64), chunk_times=3,
    )
    jax_io.write_visibility_arrays(str(tmp_path / "a.svis"), **args)
    write_visibility_arrays(str(tmp_path / "b.svis"), **args)
    assert (tmp_path / "a.svis").read_bytes() == (tmp_path / "b.svis").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_chunk_matches_observation(stores, observation, writer):
    """The port's reader on either package's file (JAX tests/test_io.py
    TestVisStore.test_roundtrip_sync), with the memory-mapped uvw."""
    o = observation
    with VisStore(stores[writer]) as store:
        assert (store.ntime, store.nbl, store.nchan, store.npol) == (10, 15, 3, 1)
        np.testing.assert_array_equal(store.frequency, np.asarray(o.frequency))
        np.testing.assert_array_equal(store.time, np.asarray(o.time))
        np.testing.assert_array_equal(store.antenna1, np.asarray(o.antenna1))
        np.testing.assert_array_equal(store.uvw, np.asarray(o.uvw))
        assert isinstance(store.uvw, np.memmap)
        re, im, wt, fl = store.read_chunk(2, 3)
        v = np.asarray(o.vis)[2:5]
        np.testing.assert_array_equal(re, np.real(v).astype(np.float32))
        np.testing.assert_array_equal(im, np.imag(v).astype(np.float32))
        np.testing.assert_array_equal(wt, np.asarray(o.weight)[2:5].astype(np.float32))
        np.testing.assert_array_equal(fl, np.asarray(o.flags)[2:5].astype(np.uint8))
        assert fl.sum() == 1


def test_prefetch_wait_and_jax_reader(stores, observation):
    """``prefetch``/``wait`` give what ``read_chunk`` gives, and the JAX
    package's reader reads the port's file as it reads its own."""
    with VisStore(stores["port"]) as store:
        store.prefetch(7, 3)
        got = store.wait(3)
        for a, b in zip(got, store.read_chunk(7, 3)):
            np.testing.assert_array_equal(a, b)
    with jax_io.VisStore(stores["port"]) as jstore, VisStore(stores["jax"]) as pstore:
        for a, b in zip(jstore.read_chunk(0, 10), pstore.read_chunk(0, 10)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(jstore.uvw), np.asarray(pstore.uvw))


def test_stream_visibility_chunks(stores, observation):
    """JAX tests/test_io.py TestVisStore.test_streaming_prefetch, and every
    field of every chunk against the JAX package's generator."""
    chunks = list(stream_visibility_chunks(stores["port"], chunk_times=4))
    assert [c["t0"] for c in chunks] == [0, 4, 8]
    got = np.concatenate([c["vis_re"] for c in chunks])
    np.testing.assert_array_equal(got, np.real(np.asarray(observation.vis)).astype(np.float32))
    ref = list(jax_io.stream_visibility_chunks(stores["jax"], chunk_times=4))
    for a, b in zip(chunks, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.fixture(scope="module")
def jax_tables():
    """JAX tests/test_io.py TestH5parm's tables: "T" with random phases
    (per integration, 5 stations) and "G" with random amplitudes (one
    interval), from an observation of 2 channels."""
    rng = np.random.default_rng(20260411)
    vis = make_visibility(nants=5, ntimes=6, nchan=2)
    gt_t = jax_create_gaintable(vis, jones_type="T")
    g = np.asarray(gt_t.gain) * np.exp(1j * rng.normal(size=gt_t.gain.shape))
    gt_t = gt_t.replace(gain=g.astype(np.complex64))
    gt_g = jax_create_gaintable(vis, jones_type="G", timeslice=1e15)
    g2 = np.asarray(gt_g.gain) * (1.0 + 0.1 * rng.normal(size=gt_g.gain.shape))
    gt_g = gt_g.replace(gain=g2.astype(np.complex64))
    return {"T": gt_t, "G": gt_g}


def _same_tables(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        for f in ("gain", "weight", "residual", "time", "interval", "frequency"):
            np.testing.assert_array_equal(_np(getattr(a[k], f)), _np(getattr(b[k], f)))
        assert a[k].jones_type == b[k].jones_type
        assert a[k].receptor_frame == b[k].receptor_frame


@pytest.mark.parametrize("ext", ["npz", "h5"])
def test_gain_files_pass_both_ways(jax_tables, tmp_path, ext):
    if ext == "h5":
        pytest.importorskip("h5py")
    ptables = {k: interop.to_gaintable(v, device=CPU) for k, v in jax_tables.items()}
    jpath, ppath = str(tmp_path / f"j.{ext}"), str(tmp_path / f"p.{ext}")
    jax_io.save_gaintables(jax_tables, jpath)
    save_gaintables(ptables, ppath)
    from_jax = load_gaintables(jpath, device=CPU)
    from_port = jax_io.load_gaintables(ppath)
    _same_tables(from_jax, ptables)
    _same_tables(from_port, jax_tables)
    assert from_jax["T"].time.dtype == torch.float64
    # one table, as an h5parm-style single solset
    save_gaintable(ptables["T"], str(tmp_path / f"one.{ext}"))
    _same_tables({"T": jax_io.load_gaintable(str(tmp_path / f"one.{ext}"))}, {"T": jax_tables["T"]})
    _same_tables({"T": load_gaintable(jpath, name="T", device=CPU)}, {"T": ptables["T"]})
    with pytest.raises(ValueError, match="name="):
        load_gaintable(jpath, device=CPU)


def test_h5parm_passes_both_ways(jax_tables, tmp_path):
    """export_h5parm/import_h5parm across the packages, scalar and full
    Jones (JAX tests/test_io.py TestH5parm)."""
    pytest.importorskip("h5py")
    ptables = {k: interop.to_gaintable(v, device=CPU) for k, v in jax_tables.items()}
    nt, na, nf = 3, 4, 1
    g = np.tile(np.eye(2, dtype=np.complex64), (nt, na, nf, 1, 1))
    g[..., 0, 1] = 0.1 + 0.05j
    g[..., 1, 0] = -0.07j
    fj = jax_models.GainTable(
        gain=g, weight=np.ones_like(g, np.float32),
        residual=np.zeros((nt, nf, 2, 2), np.float32), time=np.arange(nt) * 10.0,
        interval=np.full(nt, 10.0), frequency=np.asarray([1.0e8]), jones_type="G",
    )
    for tables, ptabs in ((jax_tables, ptables), ({"G": fj}, {"G": interop.to_gaintable(fj, device=CPU)})):
        jpath, ppath = str(tmp_path / "j.h5parm"), str(tmp_path / "p.h5parm")
        jax_io.export_h5parm(tables, jpath)
        export_h5parm(ptabs, ppath)
        from_jax = import_h5parm(jpath, device=CPU)
        from_port = jax_io.import_h5parm(ppath)
        assert sorted(from_jax) == sorted(from_port) == sorted(tables)
        for k in tables:
            for back in (from_jax[k], from_port[k]):
                np.testing.assert_allclose(
                    _np(back.gain), np.asarray(tables[k].gain).astype(np.complex64),
                    rtol=1e-5, atol=1e-6,
                )
                np.testing.assert_array_equal(_np(back.time), np.asarray(tables[k].time))
            for f in ("gain", "weight", "residual", "time", "interval", "frequency"):
                np.testing.assert_array_equal(
                    _np(getattr(from_jax[k], f)), np.asarray(getattr(from_port[k], f))
                )


def test_selfcal_state_gain_files(jax_tables, tmp_path):
    """``export_gaintables``/``import_gaintables`` (JAX tests/test_io.py
    TestGainIO.test_single_table_and_state), and the JAX package's state
    reads the port's file."""
    ptables = {k: interop.to_gaintable(v, device=CPU) for k, v in jax_tables.items()}
    model = create_image(32, 1e-4, (np.deg2rad(15.0), np.deg2rad(-45.0)), device=CPU)
    state = SelfCalState(model=model, gaintables=ptables, cycle=2)
    path = str(tmp_path / "state_sols.npz")
    state.export_gaintables(path)
    back = SelfCalState.import_gaintables(model, path, cycle=2)
    assert back.cycle == 2 and back.model is model
    _same_tables(back.gaintables, ptables)
    assert back.gaintables["T"].gain.device == model.pixels.device
    jstate = jax_pipeline.SelfCalState.import_gaintables(None, path, cycle=2)
    _same_tables(jstate.gaintables, jax_tables)


def test_mjd_second_times_match_jax():
    """8 integrations of 10 s at MJD-second epochs (5.1e9 s): the port's
    f32 Visibility keeps every integration, its integration times and its
    gaintables' rows and intervals, as the JAX package under x64 does."""
    rng = np.random.default_rng(3)
    times = 5.1e9 + 10.0 * np.arange(8)
    uvw = rng.normal(0, 100.0, (8, 3, 3))
    args = dict(uvw=uvw, time=times, frequency=np.asarray([1e8, 1.1e8]),
                antenna1=np.asarray([0, 0, 1]), antenna2=np.asarray([1, 2, 2]))
    jvis = jax_create_visibility(**args)
    pvis = create_visibility_from_arrays(**args, device=CPU)
    assert pvis.vis.dtype == torch.complex64
    assert pvis.time.dtype == pvis.integration_time.dtype == torch.float64
    np.testing.assert_array_equal(_np(pvis.time), times)
    np.testing.assert_array_equal(_np(pvis.integration_time), np.asarray(jvis.integration_time))
    assert np.unique(_np(pvis.time)).size == 8
    for jones_type, timeslice in (("T", None), ("G", 25.0), ("B", None)):
        ref = jax_create_gaintable(jvis, jones_type, timeslice=timeslice)
        out = create_gaintable_from_visibility(pvis, jones_type, timeslice=timeslice)
        assert out.gain.shape == ref.gain.shape
        for f in ("time", "interval"):
            assert getattr(out, f).dtype == torch.float64
            np.testing.assert_array_equal(_np(getattr(out, f)), np.asarray(getattr(ref, f)))
    # interop keeps the time axis in f64 from an f32 source too
    f32 = pvis.replace(time=pvis.time.float())
    assert interop.to_visibility(f32, device=CPU).time.dtype == torch.float64


def _public(mod) -> list:
    """``__all__``, or (the JAX ``utils`` namespace has none) every public
    name that is not a submodule."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n in dir(mod)
            if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))]


@pytest.mark.parametrize("name", ["ops", "models", "io", "pipeline", "parallel", "utils"])
def test_namespace_matches_jax(name):
    """Every public name of the JAX package's namespace is exported by the
    port's under the same name, and ``config.UNPORTED`` is empty: the
    port has every slice. ``import ska_sdp_func_python_torch`` binds the
    namespaces, as the JAX package's import does."""
    jax_mod = {"ops": jax_ops, "models": jax_models, "io": jax_io, "pipeline": jax_pipeline,
               "parallel": jax_parallel, "utils": jax_utils}[name]
    mod = getattr(port, name)
    exported = set(_public(mod))
    missing = [n for n in _public(jax_mod) if n not in exported]
    assert not missing, f"{name}: not exported: {missing}"
    assert all(hasattr(mod, n) for n in _public(jax_mod))
    assert config.UNPORTED == {}
    assert port.streaming.streamed_ical and port.io.VisStore


@pytest.mark.parametrize("name", ["linear", "circularnp", "stokesIQUV", "stokesI"])
def test_polarisation_frame_matches_jax(name):
    """The ported ``PolarisationFrame``: the JAX class's labels, count and
    equality, and the port's constructors take it where they take a
    frame name."""
    from ska_sdp_func_python_torch.models import PolarisationFrame

    ref, out = jax_models.PolarisationFrame(name), PolarisationFrame(name)
    assert out.names == ref.names and out.npol == ref.npol
    assert out == name and out == PolarisationFrame(name) and hash(out) == hash(name)
    assert out == ref
    with pytest.raises(ValueError):
        PolarisationFrame("nonsense")
    with pytest.raises(AttributeError):
        out.name = "linear"
    vis = create_visibility_from_arrays(
        uvw=np.zeros((1, 1, 3)), time=[0.0], frequency=[1e8], antenna1=[0],
        antenna2=[1], polarisation_frame=out, device=CPU,
    )
    assert vis.polarisation_frame == name and vis.npol == ref.npol
