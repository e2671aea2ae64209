"""The port's parallel layer across two processes: this file spawns
itself as two gloo workers (``python tests/test_torch_multihost.py
<rank> <world> <port> <inputs> <out> <threads>``), each owning 2 of the 4
shards of a mesh, which

- run ``sharded_ical`` on baseline shards: equal bit for bit to one
  process of 4 shards (the floating sums are added in global shard order
  whatever the layout; StefCal and CLEAN then see the same bits);
- refuse ``shard="channel"`` across processes, as the JAX package does;
- stream a store through ``streamed_ical(distribute=True)``, each process
  its round-robin slabs: held to one process in a group of its own at the
  JAX package's bound (tests/test_multihost.py:129-222, 1e-7); in a group
  the slabs' grids add in f64, outside one in f32 (held to each other at
  1e-6);
- reduce-scatter and sum int64 and complex64 tensors: each process's
  blocks equal one process's bit for bit, and a process receives through
  ``torch.distributed`` only what its own blocks need.

The inputs are made with the JAX package in the parent and handed over as
port tensors; the workers import only torch and the port. Each worker has
a timeout and the group a free port.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT_S = 120
PC = (0.0, np.deg2rad(-35.0))
HOGBOM = dict(calibration_context="T", algorithm="hogbom", niter=200, gain=0.2,
              fractional_threshold=0.01)
STREAM = dict(chunk_times=2, calibration_context="T", context="ng", nmajor=2,
              algorithm="hogbom", niter=150, gain=0.2, fractional_threshold=0.01)


def _collective_parts():
    """Four shards' int64 and complex64 tensors of 8 rows, from a seed."""
    g = torch.Generator().manual_seed(3)
    ints = [torch.randint(-(2**60), 2**60, (8, 3), generator=g) for _ in range(4)]
    cpx = [torch.randn((8, 3), generator=g, dtype=torch.complex64) for _ in range(4)]
    return ints, cpx


def _collectives(mesh):
    """This process's reduce-scatter blocks and psum of the parts of its
    shards, and the counters."""
    from ska_sdp_func_python_torch.parallel import collectives

    ints, cpx = _collective_parts()
    mine = lambda xs: [xs[d] for d in mesh.local]  # noqa: E731
    collectives.reset_collective_counts()
    out = dict(
        ints=collectives.psum_scatter(mesh, mine(ints)),
        cpx=collectives.psum_scatter(mesh, mine(cpx)),
        psum=collectives.psum(mesh, mine(cpx)),
    )
    return dict(out, counts=collectives.collective_counts())


def _worker(rank, world, port, inputs, out, threads):
    """One process of the group: the sharded self-cal on its 2 shards, the
    channel refusal and its share of the streamed self-cal."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(threads)
    from ska_sdp_func_python_torch.parallel import make_mesh, multihost, sharded_ical
    from ska_sdp_func_python_torch.streaming import streamed_ical

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=TIMEOUT_S)
    assert multihost.process_count() == world and multihost.process_index() == rank
    blob = torch.load(inputs, weights_only=False)
    mesh = make_mesh(shape=(4,), devices=["cpu"])
    assert mesh.local == (2 * rank, 2 * rank + 1) and mesh.multiprocess
    torch.save(_collectives(mesh), f"{out}.collectives{rank}")
    c, r, s, g = sharded_ical(blob["vis"], blob["model"], mesh, nmajor=3, **HOGBOM)
    try:
        sharded_ical(blob["vis"], blob["model"], mesh, nmajor=1, shard="channel", **HOGBOM)
        refused = ""
    except ValueError as err:
        refused = str(err)
    sc, sr, _, sg = streamed_ical(blob["store"], blob["model"], PC, distribute=True, **STREAM)
    if rank == 0:
        torch.save(dict(model=c.pixels, residual=r.pixels, restored=s.pixels,
                        gain=g["T"].gain, refused=refused, s_model=sc.pixels,
                        s_residual=sr.pixels, s_gain=sg.gain, s_time=sg.time), out)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the one-process references and the two workers'
    results."""
    from ska_sdp_func_python_tpu.io import write_visibility
    from ska_sdp_func_python_tpu.models import SkyComponents, create_gaintable_from_visibility
    from ska_sdp_func_python_tpu.ops import (
        apply_gaintable,
        create_image_from_visibility,
        dft_skycomponent_visibility,
    )
    from ska_sdp_func_python_torch import interop
    from ska_sdp_func_python_torch.parallel import make_mesh, multihost, sharded_ical
    from ska_sdp_func_python_torch.streaming import streamed_ical

    sys.path.insert(0, HERE)
    from simul import make_visibility
    from test_solvers import _simulate_gaintable

    tmp = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(20260819)
    vis = make_visibility(nants=10, ntimes=8, nchan=1, rmax=300.0, phasecentre=PC)
    model = create_image_from_visibility(vis, npixel=64, oversampling=4.0, nchan=1)
    ra, dec = model.pixel_to_radec(32 + 9, 32 - 6)
    comps = SkyComponents.from_lists([[float(ra), float(dec)]], [[[1.5]]], vis.frequency)
    vis = dft_skycomponent_visibility(vis, comps)
    gt = _simulate_gaintable(create_gaintable_from_visibility(vis, jones_type="T"), rng,
                             phase_error=0.3)
    corrupted = apply_gaintable(vis, gt)
    store = str(tmp / "stream.svis")
    write_visibility(corrupted, store, chunk_times=2)
    cpu = torch.device("cpu")
    pv = interop.to_visibility(corrupted, device=cpu)
    pm = interop.to_image(model, device=cpu)
    inputs, out = str(tmp / "inputs.pt"), str(tmp / "out.pt")
    torch.save(dict(vis=pv, model=pm, store=store), inputs)

    threads = torch.get_num_threads()
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port),
             inputs, out, str(threads)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in (0, 1)
    ]
    # the one-process references run while the workers do
    ref = sharded_ical(pv, pm, make_mesh(shape=(4,), devices=["cpu"]), nmajor=3, **HOGBOM)
    # the streamed reference: one process in a group of its own, as the
    # workers in theirs (in a group the slabs' grids accumulate in f64);
    # and outside a group (in f32)
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo", timeout_s=TIMEOUT_S)
    try:
        sref = streamed_ical(store, pm, PC, **STREAM)
    finally:
        torch.distributed.destroy_process_group()
    single = streamed_ical(store, pm, PC, **STREAM)
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    got = torch.load(out, weights_only=False)
    got["collectives"] = [torch.load(f"{out}.collectives{rank}", weights_only=False)
                          for rank in (0, 1)]
    got["single"] = single
    return ref, sref, got


def test_two_processes_equal_one_bit_for_bit(run):
    (c, r, s, g), _, got = run
    assert torch.equal(got["model"], c.pixels)
    assert torch.equal(got["residual"], r.pixels)
    assert torch.equal(got["restored"], s.pixels)
    assert torch.equal(got["gain"], g["T"].gain)
    assert float(r.pixels.abs().max()) < 0.2


def test_channel_shards_refused_across_processes(run):
    assert "multi-process" in run[2]["refused"], run[2]["refused"]


def test_two_process_streamed_matches_one(run):
    _, (sc, sr, _, sg), got = run
    np.testing.assert_allclose(got["s_residual"].numpy(), sr.pixels.numpy(), atol=1e-7)
    np.testing.assert_allclose(got["s_model"].numpy(), sc.pixels.numpy(), atol=1e-7)
    np.testing.assert_allclose(got["s_gain"].numpy(), sg.gain.numpy(), atol=1e-7)
    np.testing.assert_array_equal(got["s_time"].numpy(), sg.time.numpy())


def test_streamed_in_a_group_matches_no_group(run):
    """The one-process streamed run in a group (grids summed in f64)
    against the same run outside a group (in f32): the f32 sums' rounding
    only, within 1e-6."""
    _, (sc, sr, _, sg), got = run
    nc, nr, _, ng = got["single"]
    np.testing.assert_allclose(nr.pixels.numpy(), sr.pixels.numpy(), atol=1e-6)
    np.testing.assert_allclose(nc.pixels.numpy(), sc.pixels.numpy(), atol=1e-6)
    np.testing.assert_allclose(ng.gain.numpy(), sg.gain.numpy(), atol=1e-6)


def test_collectives_across_processes_equal_one(run):
    """Each process's reduce-scatter blocks are one process's blocks of
    the same shards (int64 exact, complex64 added in shard order), the
    psum is the same on both, and a process receives only what its 2 of
    the 4 blocks need: their int64 sums, and every shard's complex64
    partial of them."""
    from ska_sdp_func_python_torch.parallel import make_mesh

    one = _collectives(make_mesh(shape=(4,), devices=["cpu"]))
    two = run[2]["collectives"]
    for key in ("ints", "cpx"):
        assert all(torch.equal(a, b) for a, b in zip(two[0][key] + two[1][key], one[key])), key
    assert all(torch.equal(t["psum"], one["psum"]) for t in two)
    block = 2 * 3 * 8  # 2 rows of 3 (int64 or complex64)
    for t in two:
        assert t["counts"]["psum_scatter"]["comm_bytes"] == 2 * block + 4 * 2 * block
        assert t["counts"]["psum_scatter"]["bytes"] == 2 * block
    assert one["counts"]["psum_scatter"]["comm_bytes"] == 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
            int(sys.argv[6]))
