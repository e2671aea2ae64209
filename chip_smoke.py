"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's paths at two sizes. The flagship: SKA-LOW (512 stations
within 40 km), 76 integrations at 120 MHz (~9.9M visibilities), a 1024^2
image, "T" phase-only calibration, CLEAN niter 300, gain 0.2, fractional
threshold 0.01. The MSMFS cube (the JAX package's BASELINE config 4,
``bench_msmfs_pipeline.py``): 256 stations within 2 km in the JAX test
layout, 9 hour angles over +-pi/12 at dec -35 deg, 64 channels of 1 MHz
from 100 MHz (18,800,640 visibilities), a 256^2 cube at oversampling 3,
uniform weights, one 2.0 Jy source at (+20, -14) pixels with spectral
index -0.7 about channel 32, MSMFS with 3 moments, niter 100, fractional
threshold 0.01.

Phases, each on lines of its own:
  1. device: the card's name and power limit;
  2. build: compiles the CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and times the build;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at the main path's geometry, with both times, the kernel's bound
     (the least time the card could take for the same work) and, where one
     PyTorch call computes the same function, that call's time; the
     windowed Hogbom is checked against its plain version too. The grid
     kernel's row is the full flagship stream (9,942,016 entries), held
     against the plain version accumulated in f64 in pieces of 1M entries;
     a 1M-entry subset is held too;
  4. Hogbom ical: simulates the observation on the card, corrupts it with
     N(0, 0.4) phases, runs ``ical(algorithm="hogbom")`` with the launch
     counters reset, and prints per-cycle wall time and peak residual and
     the gain error;
  5. msclean ical: the same observation through ``ical`` with its default
     deconvolver, msclean (scales 0, 3, 10, 30), 4 major cycles; also the
     model flux around each source;
  6. deconvolve_cube: a stokesIQUV cube made from the flagship dirty image
     and PSF, with one fractional polarisation (p 0.2, angle 30 deg, v
     0.02), through ``algorithm="hogbom-complex"``;
  7. small slice: ical on a small observation with the CUDA kernels and
     on the CPU (plain versions), for Hogbom and msclean (the latter to a
     fractional threshold of 0.05), held to the JAX package's
     fused-vs-composed bounds;
  8. MSMFS cube: simulates the config-4 cube on the card, holds the grid
     kernel on one channel's launch (the cube cycle's shape) and (a) the
     msmfs kernel against its plain version on the cycle-0 moment stacks;
     (b) runs ``continuum_imaging(algorithm="mmclean")`` for 4 major
     cycles, printing each cycle's wall time and peak residual, and gates
     the peak's fall, the model flux around the source in channel 32 and
     the spectral index from the channel-0 and channel-63 model fluxes;
     (c) runs ``ical(algorithm="mmclean")`` on the cube corrupted with
     N(0, 0.4) "T" phases, 4 cycles, and prints the gain phase error;
     (d) runs ical with MSMFS on a small cube (the JAX package's fused-cube
     test geometry) on the card and on the CPU, to the bounds of phase 7;
  9. the epsilon contract on the flagship observation with natural weights
     and a 1.0 Jy source at 70% of the half-field, pixel (+360, +280) from
     the centre; each run is held to the exact DFT computed on the host in
     numpy f64 from the Visibility's own uvw. (a) the unit_tiles kernel
     against its plain version on the entry streams of the fast-f32 row
     (f32) and of the deep-f64 row (f64); (b) predict_visibility and
     invert_visibility at epsilon 1e-3 (the fast-f32 row: the tiled core
     path, unit_tiles); (c) at epsilon 1e-5 (the precise-f32 row: an
     eskernel plan from host-f64 coordinates, grid and degrid); (d) at
     epsilon 5e-7 on an f64 Visibility (the deep-f64 row: the tiled core
     path in f64); (e) both without a plan and without epsilon, twice
     each: the plan cache, against an explicit plan at padding 2.
Each of phases 4-6, 8b-c and 9b-e resets the launch counters just before
it and fails unless every kernel of its path launched. The script then
prints the grid and unit_tiles launches of each observation, the kernels
JSON line (launches summed over those phases), the card line, and, last,
the ``{"ok": true, ...}`` line. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero before
printing any result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

# The CPU runs of the small slices are the reference the card is held to,
# and their clean picks between near-equal peaks: MKL's default code path
# depends on the host's CPU model and its thread count on the host's load,
# and their rounding moved the CPU run's picks (and the gains by 4e-2) on
# one host. Its conditional numerical reproducibility mode with a fixed
# thread count gives the same CPU results on every host. Both must be set
# before torch loads MKL.
os.environ.setdefault("MKL_CBWR", "COMPATIBLE")
os.environ.setdefault("MKL_DYNAMIC", "FALSE")

# kernel: (tolerance on the max error relative to the plain version's
# maximum, source, the TPU kernel it replaces). grid: held against the
# plain version accumulated in f64, since atomics change the f32 summation
# order from run to run; degrid: f32 sums in another order; permute moves
# elements and must be bit-exact; hogbom, msclean and hogbom_complex: the
# same f32 operations in the same order; msmfs: the same, against the
# residual's maximum.
KERNELS = {
    "grid": (
        1e-5,
        "ska_sdp_func_python_torch/csrc/grid.cu",
        "ska_sdp_func_python_tpu/ops/gridding_fused.py:221",
    ),
    "degrid": (
        1e-5,
        "ska_sdp_func_python_torch/csrc/degrid.cu",
        "ska_sdp_func_python_tpu/ops/gridding_fused.py:915",
    ),
    "permute": (
        0.0,
        "ska_sdp_func_python_torch/csrc/permute.cu",
        "ska_sdp_func_python_tpu/ops/permute_pallas.py:61",
    ),
    "hogbom": (
        1e-6,
        "ska_sdp_func_python_torch/csrc/hogbom.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:165",
    ),
    "msclean": (
        1e-6,
        "ska_sdp_func_python_torch/csrc/msclean.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:1024 (and :903)",
    ),
    "hogbom_complex": (
        1e-6,
        "ska_sdp_func_python_torch/csrc/hogbom.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:517 (and :433)",
    ),
    "msmfs": (
        1e-6,
        "ska_sdp_func_python_torch/csrc/msmfs.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:1562",
    ),
    # f32, against the plain version accumulated in f64 (atomics); the f64
    # kernel is held to 1e-12 (UNIT_TILES_F64_TOL)
    "unit_tiles": (
        1e-5,
        "ska_sdp_func_python_torch/csrc/unit_tiles.cu",
        "ska_sdp_func_python_tpu/ops/gridding_pallas.py:34",
    ),
}
UNIT_TILES_F64_TOL = 1e-12
CLEAN = dict(niter=300, gain=0.2, fractional_threshold=0.01)
SCALES = [0, 3, 10, 30]
# source pixel offsets (dx, dy) from the centre at 1024^2, and fluxes (Jy)
SOURCES = [(0, 0, 2.0), (60, -40, 1.2), (-80, 30, 0.8)]
# polarisation of the deconvolve_cube sky: fraction, angle, circular
POL_P, POL_CHI, POL_V = 0.2, np.deg2rad(30.0), 0.02
# the MSMFS cube (config 4): layout, observation and CLEAN
CUBE = dict(nants=256, rmax=2000.0, ntimes=9, nchan=64, df=1e6, npixel=256,
            oversampling=3.0, offset=(20, -14), alpha=-0.7, weighting="uniform")
CUBE_CLEAN = dict(algorithm="mmclean", nmoment=3, niter=100,
                  fractional_threshold=0.01, scales=SCALES)
# the spectral-index gate: the JAX package's own fused cube cycle, run on the
# CPU on this layout at 48 stations and 16 channels of 4 MHz, recovers -0.835
# for the sky's -0.7 (and -0.703 at 128 stations, 8 channels), so the gate
# is 0.15, not 0.1
INDEX_TOL = 0.15
# the small cube of the JAX package's fused-cube test (test_composite.py)
SMALL_CUBE = dict(nants=14, rmax=300.0, ntimes=3, nchan=6, df=4e6, npixel=96,
                  oversampling=4.0, offset=(7, -4), alpha=-0.7, weighting="natural")

# NVIDIA H100 SXM published peaks at 700 W: HBM and f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12

# phase 9: the source's pixel offset (dx, dy) from the centre of the 1024^2
# image (70% of the half-field, the adversarial position of the JAX
# package's epsilon tests) and the three rows' epsilons
SOURCE9 = (360, 280)
EPS_FAST, EPS_PRECISE, EPS_DEEP = 1e-3, 1e-5, 5e-7


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host's CPU model, which the small slices' CPU runs depend on."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown CPU"


def timed(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops, peak_ops=PEAK_F32_S):
    """(ms, what bounds it): the larger of the bytes over the card's memory
    rate and the operations over the card's peak rate for their type (f32
    by default)."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def footprint_area(y, x, ny, nx, py, px):
    """Pixels of a PSF footprint centred on (y, x), clipped to the image."""
    cy, cx = py // 2, px // 2
    h = min(ny, y - cy + py) - max(0, y - cy)
    w = min(nx, x - cx + px) - max(0, x - cx)
    return max(h, 0) * max(w, 0)


def simulate(device, rmax, ntimes, npixel, seed=42):
    """The flagship observation on ``device``: three point sources
    (2.0, 1.2, 0.8 Jy), per-station "T" phases from N(0, 0.4), uniform
    imaging weights (natural weighting of this core-heavy array gives a
    PSF whose sidelobes reach 0.99, on which Hogbom diverges)."""
    import torch

    from ska_sdp_func_python_torch.models import (
        SkyComponents,
        create_gaintable_from_visibility,
        create_named_configuration,
        create_visibility,
    )
    from ska_sdp_func_python_torch.ops import (
        apply_gaintable,
        create_image_from_visibility,
        dft_skycomponent_visibility,
    )
    from ska_sdp_func_python_torch.ops.weighting import weight_visibility

    rng = np.random.default_rng(seed)
    cfg = create_named_configuration("LOW", rmax=rmax)
    vis = create_visibility(
        cfg, np.linspace(-0.3, 0.3, ntimes), [1.2e8],
        elevation_limit=np.deg2rad(15.0), device=device,
    )
    model = create_image_from_visibility(
        vis, npixel=npixel, oversampling=3.0, nchan=1
    )
    dirs, fluxes = [], []
    scale = npixel / 1024
    for dx, dy, f in SOURCES:
        ra, dec = model.pixel_to_radec(
            npixel // 2 + int(dx * scale), npixel // 2 + int(dy * scale)
        )
        dirs.append([float(ra), float(dec)])
        fluxes.append([[f]])
    sky = SkyComponents.from_lists(
        dirs, np.asarray(fluxes), vis.frequency, device=device
    )
    vis = dft_skycomponent_visibility(vis, sky)
    gt = create_gaintable_from_visibility(vis, jones_type="T")
    phases = rng.normal(0, 0.4, gt.gain.shape[:3])
    true_gain = torch.polar(
        torch.ones(phases.shape), torch.as_tensor(phases, dtype=torch.float32)
    ).to(device)
    gt = gt.replace(gain=true_gain[..., None, None].contiguous())
    corrupted = weight_visibility(
        apply_gaintable(vis, gt), model, weighting="uniform"
    )
    return cfg, corrupted, model, phases


def simulate_cube(device, nants, rmax, ntimes, nchan, df, npixel, oversampling,
                  offset, alpha, weighting, flux=2.0, seed=42):
    """A cube observation in the JAX package's test layout
    (``tests/simul.py``: ``random_array_xyz``, hour angles over +-pi/12,
    dec -35 deg), channels of ``df`` from 100 MHz, and one source of
    ``flux`` Jy at channel nchan // 2 with spectral index ``alpha``, at
    pixel offset ``offset`` (dx, dy) from the centre. Returns (vis,
    model)."""
    from ska_sdp_func_python_torch.models import (
        SkyComponents,
        create_visibility_from_arrays,
        random_array_xyz,
    )
    from ska_sdp_func_python_torch.ops import (
        create_image_from_visibility,
        dft_skycomponent_visibility,
    )
    from ska_sdp_func_python_torch.ops.weighting import weight_visibility
    from ska_sdp_func_python_torch.utils.coordinates import xyz_to_uvw

    ants = random_array_xyz(nants, rmax=rmax, seed=seed)
    a1, a2 = np.triu_indices(nants, 1)
    hour_angles = np.linspace(-np.pi / 12.0, np.pi / 12.0, ntimes)
    dec = np.deg2rad(-35.0)
    uvw = np.stack([xyz_to_uvw(ants[a2] - ants[a1], ha, dec) for ha in hour_angles])
    freq = 1.0e8 + df * np.arange(nchan)
    vis = create_visibility_from_arrays(
        uvw=uvw, time=hour_angles * 86164.1 / (2 * np.pi), frequency=freq,
        antenna1=a1, antenna2=a2, phasecentre=(0.0, dec), nants=nants,
        device=device,
    )
    model = create_image_from_visibility(
        vis, npixel=npixel, oversampling=oversampling, nchan=nchan
    )
    ra, dec_s = model.pixel_to_radec(npixel // 2 + offset[0], npixel // 2 + offset[1])
    fluxes = flux * (freq / freq[nchan // 2]) ** alpha
    sky = SkyComponents.from_lists(
        [[float(ra), float(dec_s)]], fluxes[None, :, None], vis.frequency,
        device=device,
    )
    vis = dft_skycomponent_visibility(vis, sky)
    return weight_visibility(vis, model, weighting=weighting), model


def corrupt(vis, sigma, seed=42):
    """``vis`` times per-station "T" phases from N(0, sigma); returns
    (corrupted vis, true phases [ntime, nants, 1])."""
    import torch

    from ska_sdp_func_python_torch.models import create_gaintable_from_visibility
    from ska_sdp_func_python_torch.ops import apply_gaintable

    gt = create_gaintable_from_visibility(vis, jones_type="T")
    phases = np.random.default_rng(seed).normal(0, sigma, gt.gain.shape[:3])
    true_gain = torch.polar(
        torch.ones(phases.shape), torch.as_tensor(phases, dtype=torch.float32)
    ).to(vis.device)
    gt = gt.replace(gain=true_gain[..., None, None].contiguous())
    return apply_gaintable(vis, gt), phases


def gain_phase_error(solved, true_phases):
    """Max and rms phase error (rad) of the solved gains against the true
    phases, both referenced to station 0."""
    g = solved.detach().cpu().numpy()[..., 0, 0, 0]
    ref = np.angle(g * np.conj(g[:, :1]))
    tru = true_phases[..., 0] - true_phases[:, :1, 0]
    err = np.angle(np.exp(1j * (ref - tru)))
    return float(np.max(np.abs(err))), float(np.sqrt(np.mean(err**2)))


def _row(err, rel, ms, plain_ms, bnd, library_ms=None):
    return dict(
        max_abs_err=err, rel=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
    )


def grid_plain_pieces(gp, vals, piece=1 << 20):
    """grid_plain of plan ``gp`` over pieces of ``piece`` entries, summed:
    the plain version at the full stream within the card's memory."""
    import dataclasses

    from ska_sdp_func_python_torch.ops.gridding_fused import grid_plain

    out = None
    for a in range(0, gp.n_in, piece):
        b = min(a + piece, gp.n_in)
        sub = dataclasses.replace(
            gp, iu0=gp.iu0[a:b], iv0=gp.iv0[a:b], plane=gp.plane[a:b],
            frac=gp.frac[a:b], ku=gp.ku[a:b], kv=gp.kv[a:b], n=b - a, n_in=b - a,
        )
        g = grid_plain(sub, vals[a:b])
        out = g if out is None else out.add_(g)
    return out


def grid_row(gp, vals, label, plain_reps=1):
    """The grid kernel against its plain version accumulated in f64 (in
    pieces) on plan ``gp`` and plan-ordered ``vals``; times both (the plain
    version in f64) and prints the row with its bound. Returns the kernel
    row."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import grid

    ref = grid_plain_pieces(gp, vals.to(torch.complex128))
    err = float((grid(gp, vals) - ref).abs().max())
    rel = err / float(ref.abs().max())
    del ref
    nchunks = int(gp.chunk_seg.shape[0])
    grids_bytes = gp.nplanes * gp.npixel**2 * 8
    # per entry: value, corner, plane fraction and 2 x 8 taps in (what
    # gridding needs: not the kernel's walk order or chunk table); per tap
    # one tap product and, on each of two planes, a complex scale and add
    entry_bytes = 8 + 4 + 4 + 4 + 32 + 32
    row = _row(
        err, rel, timed(lambda: grid(gp, vals), 10),
        timed(lambda: grid_plain_pieces(gp, vals.to(torch.complex128)), plain_reps),
        bound(gp.n_in * entry_bytes + grids_bytes, gp.n_in * (64 * 9 + 5)),
    )
    say(
        f"grid {label}: {gp.n_in} entries in {nchunks} chunks of at most "
        f"{int(gp.chunk_count.max())}, {gp.nplanes} planes of {gp.npixel}^2, "
        f"tile {gp.tile}: max abs err {err:.3e}, rel {rel:.3e} (tolerance "
        f"{KERNELS['grid'][0]:g}); kernel {row['ms']:.4f} ms, plain (f64, in "
        f"pieces) {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})"
    )
    if not rel <= KERNELS["grid"][0]:
        raise AssertionError(f"grid {label} disagrees with its plain version")
    return row


def compare_gridding(device, vis, plan):
    """grid, degrid and permute against their plain versions at the main
    path's geometry."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import (
        degrid,
        degrid_plain,
    )
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_imaging_plan
    from ska_sdp_func_python_torch.ops.permute import (
        permute_apply,
        permute_apply_plain,
    )

    out = {}
    full = plan.plans[0]
    # 1M entries of the flagship coordinates on the flagship geometry
    # (same npad, tile, w planes), small enough for the plain versions
    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    n_sub = min(1 << 20, uvw.shape[0])
    sub = make_imaging_plan(
        uvw[:n_sub, 0], uvw[:n_sub, 1], uvw[:n_sub, 2],
        npixel=full.npixel, cellsize=full.cellsize, nw=full.nw,
        padding=1.25, w_range=(float(uvw[:, 2].min()), float(uvw[:, 2].max())),
    ).gp
    assert (sub.npixel, sub.nplanes, sub.tile) == (
        full.gp.npixel, full.gp.nplanes, full.gp.tile
    )
    g = torch.Generator(device=device).manual_seed(1)
    # the main path's grid input: weighted visibilities in plan order;
    # reference: the plain version accumulated in f64 (its f32 form sums
    # up to ~1e5 terms per cell one by one and is the less accurate side).
    # The row is the full flagship stream; the 1M subset is held too
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    grid_row(sub, sort_values(sub, weighted[:n_sub]), "1M subset", 3)
    out["grid"] = grid_row(full.gp, sort_values(full.gp, weighted), "full stream")
    grids_bytes = sub.nplanes * sub.npixel**2 * 8
    grids = torch.randn(
        (sub.nplanes, sub.npixel, sub.npixel), generator=g, device=device,
        dtype=torch.complex64,
    )
    ref = degrid_plain(sub, grids)
    res = degrid(sub, grids)
    err = float((res - ref).abs().max())
    # per entry: corner, plane, fraction, taps in and the value out; per
    # plane 8 row sums of 8 complex-by-real products and one of 8
    out["degrid"] = _row(
        err, err / float(ref.abs().max()),
        timed(lambda: degrid(sub, grids), 10),
        timed(lambda: degrid_plain(sub, grids), 3),
        bound(grids_bytes + sub.n * (4 + 4 + 4 + 4 + 32 + 32 + 8),
              sub.n_in * (2 * (64 * 4 + 8 * 4) + 6)),
    )
    del ref, res, grids
    full_grids = torch.randn(
        (full.nw, full.npad, full.npad), generator=g, device=device,
        dtype=torch.complex64,
    )
    degrid_ms = timed(lambda: degrid(full.gp, full_grids), 5)
    say(
        f"full-size kernel times ({full.gp.n} entries, {full.nw} planes of "
        f"{full.npad}^2): grid {out['grid']['ms']:.3f} ms, degrid {degrid_ms:.3f} ms"
    )
    del full_grids
    # permute: the full flagship permutation, one complex64 payload,
    # both directions
    perm = full.gp.perm
    x = torch.randn(perm.shape[0], generator=g, device=device, dtype=torch.complex64)
    for inv in (False, True):
        same = torch.equal(
            permute_apply(perm, x, inverse=inv),
            permute_apply_plain(perm, x, inverse=inv),
        )
        if not same:
            raise AssertionError(f"permute (inverse={inv}) is not bit-exact")
    idx = perm.long()
    y = torch.empty_like(x)
    out["permute"] = _row(
        0.0, 0.0,
        timed(lambda: permute_apply(perm, x, inverse=True), 20),
        timed(lambda: permute_apply_plain(perm, x, inverse=True), 5),
        bound(perm.shape[0] * (4 + 8 + 8), 0),
        timed(lambda: y.index_copy_(0, idx, x), 20),
    )
    return out


def _hogbom_plain_on_card(d, p, w, kw):
    """The plain Hogbom loop, run on the card's tensors."""
    from ska_sdp_func_python_torch.ops.cleaners import (
        _rows_to_image,
        hogbom_rows_plain,
    )

    rows, res = hogbom_rows_plain(d[0], p[0], None if w is None else w[0], **kw)
    return _rows_to_image(rows[None], *d.shape[-2:]), res[None], rows


def _hogbom_bound(rows, ny, nx, py, px, planes=1, search_ops=2):
    """Bytes: dirty and PSF in, residual and rows out, per plane; operations:
    each used row's clipped footprint (one fused multiply-add a pixel and
    plane) and one search over the image per iteration."""
    used = [r for r in rows.tolist() if r[-1] > 0]
    area = sum(footprint_area(int(r[0]), int(r[1]), ny, nx, py, px) for r in used)
    nbytes = 4 * (2 * planes * ny * nx + py * px) + 4 * rows.numel()
    nops = 2 * planes * area + search_ops * ny * nx * (len(used) + 1)
    return bound(nbytes, nops), len(used)


def _check_clean(name, out, ref):
    """Identical component positions; every output within its tolerance of
    the plain version's maximum. Returns (max abs err, rel err)."""
    import torch

    if not torch.equal(out[0] != 0, ref[0] != 0):
        raise AssertionError(f"{name}: component positions differ")
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    rel = max(
        float((o - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        for o, r in zip(out, ref)
    )
    return err, rel


def compare_cleaners(dirty, psf_patch):
    """hogbom (with and without the quarter window), msclean and
    hogbom_complex against their plain versions on the card, on the
    cycle-0 dirty image and the bounded PSF."""
    import torch

    from ska_sdp_func_python_torch.ops import cleaners as cl

    out = {}
    ny, nx = dirty.shape[-2:]
    py, px = psf_patch.shape[-2:]
    d = dirty.reshape(1, ny, nx).contiguous()
    p = psf_patch.reshape(1, py, px).contiguous()
    kw = dict(
        gain=CLEAN["gain"], thresh=0.0, niter=CLEAN["niter"],
        fracthresh=CLEAN["fractional_threshold"],
    )
    kc, kr = cl.hogbom_lanes(d, p, **kw)
    pc, pr, rows = _hogbom_plain_on_card(d, p, None, kw)
    err, rel = _check_clean("hogbom", (kc, kr), (pc, pr))
    bnd, nused = _hogbom_bound(rows, ny, nx, py, px)
    out["hogbom"] = _row(
        err, rel,
        timed(lambda: cl.hogbom_lanes(d, p, **kw), 5),
        timed(lambda: _hogbom_plain_on_card(d, p, None, kw), 5),
        bnd,
    )
    win = torch.zeros_like(d)
    win[:, ny // 4 + 1 : 3 * (ny // 4), nx // 4 + 1 : 3 * (nx // 4)] = 1.0
    kc, kr = cl.hogbom_lanes(d, p, win, **kw)
    pc, pr, _ = _hogbom_plain_on_card(d, p, win, kw)
    werr, wrel = _check_clean("windowed hogbom", (kc, kr), (pc, pr))
    if not wrel <= KERNELS["hogbom"][0] or float(kc[win == 0].abs().max()) != 0.0:
        raise AssertionError(f"windowed hogbom disagrees: rel {wrel}")
    say(f"kernel hogbom, quarter window: max abs err {werr:.3e}, rel err {wrel:.3e} ok")

    # msclean: the fused lane's stacks from the bounded PSF
    st = cl.msclean_psf_stacks(psf_patch.reshape(py, px), ny, nx, SCALES)
    res_stack = cl.convolve_scalestack(st.scalestack, d[0] / st.pmax)[None].contiguous()
    ms_args = (res_stack, st.psf_ss[None], st.coupling_diag[None])

    def ms_kernel():
        return cl.msclean_lanes(*ms_args, **kw)

    def ms_plain():
        return cl.msclean_rows_plain(
            res_stack[0], st.psf_ss, st.coupling_diag, **kw
        )

    krows, kres = ms_kernel()
    prows, pres = ms_plain()
    kcomp = cl.msclean_rows_to_comps(krows[0], st.pscalestack, ny, nx)
    pcomp = cl.msclean_rows_to_comps(prows, st.pscalestack, ny, nx)
    err, rel = _check_clean("msclean", (kcomp, kres[0]), (pcomp, pres))
    ns = len(SCALES)
    used = [r for r in prows.tolist() if r[4] > 0]
    area = sum(footprint_area(int(r[0]), int(r[1]), ny, nx, py, px) for r in used)
    nscales_used = len({int(r[2]) for r in used})
    ms_bnd = bound(
        4 * (2 * ns * ny * nx + ns * nscales_used * py * px + ns) + 4 * prows.numel(),
        2 * ns * area + 3 * ns * ny * nx * (len(used) + 1),
    )
    ms_ms = timed(ms_kernel, 5)
    out["msclean"] = _row(err, rel, ms_ms, timed(ms_plain, 2), ms_bnd)
    per_it_mb = (ns * ny * nx * 4 + 2 * ns * area * 4 / max(len(used), 1)) / 1e6
    say(
        f"msclean: {len(used)} iterations at {ny}x{nx}, {ns} scales, PSF "
        f"{py}x{px}: {ms_ms / max(len(used), 1) * 1e3:.2f} us per iteration; "
        f"the stack streamed once per iteration plus the footprint read-"
        f"modify-write is {per_it_mb:.1f} MB, {per_it_mb * 1e6 / PEAK_BYTES_S * 1e6:.2f} "
        f"us at 3.35 TB/s"
    )
    del st, res_stack, ms_args

    # complex Hogbom on the Q and U planes of the polarised cube
    q = (POL_P * np.cos(2 * POL_CHI)) * d
    u = (POL_P * np.sin(2 * POL_CHI)) * d

    def cx_plain():
        rows, rq, ru = cl.hogbom_complex_rows_plain(q[0], u[0], p[0], **kw)
        return rows, rq, ru

    ko = cl.hogbom_complex_lanes(q, u, p, **kw)
    prow, prq, pru = cx_plain()
    pcq = cl._rows_to_image(prow[None], ny, nx, col=2, used=4)
    pcu = cl._rows_to_image(prow[None], ny, nx, col=3, used=4)
    err, rel = _check_clean("hogbom_complex", ko, (pcq, pcu, prq[None], pru[None]))
    bnd, _ = _hogbom_bound(prow, ny, nx, py, px, planes=2, search_ops=5)
    out["hogbom_complex"] = _row(
        err, rel,
        timed(lambda: cl.hogbom_complex_lanes(q, u, p, **kw), 5),
        timed(cx_plain, 3),
        bnd,
    )
    return out


class _CycleLog(logging.Handler):
    """Collects the per-cycle log records of the port's ical with their
    arrival times (each record follows a device sync on the peak)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.events = []

    def emit(self, record):
        self.events.append((time.perf_counter(), record.getMessage()))


def _launch_gate(label, counts, names):
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched: {counts}")


def run_logged(label, entry, nmajor, path_kernels):
    """Runs ``entry()``, a user-facing entry point that logs each major
    cycle's peak residual, on the card, with the launch counters reset
    just before it and read just after; prints each cycle's wall time and
    peak. Fails unless every cycle logged a finite peak, the peak fell and
    every kernel of ``path_kernels`` launched. Returns (entry's result,
    counts, peaks)."""
    import torch

    from ska_sdp_func_python_torch import kernels

    handler = _CycleLog()
    logger = logging.getLogger("ska-sdp-func-python-torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = entry()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.launch_counts()
    logger.removeHandler(handler)
    say(f"{label}: total {total:.3f} s, launches {counts}")
    peaks = []
    prev = None
    for t, msg in handler.events:
        if "cycle" in msg and prev is not None:
            peaks.append(float(msg.rsplit(" ", 1)[1]))
            say(f"{label}: {msg.split(': ', 1)[1]}, wall {(t - prev) * 1e3:.1f} ms")
        prev = t
    if not all(np.isfinite(peaks)) or len(peaks) != nmajor:
        raise AssertionError(f"{label}: per-cycle peaks missing or not finite: {peaks}")
    if not peaks[-1] < peaks[0]:
        raise AssertionError(f"{label}: peak residual did not fall: {peaks}")
    if not all(torch.isfinite(im.pixels).all() for im in out[:3]):
        raise AssertionError(f"{label}: an output image is not finite")
    _launch_gate(label, counts, path_kernels)
    return out, counts, peaks


def run_ical(label, vis, model, phases, nmajor, path_kernels, **kw):
    """The user-facing ical on the card (see :func:`run_logged`), and its
    gain phase error. Returns (counts, peaks, model, restored peak)."""
    from ska_sdp_func_python_torch.pipeline import ical

    (current, residual, restored, gts), counts, peaks = run_logged(
        label,
        lambda: ical(vis, model, nmajor=nmajor, calibration_context="T",
                     context="ng", **kw),
        nmajor, path_kernels,
    )
    gmax, grms = gain_phase_error(gts["T"].gain, phases)
    rpeak = float(restored.pixels.max())
    say(
        f"{label}: gain phase error vs truth max {gmax:.3e} rad, rms {grms:.3e} "
        f"rad; restored peak {rpeak:.4f} (source 2.0 Jy); final residual "
        f"peak {float(residual.pixels.abs().max()):.4e}"
    )
    return counts, peaks, current, rpeak


def run_hogbom_ical(vis, model, phases):
    """Phase 4: the Hogbom ical of the first slice, with its gates."""
    counts, _, _, rpeak = run_ical(
        "hogbom ical", vis, model, phases, 4,
        ("grid", "degrid", "permute", "hogbom"), algorithm="hogbom", **CLEAN,
    )
    if not abs(rpeak - 2.0) < 0.2:
        raise AssertionError(f"restored peak {rpeak} not within 0.2 of 2.0")
    return counts


def run_msclean_ical(vis, model, phases):
    """Phase 5: ical with its default deconvolver, msclean."""
    counts, peaks, current, _ = run_ical(
        "msclean ical", vis, model, phases, 4,
        ("grid", "degrid", "permute", "msclean"), scales=SCALES, **CLEAN,
    )
    n = model.npixel
    px = current.pixels[0, 0].detach().cpu().numpy()
    yy, xx = np.mgrid[0:n, 0:n]
    fluxes = []
    for dx, dy, f in SOURCES:
        sy, sx = n // 2 + int(dy * n / 1024), n // 2 + int(dx * n / 1024)
        near = np.hypot(yy - sy, xx - sx) <= 10
        fluxes.append(float(px[near].sum()))
        say(f"msclean ical: model flux within 10 px of the {f} Jy source {fluxes[-1]:.4f}")
    if not peaks[-1] < 0.1 * peaks[0]:
        raise AssertionError(f"msclean ical: last peak not below 0.1x the first: {peaks}")
    if not abs(fluxes[0] - 2.0) < 0.2:
        raise AssertionError(f"msclean ical: flux {fluxes[0]} not within 0.2 of 2.0")
    return counts


def run_deconvolve_cube(dirty_image, psf_image):
    """Phase 6: deconvolve_cube(algorithm="hogbom-complex") on a stokesIQUV
    cube whose sources share one fractional polarisation."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.deconvolution import deconvolve_cube

    d = dirty_image.pixels[0, 0].to(torch.float32)
    p = psf_image.pixels[0, 0].to(torch.float32)
    planes = [
        d, POL_P * np.cos(2 * POL_CHI) * d, POL_P * np.sin(2 * POL_CHI) * d,
        POL_V * d,
    ]
    dirty = dirty_image.replace(
        pixels=torch.stack(planes)[None], polarisation_frame="stokesIQUV"
    )
    psf = psf_image.replace(
        pixels=torch.stack([p] * 4)[None].contiguous(), polarisation_frame="stokesIQUV"
    )
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comp, res = deconvolve_cube(dirty, psf, algorithm="hogbom-complex", **CLEAN)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.launch_counts()
    _launch_gate("deconvolve_cube", counts, ("hogbom", "hogbom_complex"))
    c = comp.pixels[0].double().sum(dim=(-2, -1)).cpu().numpy()
    chi = 0.5 * np.degrees(np.arctan2(c[2], c[1]))
    pfrac = float(np.hypot(c[1], c[2]) / c[0])
    say(
        f"deconvolve_cube hogbom-complex {tuple(dirty.pixels.shape)}: "
        f"{total * 1e3:.1f} ms, launches {counts}; component sums I {c[0]:.4f} "
        f"Q {c[1]:.4f} U {c[2]:.4f} V {c[3]:.4f}; angle {chi:.4f} deg "
        f"(sky 30), fraction {pfrac:.5f} (sky 0.2)"
    )
    if not torch.isfinite(res.pixels).all():
        raise AssertionError("deconvolve_cube: residual is not finite")
    if not (abs(chi - 30.0) < 0.1 and abs(pfrac - POL_P) < 0.01):
        raise AssertionError("deconvolve_cube: polarisation not recovered")
    return counts


def small_slice_matches_cpu(device, algorithm, **clean):
    """Phase 7: ical on a small observation with the CUDA kernels and on
    the CPU with the plain versions (which the CPU tests hold against the
    JAX package), to the JAX package's fused-vs-composed bounds.

    Both restored peaks are taken with the CPU run's clean beam: the
    Gaussian fit to this small array's PSF starts from a circular beam,
    where its angle has no gradient, so f32-level PSF differences alone
    move the fitted beam, and with it the restored peak, by several
    hundredths. The beams both runs fitted are printed."""
    from ska_sdp_func_python_torch.ops.deconvolution import restore_cube
    from ska_sdp_func_python_torch.pipeline import ical

    out = {}
    for dev in (device, "cpu"):
        _, vis, model, _ = simulate(dev, rmax=600.0, ntimes=8, npixel=256)
        d, r, s, g = ical(
            vis, model, nmajor=3, calibration_context="T", context="ng",
            algorithm=algorithm, scales=SCALES, **{**CLEAN, **clean},
        )
        gain = g["T"].gain.cpu().numpy()[..., 0, 0, 0]
        out[dev] = (gain * np.exp(-1j * np.angle(gain[:, :1])), d, r, s)
    (ga, da, ra, sa), (gb, db, rb, sb) = out[device], out["cpu"]
    beam = dict(zip(("bmaj", "bmin", "bpa"), np.rad2deg(sb.clean_beam)))
    peak_a = float(restore_cube(da, residual=ra, clean_beam=beam).pixels.max())
    peak_b = float(sb.pixels.max())
    dg = float(np.max(np.abs(ga - gb)))
    res_a, res_b = float(ra.pixels.abs().max()), float(rb.pixels.abs().max())
    say(
        f"small slice {algorithm} card vs cpu: gain {dg:.2e} (bound 1e-4), "
        f"residual peak {res_a:.6f} vs {res_b:.6f} (bound 1e-3 rel), restored "
        f"with one beam {peak_a:.4f} vs {peak_b:.4f} (bound 0.05); fitted "
        f"beams (bmaj, bmin, bpa deg) {np.rad2deg(sa.clean_beam)} vs "
        f"{np.rad2deg(sb.clean_beam)}, restored with its own beam "
        f"{float(sa.pixels.max()):.4f}"
    )
    if not (dg < 1e-4 and abs(res_a - res_b) < 1e-3 * res_b and abs(peak_a - peak_b) < 0.05):
        raise AssertionError(f"small slice {algorithm}: card and cpu disagree")


def model_flux_near(current, chan, offset, radius=10):
    """The model flux (Jy) of channel ``chan`` within ``radius`` pixels of
    the source at pixel offset ``offset`` (dx, dy) from the centre."""
    n = current.npixel
    px = current.pixels[chan, 0].detach().double().cpu().numpy()
    yy, xx = np.mgrid[0:n, 0:n]
    near = np.hypot(yy - (n // 2 + offset[1]), xx - (n // 2 + offset[0])) <= radius
    return float(px[near].sum())


def cube_gates(label, current, peaks, offset, alpha, gate=True):
    """The MSMFS cube gates: the last peak residual below 0.1x the first;
    the model flux within 10 px of the source in the middle channel within
    0.2 of 2.0 Jy; the spectral index from the first and last channels'
    model fluxes within INDEX_TOL of the sky's. With ``gate`` False the
    numbers are only printed."""
    freq = np.asarray(current.frequency)
    nchan = len(freq)
    f_mid = model_flux_near(current, nchan // 2, offset)
    f_lo = model_flux_near(current, 0, offset)
    f_hi = model_flux_near(current, nchan - 1, offset)
    index = float(np.log(f_hi / f_lo) / np.log(freq[-1] / freq[0]))
    say(
        f"{label}: model flux within 10 px of the source: channel {nchan // 2} "
        f"{f_mid:.4f} (sky 2.0), channel 0 {f_lo:.4f}, channel {nchan - 1} "
        f"{f_hi:.4f}; spectral index {index:.4f} (sky {alpha}); peak residual "
        f"{peaks[0]:.6f} -> {peaks[-1]:.6f}"
    )
    if not gate:
        return
    if not peaks[-1] < 0.1 * peaks[0]:
        raise AssertionError(f"{label}: last peak not below 0.1x the first: {peaks}")
    if not abs(f_mid - 2.0) < 0.2:
        raise AssertionError(f"{label}: flux {f_mid} not within 0.2 of 2.0")
    if not abs(index - alpha) < INDEX_TOL:
        raise AssertionError(
            f"{label}: spectral index {index} not within {INDEX_TOL} of {alpha}"
        )


def compare_msmfs(vis, model, plan):
    """Phase 8a: the msmfs kernel against its plain version on the card, on
    the cycle-0 moment stacks of the cube's fused cycle (the moment images
    of the dirty cube and the moment PSFs over the moment-PSF peak)."""
    import torch

    from ska_sdp_func_python_torch.ops import cleaners as cl
    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf
    from ska_sdp_func_python_torch.ops.imaging import invert_visibility
    from ska_sdp_func_python_torch.ops.taylor import moment_weights

    nm = CUBE_CLEAN["nmoment"]
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    dirty, _ = invert_visibility(vis, model, plan=plan)
    patch = bound_psf(psf, psf).pixels.to(torch.float32)
    w_m, w_p = (
        moment_weights(model.frequency, None, k).to(device=vis.device, dtype=torch.float32)
        for k in (nm, 2 * nm)
    )
    psf_t = torch.einsum("cm,cpyx->mpyx", w_p, patch)
    peak = psf_t.max()
    ny, nx = model.pixels.shape[-2:]
    st = cl.msmfs_psf_stacks(psf_t[:, 0] / peak, ny, nx, SCALES)
    dpix = torch.einsum("cm,cpyx->mpyx", w_m, dirty.pixels.to(torch.float32)) / peak
    smres = cl.calculate_scale_moment_residual(dpix[:, 0] / st.pmax, st.scalestack)
    smres = smres.contiguous()
    del psf, dirty, patch
    kw = dict(gain=0.7, thresh=0.0, fracthresh=CUBE_CLEAN["fractional_threshold"],
              niter=CUBE_CLEAN["niter"])

    def kernel():
        return cl.msmfs_lanes(smres[None], st.canvas, st.hsmm, st.ihsmm, **kw)

    def plain():
        return cl.msmfs_rows_plain(smres, st.canvas, st.hsmm, st.ihsmm, **kw)

    (krows, kres), (prows, pres) = kernel(), plain()
    if not torch.equal(krows[0, :, :4], prows[:, :4]):
        raise AssertionError("msmfs: component rows differ from the plain version")
    kmodel = cl.msmfs_rows_to_model(krows[0], st.pscalestack, ny, nx)
    pmodel = cl.msmfs_rows_to_model(prows, st.pscalestack, ny, nx)
    err = max(
        float((kres[0] - pres).abs().max()), float((kmodel - pmodel).abs().max()),
        float((krows[0, :, 4:] - prows[:, 4:]).abs().max()),
    )
    rel = err / float(pres.abs().max())
    ns = len(SCALES)
    py, px = st.canvas.shape[-2:]
    used = [r for r in prows.tolist() if r[3] > 0]
    area = sum(footprint_area(int(r[0]), int(r[1]), ny, nx, py, px) for r in used)
    stack = ns * nm * ny * nx
    # bytes: the stack in and out, the compact canvas, Hessian and inverse
    # in, the rows out; operations: the moment-0 criterion (nm products,
    # nm - 1 sums) and its comparison over the stack once per search, and
    # nm sums of nm products for every moment plane of every scale over
    # each pick's footprint
    bnd = bound(
        4 * (2 * stack + ns * ns * (2 * nm - 1) * py * px + 2 * ns * nm * nm)
        + 4 * prows.numel(),
        (2 * nm + 1) * ns * ny * nx * (len(used) + 1) + 2 * nm * ns * nm * area,
    )
    ms = timed(kernel, 5)
    out = _row(err, rel, ms, timed(plain, 2), bnd)
    per_it = max(len(used), 1)
    per_it_mb = (4 * stack + 4 * ns * (2 * nm + 2 * nm - 1) * area / per_it) / 1e6
    say(
        f"msmfs: {len(used)} iterations at {ny}x{nx}, {ns} scales, {nm} moments, "
        f"PSF {py}x{px}: {ms / per_it * 1e3:.2f} us per iteration; the stack "
        f"streamed once per iteration plus the footprint read-modify-write and "
        f"its canvas rows is {per_it_mb:.2f} MB, "
        f"{per_it_mb * 1e6 / PEAK_BYTES_S * 1e6:.2f} us at 3.35 TB/s"
    )
    return out


def run_cube(device):
    """Phase 8: the MSMFS cube. Holds the grid kernel on one channel's
    launch (the cube cycle's per-channel shape). Returns (kernel row of
    msmfs, summed launch counts of 8b and 8c)."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan
    from ska_sdp_func_python_torch.pipeline import continuum_imaging

    t0 = time.perf_counter()
    vis, model = simulate_cube(device, **CUBE)
    torch.cuda.synchronize()
    say(
        f"cube observation: {CUBE['nants']} stations, {vis.nchan} channels, "
        f"{vis.nvis} visibilities, {model.npixel}^2 x {model.nchan} cube, "
        f"simulated in {time.perf_counter() - t0:.1f} s"
    )
    plan = make_visibility_plan(vis, model, context="ng")
    c = vis.nchan // 2
    gp = plan.plans[c].gp
    weighted = (vis.vis * vis.imaging_weight)[:, :, c, 0].reshape(-1).contiguous()
    grid_row(gp, sort_values(gp, weighted), f"cube channel {c} (one channel's launch)")
    row = compare_msmfs(vis, model, plan)
    del plan, gp, weighted
    torch.cuda.empty_cache()
    (current, _, _), counts_b, peaks = run_logged(
        "msmfs continuum_imaging",
        lambda: continuum_imaging(vis, model, nmajor=4, context="ng", **CUBE_CLEAN),
        4, ("grid", "degrid", "msmfs"),
    )
    cube_gates("msmfs continuum_imaging", current, peaks, CUBE["offset"], CUBE["alpha"])
    del current
    corrupted, phases = corrupt(vis, 0.4)
    del vis
    counts_c, peaks, current, _ = run_ical(
        "msmfs ical", corrupted, model, phases, 4,
        ("grid", "degrid", "permute", "msmfs"), **CUBE_CLEAN,
    )
    # printed, not gated: the self-cal residual keeps the calibration error
    cube_gates("msmfs ical", current, peaks, CUBE["offset"], CUBE["alpha"], gate=False)
    return row, {k: counts_b[k] + counts_c[k] for k in counts_b}


def small_cube_matches_cpu(device):
    """Phase 8d: ical with MSMFS (2 moments) on the small cube of the JAX
    package's fused-cube test, with the CUDA kernels and on the CPU, to
    the bounds of phase 7 (gains 1e-4, residual peak 1e-3 relative)."""
    from ska_sdp_func_python_torch.pipeline import ical

    out = {}
    for dev in (device, "cpu"):
        vis, model = simulate_cube(dev, **SMALL_CUBE)
        vis, _ = corrupt(vis, 0.3)
        d, r, _, g = ical(
            vis, model, nmajor=3, calibration_context="T", context="ng",
            algorithm="mmclean", nmoment=2, niter=100, fractional_threshold=0.01,
        )
        gain = g["T"].gain.cpu().numpy()[..., 0, 0, 0]
        out[dev] = (gain * np.exp(-1j * np.angle(gain[:, :1])), d.pixels.cpu(), r.pixels.cpu())
    (ga, da, ra), (gb, db, rb) = out[device], out["cpu"]
    dg = float(np.max(np.abs(ga - gb)))
    res_a, res_b = float(ra.abs().max()), float(rb.abs().max())
    same = bool(((da != 0) == (db != 0)).all())
    say(
        f"small cube mmclean card vs cpu: gain {dg:.2e} (bound 1e-4), residual "
        f"peak {res_a:.6f} vs {res_b:.6f} (bound 1e-3 rel), same component "
        f"pixels {same}, model {float((da - db).abs().max()):.3e} apart"
    )
    if not (dg < 1e-4 and abs(res_a - res_b) < 1e-3 * res_b):
        raise AssertionError("small cube mmclean: card and cpu disagree")


def observation9(cfg, device, dtype, ntimes=76, npixel=1024, source=SOURCE9):
    """Phase 9's observation: the flagship layout and hour angles with
    natural weights, in ``dtype`` on ``device``, holding the exact DFT of
    a 1.0 Jy source at SOURCE9, and the 1024^2 model image holding that
    source. Returns (vis, model, oracle [ntime, nbaseline, 1, 1] complex128
    on the host, the source's (ix, iy))."""
    import torch

    from ska_sdp_func_python_torch.models import create_visibility
    from ska_sdp_func_python_torch.ops import create_image_from_visibility

    vis = create_visibility(
        cfg, np.linspace(-0.3, 0.3, ntimes), [1.2e8],
        elevation_limit=np.deg2rad(15.0), dtype=dtype, device=device,
    )
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=3.0, nchan=1)
    ix, iy = npixel // 2 + source[0], npixel // 2 + source[1]
    oracle = exact_dft(vis, model, ix, iy)
    vis = vis.replace(vis=torch.as_tensor(oracle).to(device=device, dtype=vis.vis.dtype))
    pixels = torch.zeros_like(model.pixels)
    pixels[0, 0, iy, ix] = 1.0
    return vis, model.replace(pixels=pixels), oracle, (ix, iy)


def exact_dft(vis, model, ix, iy):
    """exp(-2 pi i (u l + v m + w (n - 1))) of a 1.0 Jy source at pixel
    (ix, iy), in numpy f64 on the host from the Visibility's own uvw."""
    from ska_sdp_func_python_torch.models.visibility import C_M_S
    from ska_sdp_func_python_torch.utils.coordinates import radec_to_lmn

    ra, dec = model.pixel_to_radec(ix, iy)
    l, m, n1 = radec_to_lmn(ra, dec, *vis.phasecentre)
    f = vis.frequency.cpu().numpy().astype(np.float64)[0] / C_M_S
    uvw = vis.uvw.cpu().numpy().astype(np.float64) * f
    turns = uvw[..., 0] * l + uvw[..., 1] * m + uvw[..., 2] * n1
    return np.exp(-2j * np.pi * turns)[..., None, None]


def unit_stream9(vis, model, eps):
    """The entry stream that ``invert_visibility(vis, model,
    epsilon=eps)`` grids through unit_tiles, built as the core path
    builds it, and its geometry."""
    from ska_sdp_func_python_torch.ops import imaging as im
    from ska_sdp_func_python_torch.ops.accuracy import gridding_params_for_epsilon
    from ska_sdp_func_python_torch.ops.gridding import _es_beta
    from ska_sdp_func_python_torch.ops.gridding_tiled import entry_stream

    acc = gridding_params_for_epsilon(eps, f64=im._is_f64(vis))
    assert acc.gridder == "tiled" or acc.support != 8, acc
    s = acc.support
    npad = im._npad_for(model.npixel, acc.padding)
    nw = im._nw_wkernel_for(vis, model, s)
    if acc.coords == "host64":
        u, ulo, v, vlo, w = im._prepix_rows(vis, model, slice(0, 1), npad)
    else:
        uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
        u, v = im._pixels(uvw[:, 0], uvw[:, 1], npad, model.cellsize, False)
        ulo = vlo = None
        w = uvw[:, 2]
    p0, frac, _ = im._w_planes(w, nw, "eskernel", w_support=s)
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    geo = dict(npixel=npad, tile=im._tile_for(npad), support=s,
               beta=_es_beta(s, npad / model.npixel))
    stream = entry_stream(
        u, v, weighted, p0, frac, ulo, vlo, npixel=npad, support=s,
        nplanes=nw, tile=geo["tile"], unit=im._UNIT_GRID, w_order=s,
    )
    return stream, geo


def compare_unit_tiles(stream, geo, label, tol, peak_ops):
    """unit_tiles against its plain version accumulated in f64 on the
    same stream; times both. Returns the kernel row."""
    import dataclasses

    import torch

    def f64(x):
        return None if x is None else x.to(torch.float64)

    ref_stream = dataclasses.replace(
        stream, u=f64(stream.u), v=f64(stream.v), u_lo=f64(stream.u_lo),
        v_lo=f64(stream.v_lo), vals=stream.vals.to(torch.complex128),
    )
    out = stream.grid(**geo)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = ref_stream.grid(plain=True, **geo)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((out.to(torch.complex128) - ref).abs().max())
    rel = err / float(ref.abs().max())
    del ref, out
    n = int(stream.u.shape[0])
    nunits = int(stream.unit_seg.shape[0])
    s = geo["support"]
    real = stream.u.element_size()
    # bytes: every sorted entry's coordinates, residuals and value read
    # once, the unit table read once, every plane grid written once;
    # operations (window form): per entry 2 s ES taps (about 10 operations
    # each) and s^2 tap products of a complex value by two real taps added
    # into the tile (6 operations)
    nbytes = (
        n * (real * (2 + (2 if stream.u_lo is not None else 0)) + 2 * real)
        + 12 * nunits + stream.nplanes * geo["npixel"] ** 2 * 2 * real
    )
    row = _row(
        err, rel, timed(lambda: stream.grid(**geo), 5), plain_ms,
        bound(nbytes, n * (6 * s * s + 20 * s), peak_ops),
    )
    say(
        f"unit_tiles {label}: {n} entries in {nunits} units of at most "
        f"{int(stream.unit_count.max())}, {stream.nplanes} planes of "
        f"{geo['npixel']}^2, tile {geo['tile']}, support {s}: max abs err "
        f"{err:.3e}, rel {rel:.3e} (tolerance {tol:g}); kernel {row['ms']:.3f} "
        f"ms, plain (f64, one run) {plain_ms:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
    )
    if not rel <= tol:
        raise AssertionError(f"unit_tiles {label} disagrees with its plain version")
    return row


def run_epsilon(label, vis, model, oracle, source, eps, path_kernels):
    """predict_visibility and invert_visibility with ``epsilon=eps`` on the
    card, the launch counters reset just before and read just after;
    gates the delivered predict error against the exact DFT (< eps), the
    dirty image's peak on the source pixel and the path's launches.
    Returns the counts."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        predict_visibility,
    )

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pv = predict_visibility(vis, model, epsilon=eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dirty, _ = invert_visibility(vis, model, epsilon=eps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    err = float(np.max(np.abs(pv.vis.cpu().numpy().astype(np.complex128) - oracle)))
    img = dirty.pixels[0, 0].double().cpu().numpy()
    iy, ix = np.unravel_index(int(np.argmax(img)), img.shape)
    say(
        f"{label} (epsilon {eps:g}, {tuple(vis.vis.shape)} {vis.vis.dtype}): "
        f"predict {(t1 - t0) * 1e3:.1f} ms, delivered max error vs the exact "
        f"DFT {err:.4e}; invert {(t2 - t1) * 1e3:.1f} ms, peak {img[iy, ix]:.6f} "
        f"at ({ix}, {iy}) (source at {source}); launches {counts}"
    )
    if not np.isfinite(img).all() or not err < eps:
        raise AssertionError(f"{label}: delivered error {err} not below {eps}")
    if (ix, iy) != tuple(source):
        raise AssertionError(f"{label}: dirty peak at {(ix, iy)}, source at {source}")
    _launch_gate(label, counts, path_kernels)
    return counts


def run_plan_cache(vis, model):
    """Phase 9e: invert_visibility and predict_visibility without a plan,
    twice each: the second call of each reuses the plan the first put
    into the cache. Held to an explicit plan at padding 2 (the padding of
    a cache miss): predict bit for bit, invert to 1e-5 of its peak (the
    grid kernel's atomics). Returns the counts of the four calls."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops import imaging as im

    im._PLAN_CACHE.clear()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls, plans = [], []
    for fn in (im.invert_visibility, im.invert_visibility,
               im.predict_visibility, im.predict_visibility):
        t0 = time.perf_counter()
        out = fn(vis, model)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        plans.append([p for _, _, p in im._PLAN_CACHE.values()])
        if fn is im.invert_visibility:
            dirty = out[0].pixels
        else:
            pred = out.vis
    counts = kernels.launch_counts()
    if not all(len(p) == 1 and p[0] is plans[0][0] for p in plans):
        raise AssertionError("plan cache: the calls did not share one cached plan")
    explicit = im.make_visibility_plan(vis, model, padding=2)
    pred_e = im.predict_visibility(vis, model, plan=explicit).vis
    dirty_e = im.invert_visibility(vis, model, plan=explicit)[0].pixels
    same = torch.equal(pred, pred_e)
    derr = float((dirty - dirty_e).abs().max() / dirty_e.abs().max())
    p0 = explicit.plans[0]
    say(
        f"plan cache: invert {walls[0]:.1f} then {walls[1]:.1f} ms, predict "
        f"{walls[2]:.1f} then {walls[3]:.1f} ms (npad {p0.npad}, nw {p0.nw}); "
        f"predict equals the explicit-plan predict bit for bit: {same}; "
        f"invert {derr:.3e} of the peak from the explicit-plan invert; "
        f"launches {counts}"
    )
    im._PLAN_CACHE.clear()
    if not same or not derr <= 1e-5:
        raise AssertionError("plan cache: the cached plan disagrees with the explicit one")
    _launch_gate("plan cache", counts, ("grid", "degrid", "permute"))
    return counts


def run_epsilon_phase(cfg, device, **size):
    """Phase 9 (``size``: observation9's ntimes, npixel and source).
    Returns (unit_tiles kernel row, summed launch counts of 9b-e)."""
    import torch

    from ska_sdp_func_python_torch.ops import imaging as im

    t0 = time.perf_counter()
    vis, model, oracle, source = observation9(cfg, device, torch.float32, **size)
    say(f"epsilon observation: {vis.nvis} visibilities, f32, simulated in {time.perf_counter() - t0:.1f} s")
    stream, geo = unit_stream9(vis, model, EPS_FAST)
    row = compare_unit_tiles(stream, geo, "fast-f32 stream (f32)", KERNELS["unit_tiles"][0], PEAK_F32_S)
    del stream
    torch.cuda.empty_cache()
    counts = [
        run_epsilon("9b fast-f32", vis, model, oracle, source, EPS_FAST, ("unit_tiles",)),
        run_epsilon("9c precise-f32", vis, model, oracle, source, EPS_PRECISE,
                    ("grid", "degrid", "permute")),
    ]
    im._PLAN_CACHE.clear()
    counts.append(run_plan_cache(vis, model))
    del vis, model, oracle
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vis, model, oracle, source = observation9(cfg, device, torch.float64, **size)
    say(f"epsilon observation: {vis.nvis} visibilities, f64, simulated in {time.perf_counter() - t0:.1f} s")
    stream, geo = unit_stream9(vis, model, EPS_DEEP)
    compare_unit_tiles(stream, geo, "deep-f64 stream (f64)", UNIT_TILES_F64_TOL, PEAK_F64_S)
    del stream
    torch.cuda.empty_cache()
    counts.append(run_epsilon("9d deep-f64", vis, model, oracle, source, EPS_DEEP, ("unit_tiles",)))
    del vis, model, oracle
    torch.cuda.empty_cache()
    return row, {k: sum(c[k] for c in counts) for k in counts[0]}


def report_kernel(name, r):
    """Prints a kernel's comparison with its plain version, and fails if
    the error is above its tolerance."""
    tol = KERNELS[name][0]
    ok = r["rel"] <= tol
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
    say(
        f"kernel {name}: max abs err {r['max_abs_err']:.3e}, rel err "
        f"{r['rel']:.3e} (tolerance {tol:g}) {'ok' if ok else 'FAIL'}; "
        f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}"
    )
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain version")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )
    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(
        f"host: {host_cpu()}, {torch.get_num_threads()} threads, "
        f"{torch.backends.cpu.get_cpu_capability()}, MKL_CBWR={os.environ['MKL_CBWR']}"
    )

    t0 = time.perf_counter()
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say(f"build: {line.strip()}")

    t0 = time.perf_counter()
    cfg, vis, model, phases = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    torch.cuda.synchronize()
    say(
        f"observation: {cfg.nants} stations, {vis.nvis} visibilities, "
        f"{model.npixel}^2 image, simulated in {time.perf_counter() - t0:.1f} s"
    )
    plan = make_visibility_plan(vis, model, context="ng")
    p0 = plan.plans[0]
    say(f"plan: npad {p0.npad}, nw {p0.nw}, tile {p0.gp.tile}, in-grid {p0.gp.n_in}/{p0.gp.n}")
    dirty, _ = invert_visibility(vis, model, plan=plan)
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    psf_patch = bound_psf(psf, psf).pixels.to(torch.float32)

    results = compare_gridding(device, vis, plan)
    results.update(compare_cleaners(dirty.pixels[0, 0].to(torch.float32), psf_patch))
    for name, r in results.items():
        report_kernel(name, r)
    del psf_patch, plan
    torch.cuda.empty_cache()

    launches = {name: 0 for name in KERNELS}
    by_shape = {}
    for counts in (
        run_hogbom_ical(vis, model, phases),
        run_msclean_ical(vis, model, phases),
        run_deconvolve_cube(dirty, psf),
    ):
        for name in launches:
            launches[name] += counts[name]
    by_shape["flagship ical and deconvolve_cube (phases 4-6)"] = dict(launches)
    del dirty, psf
    small_slice_matches_cpu(device, "hogbom")
    # msclean to a fractional threshold of 0.05: at 0.01 this small array's
    # clean goes on to PSF-sidelobe structure where peaks tie to 1e-5, below
    # the f32 difference between the card's and the CPU's dirty images
    small_slice_matches_cpu(device, "msclean", fractional_threshold=0.05)
    del vis, model
    torch.cuda.empty_cache()

    results["msmfs"], counts = run_cube(device)
    for name in launches:
        launches[name] += counts[name]
    by_shape["config-4 cube (phases 8b-c)"] = counts
    report_kernel("msmfs", results["msmfs"])
    small_cube_matches_cpu(device)
    torch.cuda.empty_cache()

    results["unit_tiles"], counts = run_epsilon_phase(cfg, device)
    for name in launches:
        launches[name] += counts[name]
    by_shape["epsilon observation (phases 9b-e)"] = counts
    report_kernel("unit_tiles", results["unit_tiles"])
    for shape, counts in by_shape.items():
        say(f"launches at the {shape}: grid {counts['grid']}, unit_tiles {counts['unit_tiles']}")

    say(json.dumps({
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNELS[name][1],
                "replaces": KERNELS[name][2],
                "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"],
                "bound_ms": results[name]["bound_ms"],
                "bound_by": results[name]["bound_by"],
                "library_ms": results[name]["library_ms"],
            }
            for name in KERNELS
        ]
    }))
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
