"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's paths at the flagship size: SKA-LOW (512 stations
within 40 km), 76 integrations at 120 MHz (~9.9M visibilities), a 1024^2
image, "T" phase-only calibration, CLEAN niter 300, gain 0.2, fractional
threshold 0.01.

Phases, each on lines of its own:
  1. device: the card's name and power limit;
  2. build: compiles the CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and times the build;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at the main path's geometry, with both times, the kernel's bound
     (the least time the card could take for the same work) and, where one
     PyTorch call computes the same function, that call's time; the
     windowed Hogbom is checked against its plain version too;
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
     fused-vs-composed bounds.
Each of phases 4-6 resets the launch counters just before it and fails
unless every kernel of its path launched. The script then prints the
kernels JSON line (launches summed over phases 4-6), the card line, and,
last, the ``{"ok": true, ...}`` line. Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before printing any
result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import time

import numpy as np

# kernel: (tolerance on the max error relative to the plain version's
# maximum, source, the TPU kernel it replaces). grid: held against the
# plain version accumulated in f64, since atomics change the f32 summation
# order from run to run; degrid: f32 sums in another order; permute moves
# elements and must be bit-exact; hogbom, msclean and hogbom_complex: the
# same f32 operations in the same order.
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
}
CLEAN = dict(niter=300, gain=0.2, fractional_threshold=0.01)
SCALES = [0, 3, 10, 30]
# source pixel offsets (dx, dy) from the centre at 1024^2, and fluxes (Jy)
SOURCES = [(0, 0, 2.0), (60, -40, 1.2), (-80, 30, 0.8)]
# polarisation of the deconvolve_cube sky: fraction, angle, circular
POL_P, POL_CHI, POL_V = 0.2, np.deg2rad(30.0), 0.02

# NVIDIA H100 SXM published peaks at 700 W: HBM and f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def bound(nbytes, nops):
    """(ms, what bounds it): the larger of the bytes over the card's memory
    rate and the f32 operations over its peak f32 rate."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_S * 1e3
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


def compare_gridding(device, vis, plan):
    """grid, degrid and permute against their plain versions at the main
    path's geometry."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import (
        degrid,
        degrid_plain,
        grid,
        grid_plain,
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
    # the main path's grid input: weighted visibilities in plan order
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    vals = sort_values(sub, weighted[:n_sub])
    # reference: the plain version accumulated in f64 (its f32 form sums
    # up to ~1e5 terms per cell one by one and is the less accurate side)
    ref = grid_plain(sub, vals.to(torch.complex128))
    res = grid(sub, vals)
    err = float((res - ref).abs().max())
    grids_bytes = sub.nplanes * sub.npixel**2 * 8
    # per entry: value, corner, plane fraction and 2 x 8 taps in; per tap
    # one tap product and, on each of two planes, a complex scale and add
    entry_bytes = 8 + 4 + 4 + 4 + 32 + 32
    out["grid"] = _row(
        err, err / float(ref.abs().max()),
        timed(lambda: grid(sub, vals), 10),
        timed(lambda: grid_plain(sub, vals), 3),
        bound(sub.n * entry_bytes + 12 * sub.chunk_seg.shape[0] + grids_bytes,
              sub.n_in * (64 * 9 + 5)),
    )
    grids = torch.randn(ref.shape, generator=g, device=device, dtype=torch.complex64)
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
    del ref, res, grids, vals
    full_vals = torch.randn(
        full.gp.n, generator=g, device=device, dtype=torch.complex64
    )
    full_grids = torch.randn(
        (full.nw, full.npad, full.npad), generator=g, device=device,
        dtype=torch.complex64,
    )
    grid_ms = timed(lambda: grid(full.gp, full_vals), 5)
    degrid_ms = timed(lambda: degrid(full.gp, full_grids), 5)
    say(
        f"full-size kernel times ({full.gp.n} entries, {full.nw} planes of "
        f"{full.npad}^2): grid {grid_ms:.3f} ms, degrid {degrid_ms:.3f} ms"
    )
    del full_vals, full_grids
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


def run_ical(label, vis, model, phases, nmajor, path_kernels, **kw):
    """The user-facing ical on the card, launch counters reset just before
    it and read just after. Returns (counts, peaks, model, restored)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.pipeline import ical

    handler = _CycleLog()
    logger = logging.getLogger("ska-sdp-func-python-torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    current, residual, restored, gts = ical(
        vis, model, nmajor=nmajor, calibration_context="T", context="ng", **kw
    )
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.launch_counts()
    logger.removeHandler(handler)
    say(f"{label}: ical total {total:.3f} s, launches {counts}")
    peaks = []
    prev = None
    for t, msg in handler.events:
        if "cycle" in msg and prev is not None:
            peaks.append(float(msg.rsplit(" ", 1)[1]))
            say(f"{label}: {msg.split(': ', 1)[1]}, wall {(t - prev) * 1e3:.1f} ms")
        prev = t
    gmax, grms = gain_phase_error(gts["T"].gain, phases)
    rpeak = float(restored.pixels.max())
    say(
        f"{label}: gain phase error vs truth max {gmax:.3e} rad, rms {grms:.3e} "
        f"rad; restored peak {rpeak:.4f} (source 2.0 Jy); final residual "
        f"peak {float(residual.pixels.abs().max()):.4e}"
    )
    if not all(np.isfinite(peaks)) or len(peaks) != nmajor:
        raise AssertionError(f"{label}: per-cycle peaks missing or not finite: {peaks}")
    if not peaks[-1] < peaks[0]:
        raise AssertionError(f"{label}: peak residual did not fall: {peaks}")
    if not torch.isfinite(restored.pixels).all():
        raise AssertionError(f"{label}: restored image is not finite")
    _launch_gate(label, counts, path_kernels)
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

    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

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
    del psf_patch, plan
    torch.cuda.empty_cache()

    launches = {name: 0 for name in KERNELS}
    for counts in (
        run_hogbom_ical(vis, model, phases),
        run_msclean_ical(vis, model, phases),
        run_deconvolve_cube(dirty, psf),
    ):
        for name in launches:
            launches[name] += counts[name]
    del dirty, psf
    small_slice_matches_cpu(device, "hogbom")
    # msclean to a fractional threshold of 0.05: at 0.01 this small array's
    # clean goes on to PSF-sidelobe structure where peaks tie to 1e-5, below
    # the f32 difference between the card's and the CPU's dirty images
    small_slice_matches_cpu(device, "msclean", fractional_threshold=0.05)

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
