"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's main path, the fused ICAL self-cal major cycle, at the
flagship size: SKA-LOW (512 stations within 40 km), 76 integrations at
120 MHz (~9.9M visibilities), a 1024^2 image, "T" phase-only calibration
and Hogbom CLEAN (niter 300, gain 0.2, fractional threshold 0.01).

Phases, each on lines of its own:
  1. device: the card's name and power limit;
  2. build: compiles the four CUDA kernels from csrc/ and times the build;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at the main path's geometry, with both times;
  4. slice: simulates the observation on the card, corrupts it with
     N(0, 0.4) phases, runs ``ical`` with the launch counters reset, and
     prints the per-cycle wall time and peak residual and the gain error;
  5. small slice: the same ical on a small observation on the card and on
     the CPU (plain versions), held to the JAX package's fused-vs-composed
     bounds.
It then prints the kernels JSON line, the card line, and, last, the
``{"ok": true, ...}`` line. Any failure raises and exits non-zero; without
a CUDA device it exits non-zero before printing any result.

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
# elements and must be bit-exact; hogbom: the same f32 operations in the
# same order.
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
}
CLEAN = dict(algorithm="hogbom", niter=300, gain=0.2, fractional_threshold=0.01)


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
    for dx, dy, f in [(0, 0, 2.0), (60, -40, 1.2), (-80, 30, 0.8)]:
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


def compare_kernels(device, vis, model, plan, dirty, psf_patch):
    """Phase 3: each kernel against its plain version on the card at the
    main path's geometry. Returns {name: (max_abs_err, rel_err, ms,
    plain_ms)}."""
    import torch

    from ska_sdp_func_python_torch.ops.cleaners import hogbom_lanes
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
    out["grid"] = (
        err, err / float(ref.abs().max()),
        timed(lambda: grid(sub, vals), 10),
        timed(lambda: grid_plain(sub, vals), 3),
    )
    grids = torch.randn(ref.shape, generator=g, device=device, dtype=torch.complex64)
    ref = degrid_plain(sub, grids)
    res = degrid(sub, grids)
    err = float((res - ref).abs().max())
    out["degrid"] = (
        err, err / float(ref.abs().max()),
        timed(lambda: degrid(sub, grids), 10),
        timed(lambda: degrid_plain(sub, grids), 3),
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
    out["permute"] = (
        0.0, 0.0,
        timed(lambda: permute_apply(perm, x, inverse=True), 20),
        timed(lambda: permute_apply_plain(perm, x, inverse=True), 5),
    )
    # hogbom: the cycle-0 residual (the dirty image) and the bounded PSF
    d = dirty.reshape(1, *dirty.shape[-2:]).contiguous()
    p = psf_patch.reshape(1, *psf_patch.shape[-2:]).contiguous()
    kw = dict(
        gain=CLEAN["gain"], thresh=0.0, niter=CLEAN["niter"],
        fracthresh=CLEAN["fractional_threshold"],
    )
    kc, kr = hogbom_lanes(d, p, **kw)
    pc, pr = _hogbom_plain_on_card(d, p, kw)
    if not torch.equal(kc != 0, pc != 0):
        raise AssertionError("hogbom: component positions differ")
    err = float((kc - pc).abs().max())
    rel = float(((kc - pc).abs() / pc.abs().clamp(min=1e-30))[pc != 0].max())
    out["hogbom"] = (
        err, rel,
        timed(lambda: hogbom_lanes(d, p, **kw), 5),
        timed(lambda: _hogbom_plain_on_card(d, p, kw), 5),
    )
    return out


def _hogbom_plain_on_card(d, p, kw):
    """The plain Hogbom loop, run on the card's tensors."""
    import torch

    from ska_sdp_func_python_torch.ops.cleaners import (
        _rows_to_image,
        hogbom_rows_plain,
    )

    rows, res = hogbom_rows_plain(d[0], p[0], **kw)
    return _rows_to_image(rows[None], *d.shape[-2:]), res[None]


class _CycleLog(logging.Handler):
    """Collects the per-cycle log records of the port's ical with their
    arrival times (each record follows a device sync on the peak)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.events = []

    def emit(self, record):
        self.events.append((time.perf_counter(), record.getMessage()))


def run_slice(device, vis, model, phases):
    """Phase 4: the user-facing ical on the card, launch counters reset
    just before it and read just after."""
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
    _, residual, restored, gts = ical(
        vis, model, nmajor=4, calibration_context="T", context="ng", **CLEAN
    )
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.launch_counts()
    logger.removeHandler(handler)
    say(f"slice: ical total {total:.3f} s, launches {counts}")
    peaks = []
    prev = None
    for t, msg in handler.events:
        if "cycle" in msg and prev is not None:
            peaks.append(float(msg.rsplit(" ", 1)[1]))
            say(f"slice: {msg.split(': ', 1)[1]}, wall {(t - prev) * 1e3:.1f} ms")
        prev = t
    gmax, grms = gain_phase_error(gts["T"].gain, phases)
    rpeak = float(restored.pixels.max())
    say(
        f"slice: gain phase error vs truth max {gmax:.3e} rad, rms {grms:.3e} "
        f"rad; restored peak {rpeak:.4f} (source 2.0 Jy); final residual "
        f"peak {float(residual.pixels.abs().max()):.4e}"
    )
    if not all(np.isfinite(peaks)) or len(peaks) != 4:
        raise AssertionError(f"per-cycle peaks missing or not finite: {peaks}")
    if not peaks[-1] < peaks[0]:
        raise AssertionError(f"peak residual did not fall: {peaks}")
    if not abs(rpeak - 2.0) < 0.2:
        raise AssertionError(f"restored peak {rpeak} not within 0.2 of 2.0")
    if not torch.isfinite(restored.pixels).all():
        raise AssertionError("restored image is not finite")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return counts


def small_slice_matches_cpu(device):
    """Phase 5: ical on a small observation with the CUDA kernels and on
    the CPU with the plain versions (which the CPU tests hold against the
    JAX package), to the JAX package's fused-vs-composed bounds."""
    from ska_sdp_func_python_torch.pipeline import ical

    out = {}
    for dev in (device, "cpu"):
        _, vis, model, _ = simulate(dev, rmax=600.0, ntimes=8, npixel=256)
        d, r, s, g = ical(
            vis, model, nmajor=3, calibration_context="T", context="ng", **CLEAN
        )
        gain = g["T"].gain.cpu().numpy()[..., 0, 0, 0]
        out[dev] = (
            gain * np.exp(-1j * np.angle(gain[:, :1])),
            float(r.pixels.abs().max()),
            float(s.pixels.max()),
        )
    (ga, ra, sa), (gb, rb, sb) = out[device], out["cpu"]
    dg = float(np.max(np.abs(ga - gb)))
    say(
        f"small slice card vs cpu: gain {dg:.2e} (bound 1e-4), residual peak "
        f"{ra:.6f} vs {rb:.6f} (bound 1e-3 rel), restored {sa:.4f} vs "
        f"{sb:.4f} (bound 0.05)"
    )
    if not (dg < 1e-4 and abs(ra - rb) < 1e-3 * rb and abs(sa - sb) < 0.05):
        raise AssertionError("small slice: card and cpu disagree")


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

    results = compare_kernels(device, vis, model, plan, dirty.pixels[0, 0], psf_patch)
    for name, (err, rel, ms, plain_ms) in results.items():
        tol = KERNELS[name][0]
        ok = rel <= tol
        say(
            f"kernel {name}: max abs err {err:.3e}, rel err {rel:.3e} "
            f"(tolerance {tol:g}) {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms"
        )
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain version")
    del dirty, psf, psf_patch, plan
    torch.cuda.empty_cache()

    counts = run_slice(device, vis, model, phases)
    small_slice_matches_cpu(device)

    say(json.dumps({
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNELS[name][1],
                "replaces": KERNELS[name][2],
                "launches": counts[name],
                "max_abs_err": results[name][0],
                "ms": results[name][2],
                "plain_ms": results[name][3],
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
