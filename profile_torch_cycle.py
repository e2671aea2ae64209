"""Stage breakdown and device busy share of the port's fused ICAL cycle.

Builds the flagship observation of ``chip_smoke.py`` (SKA-LOW 512 stations,
76 integrations, 1024^2 image) on one CUDA device, with the chosen CLEAN
(msclean, the default, or hogbom), or with ``--algorithm mmclean`` the
MSMFS cube of ``chip_smoke.py`` (BASELINE config 4: 256 stations, 64
channels, 18.8M visibilities, a 256^2 cube, 3 moments) corrupted with
N(0, 0.4) "T" phases; runs four major cycles of
``pipeline._fused_selfcal_cycle`` (printing each cycle's wall time and
StefCal iteration count), times each stage of a steady cycle on its own
(synchronised, averaged; predict and the permutes one launch each over
all image channels, the invert stages summed over the channels), and
profiles one more cycle with ``torch.profiler``. From that trace it
prints:

  - the cycle's wall time: the span of a ``record_function`` range that
    ends after a device synchronise;
  - the device busy time: the union of the kernel, memcpy and memset
    intervals inside that span (overlapping kernels count once), and the
    idle share 1 - busy / wall;
  - the device time by kernel name, with its launches and mean time per
    launch (for the grid kernel: one launch per image channel).

The chrome trace is written to ``<out>/cycle_trace.json``.

Usage: python3 profile_torch_cycle.py [--out DIR] [--algorithm msclean|hogbom|mmclean]
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch

import chip_smoke as cs
from ska_sdp_func_python_torch import pipeline as P
from ska_sdp_func_python_torch.ops import solvers
from ska_sdp_func_python_torch.ops.calibration_chain import (
    create_calibration_controls,
)
from ska_sdp_func_python_torch.ops.gridding_plan import grid_with_plan
from ska_sdp_func_python_torch.ops.imaging import (
    invert_with_plan,
    make_visibility_plan,
    predict_with_stack,
    uv_grids_to_dirty,
)
from ska_sdp_func_python_torch.ops.permute import permute_apply

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def stage(name, fn, reps=5):
    """Mean wall time of ``fn`` in ms, synchronised, after one warm-up."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    print(f"stage {name}: {(time.perf_counter() - t0) * 1e3 / reps:.3f} ms")
    return out


def busy_in(trace_path, window="cycle"):
    """(wall_us, busy_us, {kernel: us}, {kernel: launches}) of the
    ``window`` range of a chrome trace; busy is the union of device
    intervals clipped to the window."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    win = [
        e for e in events
        if e.get("ph") == "X" and e.get("name") == window
        and e.get("cat") == "user_annotation"
    ]
    if len(win) != 1:
        raise RuntimeError(f"expected one '{window}' range, found {len(win)}")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    spans, by_name, count = [], defaultdict(float), defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b > a:
            spans.append((a, b))
            by_name[e["name"]] += b - a
            count[e["name"]] += 1
    if not spans:
        raise RuntimeError("no device activity in the profiled cycle")
    spans.sort()
    busy, cur_a, cur_b = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return hi - lo, busy, dict(by_name), dict(count)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile", help="trace directory")
    ap.add_argument(
        "--algorithm", default="msclean", choices=("msclean", "hogbom", "mmclean"),
        help="the CLEAN lane of the cycle",
    )
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cycle: no CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    print(cs.card_line())

    if args.algorithm == "mmclean":
        vis, model = cs.simulate_cube(dev, **cs.CUBE)
        vis, _ = cs.corrupt(vis, 0.4)
        clean = cs.CUBE_CLEAN
    else:
        _, vis, model, _ = cs.simulate(dev, rmax=40000.0, ntimes=76, npixel=1024)
        clean = dict(algorithm=args.algorithm, scales=cs.SCALES, **cs.CLEAN)
    plan = make_visibility_plan(vis, model, context="ng")
    ws = P._FusedSelfCal(
        vis, model, plan, None, ["T"], create_calibration_controls(), "mean",
        200, 1e-6, **clean,
    )
    gains = [ws.gt0s[0].gain]
    gwts = [ws.gt0s[0].weight]
    gress = [ws.gt0s[0].residual]
    mp = torch.zeros_like(model.pixels, dtype=torch.float32)

    calls = [0]
    substitution = solvers._gain_substitution_scalar

    def counted(*a, **k):
        calls[0] += 1
        return substitution(*a, **k)

    solvers._gain_substitution_scalar = counted
    for c in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp, gains, gwts, gress, _, _, peak = P._fused_selfcal_cycle(
            ws, mp, gains, gwts, gress, do_cal=(True,), with_model=c > 0
        )
        peak = float(peak)
        print(
            f"cycle {c}: {(time.perf_counter() - t0) * 1e3:.2f} ms, StefCal "
            f"iterations {calls[0]}, peak residual {peak:.6f}"
        )
        calls[0] = 0
    solvers._gain_substitution_scalar = substitution

    # each stage runs over every image channel (polarisation 0, stokesI):
    # predict and the permutes as one launch for all channels, the invert
    # leg channel by channel
    plans = plan.plans
    chans = range(len(plans))
    perm = plan.stack.perm
    ms = stage(
        "predict (fft head + degrid)",
        lambda: predict_with_stack(plan, mp[:, 0], to_sorted=True),
    )
    mv = stage(
        "permute model -> natural",
        lambda: permute_apply(plan.stack.iperm, ms),
    )
    ntime = ws.cal[0]["w_t"].shape[1]
    mvis = mv.reshape(len(plans), ntime, -1).permute(1, 2, 0)[..., None]
    inv = stage(
        "solve (normal equations + StefCal + factors)",
        lambda: P._solve_terms(ws, ws.cfg, gains, gwts, gress, (True,), mvis),
        reps=2,
    )[3]
    fac = inv[:, :, 0, 0].reshape(-1).contiguous()
    f = stage("permute factors -> plan", lambda: permute_apply(perm, fac, shared=(0,)))
    rs = ws.obs_s[0] * f - ms
    d = stage(
        "invert (grid + fft tail)",
        lambda: [
            invert_with_plan(plans[c], rs[c], ws.wgt_s[0][c], values_sorted=True)
            for c in chans
        ],
    )
    gr = stage(
        "  grid only",
        lambda: [
            grid_with_plan(plans[c].gp, rs[c] * ws.wgt_s[0][c], values_sorted=True)
            for c in chans
        ],
    )
    stage("  fft tail only", lambda: [uv_grids_to_dirty(plans[c], gr[c]) for c in chans])
    resid = torch.stack([di / sw for di, sw in d])[:, None].to(torch.float32)
    stage(f"{args.algorithm} lane", lambda: P._fused_clean(resid, ws, ws.cfg), 3)

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("cycle"):
            P._fused_selfcal_cycle(
                ws, mp, gains, gwts, gress, do_cal=(True,), with_model=True
            )
            torch.cuda.synchronize()
    trace = out_dir / "cycle_trace.json"
    prof.export_chrome_trace(str(trace))
    wall, busy, by_name, count = busy_in(trace)
    print(
        f"profiled cycle: wall {wall / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms (union of kernel intervals), idle share "
        f"{1 - busy / wall:.4f}"
    )
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(
            f"  {us / 1e3:9.3f} ms  {100 * us / total:5.1f}%  {count[name]:5d} x "
            f"{us / 1e3 / count[name]:8.4f} ms  {name[:70]}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
