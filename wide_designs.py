"""K1's and K3's wide variants (windows of 17 to 64 cells) of this
checkout timed in turns beside those of other checkouts, on one NVIDIA GPU.

Each ``--other DIR`` is a checkout, or a copy of its
``ska_sdp_func_python_torch/csrc``, whose C entry points ``ska_grid`` and
``ska_degrid`` take this package's arguments: an earlier design, or a copy
of one with a passage changed to see where its time goes. Each one's
``grid.cu`` and ``degrid.cu`` are built with ``nvcc`` for ``sm_90a`` (the
package's flags, all builds started together) into
``build/wide_designs/``, each under the name of its directory.

On the flagship's plans at ``chip_smoke.SUPPORTS16`` (the full stream, or
its first 1,048,576 entries), or with ``--phase18`` on phase 18a's (the
whole stream at ``chip_smoke.SUPPORTS18`` with one tile the 1344^2 grid,
``chip_smoke.TILE18``: K1's route 4 only, beside the package's K1w at the
imaging API's tile) and 18b's (its first 1,048,576 entries at the
(support, tile) of ``chip_smoke.WIDE18``, windows past 64 cells, linear
and nearest planes: K1's route 4 and K3's long-window kernel), the script
times, with CUDA events over 10 (K1) or 20 (K3) launches after a warm-up,
the others, the package twice, then the others in reverse order, and
prints each other's largest difference from the package over the
package's maximum, the launch geometry, the walk-order statistics of
each plan and each kernel's bound and the package's time over it.
With ``--ical`` it then runs the flagship Hogbom ``ical`` at
``chip_smoke.ICAL16`` (padding ``chip_smoke.ICAL16_PADDING``, 4 cycles) on
the first other's kernels, the package's twice and the first other's
again, printing each cycle's wall and K1's and K3's device time a launch.

Usage: python3 wide_designs.py --other DIR [DIR ...] [--phase18] [--ical]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "wide_designs"
CSRC = Path("ska_sdp_func_python_torch") / "csrc"


def build(others: list[Path], sources=("grid", "degrid"), out: Path = OUT) -> dict:
    """Compile each other checkout's ``sources`` (``grid.cu`` and
    ``degrid.cu`` by default), each into its own shared library under
    ``out``; returns {(name, source): ctypes library}."""
    from ska_sdp_func_python_torch import kernels

    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for tree in others:
        inc = tree / CSRC if (tree / CSRC).is_dir() else tree
        for src in sources:
            so = out / f"{tree.name}_{src}.so"
            cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, f"-I{inc}", "-shared",
                   "-o", str(so), str(inc / f"{src}.cu")]
            jobs[tree.name, src] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def bind(lib, kernel):
    """``kernel``'s C entry point in ``lib``, typed as the package binds it."""
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = [*kernel.argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def walk_stats(gp):
    """Of consecutive walk positions (korder), the share on one plane and
    one window corner; the mean entries on one (plane, corner); the
    segments."""
    import torch

    k = gp.korder.long()
    u, v, p = gp.iu0[k], gp.iv0[k], gp.plane[k]
    same = (u[1:] == u[:-1]) & (v[1:] == v[:-1]) & (p[1:] == p[:-1])
    n = max(1, k.numel() - 1)
    corners = int(same.numel() - same.sum()) + 1
    return (float(same.sum()) / n, k.numel() / corners,
            int(torch.unique(gp.chunk_seg).numel()))


def main() -> int:
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.gridding_fused import degrid, grid
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_imaging_plan, make_visibility_plan

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="+", required=True,
                    help="checkouts (or csrc copies) of other designs")
    ap.add_argument("--phase18", action="store_true",
                    help="phase 18b's plans (windows past 64 cells) in place of phase 16a's")
    ap.add_argument("--ical", action="store_true", help="also time the support-24 ical")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wide_designs: no CUDA device; nothing was run")
    others = [o.resolve() for o in args.other]
    if len({o.name for o in others} | {"package"}) != len(others) + 1:
        raise SystemExit("wide_designs: each --other needs a name of its own, not 'package'")
    t0 = time.perf_counter()
    card = cs.card_line()
    cs.say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    lib = kernels.load_library()
    libs = build(others)
    cs.say(f"builds: {time.perf_counter() - t0:.1f} s")
    kg, kd = kernels.KERNELS["grid"], kernels.KERNELS["degrid"]
    designs = {"package": (bind(lib, kg), bind(lib, kd))}
    for o in others:
        designs[o.name] = (bind(libs[o.name, "grid"], kg), bind(libs[o.name, "degrid"], kd))

    def use(name):
        kg._fn, kd._fn = designs[name]

    device = torch.device("cuda", 0)
    _, vis, model, phases = cs.simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    n_sub = min(1 << 20, uvw.shape[0])
    p0 = make_visibility_plan(vis, model, context="ng").plans[0]
    geometry = dict(npixel=p0.npixel, cellsize=p0.cellsize, nw=p0.nw, padding=p0.npad / p0.npixel,
                    w_range=(float(uvw[:, 2].min()), float(uvw[:, 2].max())))
    del p0
    names = [o.name for o in others]
    turns = (*names, "package", "package", *reversed(names))

    def plans():
        """(label, plan, sorted values) of each cell, one at a time."""
        if args.phase18:
            base = cs.flagship_geometry(vis, model)
            for support in cs.SUPPORTS18:
                geo = cs.at_support(base, support)
                ref_tile = 56 if support <= 56 else 64
                use("package")
                ref_gp = cs.flagship_grid_plan(vis, geo, ref_tile)
                ref_vals = sort_values(ref_gp, weighted)
                ref_ms = [cs.timed(lambda: grid(ref_gp, ref_vals), 10) for _ in range(2)]
                del ref_gp, ref_vals
                cs.say(f"flagship support {support}: K1w at the API's tile {ref_tile} "
                       + ", ".join(f"{t:.4f}" for t in ref_ms) + " ms (package, two runs)")
                gp = cs.flagship_grid_plan(vis, geo, cs.TILE18)
                yield (f"flagship support {support} linear tile {cs.TILE18}", gp,
                       sort_values(gp, weighted))
            for support, tile in cs.WIDE18:
                for mode in ("linear", "nearest"):
                    gp = cs.long_window_plan(uvw[:n_sub], base, support, tile, mode)
                    yield (f"flagship 1M subset support {support} {mode} tile {tile}", gp,
                           sort_values(gp, weighted[:n_sub]))
            return
        for support, full in cs.SUPPORTS16:
            if full:
                gp = make_visibility_plan(vis, model, context="ng", support=support).plans[0].gp
                yield f"flagship support {support}", gp, sort_values(gp, weighted)
            else:
                gp = make_imaging_plan(uvw[:n_sub, 0], uvw[:n_sub, 1], uvw[:n_sub, 2],
                                       support=support, **geometry).gp
                yield (f"flagship 1M subset support {support}", gp,
                       sort_values(gp, weighted[:n_sub]))

    for where, gp, vals in plans():
        # phase 18a times K1 alone (K3 takes its wide variant there)
        what_all = ("grid",) if gp.tile == cs.TILE18 and gp.span <= 64 else ("grid", "degrid")
        g = torch.Generator(device=device).manual_seed(13)
        grids = torch.randn((gp.nplanes, gp.npixel, gp.npixel), generator=g, device=device,
                            dtype=torch.complex64)
        label = f"{where} (span {gp.span}, {gp.n_in} entries)"
        same, per_corner, nseg = walk_stats(gp)
        route = kernels.query("ska_grid_route", gp.span, gp.tile, 4 if gp.wstacked else 2)
        launch = cs.route4_geometry(gp) if route == 4 else cs.wide_geometry(gp)
        cs.say(f"{label}: consecutive walk positions on one plane and window corner {same:.3f}, "
               f"{per_corner:.1f} entries a corner and plane; {nseg} segments, "
               f"{int(gp.chunk_seg.shape[0])} chunks; {launch}")
        use("package")
        run = {"grid": lambda: grid(gp, vals), "degrid": lambda: degrid(gp, grids)}
        ref = [run[what]() for what in what_all]
        for name in names:
            use(name)
            out = [run[what]() for what in what_all]
            for k, what in enumerate(what_all):
                diff = float((out[k] - ref[k]).abs().max() / ref[k].abs().max())
                cs.say(f"{label}: {what} {name} vs package, largest difference {diff:.3e} "
                       f"of the maximum")
            del out
        del ref
        times = {what: [] for what in what_all}
        for name in turns:
            use(name)
            for what in what_all:
                times[what].append((name, cs.timed(run[what], 10 if what == "grid" else 20)))
        use("package")
        for what in what_all:
            bnd = (cs.grid_bound if what == "grid" else cs.degrid_bound)(gp)
            mine = [t for n, t in times[what] if n == "package"]
            cs.say(f"{label}: {what} ms in turns " + ", ".join(f"{n} {t:.4f}" for n, t in times[what])
                   + f"; bound {bnd[0]:.4f} ms ({bnd[1]}); the package "
                   f"{sum(mine) / len(mine) / bnd[0]:.1f} x the bound")
        del gp, vals, grids
        torch.cuda.empty_cache()
    if args.ical:
        from ska_sdp_func_python_torch.pipeline import ical

        for name in (names[0], "package", "package", names[0]):
            use(name)
            walls = []
            with cs.launch_events(("grid", "degrid")) as ms:
                cs.run_logged(
                    f"ical support {cs.ICAL16} ({name})",
                    lambda: ical(vis, model, nmajor=4, calibration_context="T", context="ng",
                                 algorithm="hogbom", support=cs.ICAL16,
                                 padding=cs.ICAL16_PADDING, **cs.CLEAN),
                    4, ("grid", "degrid"), walls,
                )
            cs.say(f"ical support {cs.ICAL16} ({name}): cycle walls "
                   + ", ".join(f"{w:.1f}" for w in walls) + " ms; K1 ms a launch "
                   + ", ".join(f"{t:.3f}" for t in ms["grid"]) + "; K3 "
                   + ", ".join(f"{t:.3f}" for t in ms["degrid"]))
        use("package")
    cs.say(f"command: {time.perf_counter() - t0:.1f} s")
    cs.say(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
