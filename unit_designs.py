"""K9's wide variant (odd supports and supports past 16) of this checkout
timed in turns beside those of other checkouts, on one NVIDIA GPU.

Each ``--other DIR`` is a checkout, or a copy of its
``ska_sdp_func_python_torch/csrc``, whose C entry point ``ska_unit_tiles``
takes this package's arguments: an earlier design, or a copy of one with a
passage changed to see where its time goes. Each one's ``unit_tiles.cu``
is built with ``nvcc`` for ``sm_90a`` (the package's flags, all builds
started together) into ``build/unit_designs/``, each under the name of
its directory.

On phase 16b's stream (``chip_smoke.unit_stream16``: phase 9's
observation cut to ``chip_smoke.UNIT16_TIMES`` integrations, 6 linear
planes of 2048^2, tile 64) at the supports of ``chip_smoke.UNIT16``, and
with ``--full`` on the whole observation (76 integrations) at
``FULL_SUPPORTS``, or with ``--phase18`` on phase 18c's and 18d's streams
(the whole observation with one tile the 2048^2 grid at
``chip_smoke.UNIT18_FULL``; 16b's integrations at the (support, tile,
padding) of ``chip_smoke.UNIT18``: K9's route 4), in f32 and f64, the
script prints the stream's units,
entries a unit and the share of consecutive entries on one window corner
and plane; each other's largest difference from the package over the
package's maximum; the package's launch geometry; and each design's time
with CUDA events over a few launches after a warm-up: the others, the
package twice, then the others in reverse order, beside the bound and
the package's time over it.

Usage: python3 unit_designs.py --other DIR [DIR ...] [--full | --phase18]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import chip_smoke as cs
import wide_designs as wd

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "unit_designs"
FULL_SUPPORTS = (7, 17, 24, 32, 48, 64)


def stream_facts(stream, npix):
    """Units, mean entries a unit, and the share of consecutive entries on
    one window corner (the floors of u and v) and one (plane, tile)
    segment."""
    import torch

    seg = torch.repeat_interleave(stream.unit_seg.long(), stream.unit_count.long())
    key = torch.floor(stream.v).long() * npix + torch.floor(stream.u).long()
    same = (key[1:] == key[:-1]) & (seg[1:] == seg[:-1])
    nunits = int(stream.unit_seg.shape[0])
    return nunits, int(stream.u.shape[0]) / nunits, float(same.float().mean())


def geometry(support, tile, f64):
    from ska_sdp_func_python_torch import kernels

    route = kernels.query("ska_unit_tiles_route", support, tile, int(f64))
    if route == 1:
        return "the narrow kernel"
    if route == 4:
        return f"route 4, {cs.band_geometry(support, tile, f64)}"
    v = [kernels.query("ska_unit_tiles_wide_geometry", support, tile, int(f64), w)
         for w in range(6)]
    return (f"cluster {v[0]}, {v[1]} threads, {v[2]} shared bytes, {v[3]} walks of "
            f"{v[4]} rows a thread, {v[5]} entries a walk a batch")


def main() -> int:
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.models import create_named_configuration

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="+", required=True,
                    help="checkouts (or csrc copies) of other designs")
    cells = ap.add_mutually_exclusive_group()
    cells.add_argument("--full", action="store_true",
                       help="also time the whole observation's stream")
    cells.add_argument("--phase18", action="store_true",
                       help="phase 18c-d's streams (route 4) in place of phase 16b's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("unit_designs: no CUDA device; nothing was run")
    others = [o.resolve() for o in args.other]
    if len({o.name for o in others} | {"package"}) != len(others) + 1:
        raise SystemExit("unit_designs: each --other needs a name of its own, not 'package'")
    t0 = time.perf_counter()
    card = cs.card_line()
    cs.say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    lib = kernels.load_library()
    libs = wd.build(others, ("unit_tiles",), OUT)
    cs.say(f"builds: {time.perf_counter() - t0:.1f} s")
    k9 = kernels.KERNELS["unit_tiles"]
    designs = {"package": wd.bind(lib, k9)}
    for o in others:
        designs[o.name] = wd.bind(libs[o.name, "unit_tiles"], k9)

    def use(name):
        k9._fn = designs[name]

    device = torch.device("cuda", 0)
    cfg = create_named_configuration("LOW", rmax=40000.0)
    names = [o.name for o in others]
    turns = (*names, "package", "package", *reversed(names))
    # (where, integrations, (support, tile (None: the API's), padding) of
    # each stream, launches a time)
    if args.phase18:
        cells = [("18c", 76, [(s, cs.UNIT18_TILE_FULL, 2.0) for s in cs.UNIT18_FULL], 3),
                 ("18d", cs.UNIT16_TIMES, cs.UNIT18, 3)]
    else:
        cells = [("16b", cs.UNIT16_TIMES, [(s, None, 2.0) for s in cs.UNIT16], 5)]
        if args.full:
            cells.append(("full", 76, [(s, None, 2.0) for s in FULL_SUPPORTS], 3))
    for where, ntimes, cases, reps in cells:
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            peak = cs.PEAK_F64_S if f64 else cs.PEAK_F32_S
            vis, model, _, _ = cs.observation9(cfg, device, dtype, ntimes=ntimes)
            for support, tile, padding in cases:
                stream, geo = cs.unit_stream16(vis, model, support, tile, padding)
                label = (f"K9 {where} {'f64' if f64 else 'f32'} support {support}"
                         + ("" if tile is None else f" tile {tile}")
                         + ("" if padding == 2.0 else f" padding {padding}"))
                nunits, per_unit, same = stream_facts(stream, geo["npixel"])
                cs.say(f"{label}: {int(stream.u.shape[0])} entries, {nunits} units, "
                       f"{per_unit:.1f} entries a unit, consecutive entries on one window "
                       f"corner and plane {same:.4f}; {geometry(support, geo['tile'], f64)}")
                use("package")
                ref = stream.grid(**geo)
                peak_ref = float(ref.abs().max())
                for name in names:
                    use(name)
                    out = stream.grid(**geo)
                    diff = float((out - ref).abs().max()) / peak_ref if peak_ref else 0.0
                    cs.say(f"{label}: {name} vs package, largest difference {diff:.3e} "
                           f"of the maximum")
                    del out
                del ref
                times = []
                for name in turns:
                    use(name)
                    times.append((name, cs.timed(lambda: stream.grid(**geo), reps)))
                use("package")
                bnd = cs.unit_tiles_bound(stream, geo, peak)
                mine = [t for n, t in times if n == "package"]
                cs.say(f"{label}: ms in turns " + ", ".join(f"{n} {t:.4f}" for n, t in times)
                       + f"; bound {bnd[0]:.4f} ms ({bnd[1]}); the package "
                       f"{sum(mine) / len(mine) / bnd[0]:.1f} x the bound")
                del stream
                torch.cuda.empty_cache()
            del vis, model
            torch.cuda.empty_cache()
    cs.say(f"command: {time.perf_counter() - t0:.1f} s")
    cs.say(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
