"""The two gridding kernels at the shapes of the epsilon path that
``chip_smoke.py`` does not time, and the cell changes of their register
sums, on one NVIDIA GPU.

Default: times the grid kernel (K1+K2) on the plans of ``chip_smoke.py``
phase 9c (the eskernel plan of ``invert_visibility(epsilon=1e-5)``: npad
2048, tile 64) and phase 9e (the plan cache's plan, padding 2), and
``unit_tiles`` (K9) on the f64 streams of the deep-f64-s12 and -s16 rows
(epsilon 1e-10 and 1e-11), all on the flagship epsilon observation of
phase 9 (CUDA events, mean of 5 runs after a warm-up); K9's result is held
against its plain version in f64. ``--tree DIR`` imports the package and
``chip_smoke.py`` of another checkout instead (its kernels build under
DIR), so that two trees are timed on one card in one call.

``--cells``: the cell changes per entry and thread of the register sums
(thread (a, b) owns the cell of residue class (x mod S, y mod S) of each
entry's S x S window and adds its registers to the shared tile where the
next entry's cell in that class differs or a new segment starts; one walk
of all entries, no run cap, no split among a CTA's groups): K1 on the
flagship ``ical`` plan and one config-4 cube channel, in plan order and in
the kernel's walk order (``korder``); K9 on the fast-f32 and deep-f64
streams, in segment order and in the stream's (segment, corner) order.

Usage: python3 gridding_shapes.py [--tree DIR] [--cells]
"""

from __future__ import annotations

import argparse
import os
import sys


def cell_changes(iu, iv, seg, support):
    """Cell changes per entry and thread over entries in walk order, of
    windows at corners (iu, iv) in segments ``seg``."""
    import torch

    def same_cells(c):
        n = torch.zeros(c.shape[0] - 1, dtype=torch.int32, device=c.device)
        for a in range(support):
            cell = c + (a - c).remainder(support)
            n += cell[1:] == cell[:-1]
        return n

    stay = (same_cells(iu) * same_cells(iv))[seg[1:] == seg[:-1]]
    return 1.0 - float(stay.sum()) / (iu.shape[0] * support * support)


def plan_cells(gp, label):
    """K1's cell changes on plan ``gp``, in plan order and in ``korder``."""
    nta = gp.npixel // gp.tile
    n = gp.n_in
    iu, iv = gp.iu0[:n].long(), gp.iv0[:n].long()
    seg = (gp.plane[:n].long() * nta + iv // gp.tile) * nta + iu // gp.tile
    k = gp.korder.long()
    print(
        f"grid {label}: {n} entries; cell changes per entry and thread "
        f"{cell_changes(iu, iv, seg, 8):.4f} in plan order, "
        f"{cell_changes(iu[k], iv[k], seg[k], 8):.4f} in the kernel's walk order",
        flush=True,
    )


def stream_cells(vis, model, eps, label):
    """K9's cell changes on the stream of ``invert_visibility(vis, model,
    epsilon=eps)``: the entries as the core path builds them, in segment
    order and in the order ``entry_stream`` gives them."""
    import torch

    from ska_sdp_func_python_torch.ops import imaging as im
    from ska_sdp_func_python_torch.ops.accuracy import gridding_params_for_epsilon
    from ska_sdp_func_python_torch.ops.gridding_tiled import _entries, _sorted_stream

    acc = gridding_params_for_epsilon(eps, f64=im._is_f64(vis))
    s = acc.support
    npad = im._npad_for(model.npixel, acc.padding)
    nw = im._nw_wkernel_for(vis, model, s)
    if acc.coords == "host64":
        u, _, v, _, w = im._prepix_rows(vis, model, slice(0, 1), npad)
    else:
        uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
        u, v = im._pixels(uvw[:, 0], uvw[:, 1], npad, model.cellsize, False)
        w = uvw[:, 2]
    p0, frac, _ = im._w_planes(w, nw, "eskernel", w_support=s)
    tid, _, _, ntot, corner = _entries(
        u, v, p0, frac, npixel=npad, support=s, nplanes=nw,
        tile=im._tile_for(npad), w_order=s,
    )
    del u, v, p0, frac, w
    rates = []
    for perm in (
        torch.argsort(tid, stable=True)[: int((tid < ntot).sum())],
        _sorted_stream(tid, ntot, corner, npad)[0],
    ):
        c = corner[perm]
        rates.append(cell_changes(c % npad, c // npad, tid[perm], s))
        del perm, c
    print(
        f"unit_tiles {label}: {int((tid < ntot).sum())} entries, support {s}; "
        f"cell changes per entry and thread {rates[0]:.4f} in segment order, "
        f"{rates[1]:.4f} in the stream's (segment, corner) order",
        flush=True,
    )


def cells(dev):
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.models import create_named_configuration
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan

    _, vis, model, _ = cs.simulate(dev, rmax=40000.0, ntimes=76, npixel=1024)
    plan_cells(make_visibility_plan(vis, model, context="ng").plans[0].gp, "flagship ical plan")
    del vis, model
    vis, model = cs.simulate_cube(dev, **cs.CUBE)
    c = vis.nchan // 2
    plan_cells(make_visibility_plan(vis, model, context="ng").plans[c].gp, f"cube channel {c}")
    del vis, model
    torch.cuda.empty_cache()
    cfg = create_named_configuration("LOW", rmax=40000.0)
    for dtype, eps, label in ((torch.float32, cs.EPS_FAST, "fast-f32 stream"),
                              (torch.float64, cs.EPS_DEEP, "deep-f64 stream")):
        vis, model, _, _ = cs.observation9(cfg, dev, dtype)
        stream_cells(vis, model, eps, label)
        del vis, model
        torch.cuda.empty_cache()


def times(dev):
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.models import create_named_configuration
    from ska_sdp_func_python_torch.ops import imaging as im
    from ska_sdp_func_python_torch.ops.gridding_fused import grid
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values

    cfg = create_named_configuration("LOW", rmax=40000.0)
    vis, model, _, _ = cs.observation9(cfg, dev, torch.float32)
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    eskernel = im._route(vis, model, "ng", 8, None, None, {"epsilon": cs.EPS_PRECISE})[3]
    for label, plan in (
        ("9c eskernel plan", eskernel),
        ("9e cached plan", im.make_visibility_plan(vis, model, padding=2)),
    ):
        p = plan.plans[0]
        vals = sort_values(p.gp, weighted.repeat(p.ncopies))
        ms = cs.timed(lambda: grid(p.gp, vals), 5)
        print(
            f"grid {label}: {p.gp.n_in} entries, {p.gp.nplanes} planes of "
            f"{p.gp.npixel}^2, tile {p.gp.tile}: kernel {ms:.4f} ms",
            flush=True,
        )
        del vals
    del vis, model, weighted, eskernel
    im._PLAN_CACHE.clear()
    torch.cuda.empty_cache()
    vis, model, _, _ = cs.observation9(cfg, dev, torch.float64)
    # the resolver takes the first row whose floor is within epsilon / 2
    for label, eps in (("deep-f64-s12", 1e-10), ("deep-f64-s16", 1e-11)):
        stream, geo = cs.unit_stream9(vis, model, eps)
        ref = stream.grid(plain=True, **geo)
        rel = float((stream.grid(**geo) - ref).abs().max() / ref.abs().max())
        del ref
        ms = cs.timed(lambda: stream.grid(**geo), 5)
        print(
            f"unit_tiles {label} stream (f64): {stream.u.shape[0]} entries, "
            f"{stream.nplanes} planes of {geo['npixel']}^2, tile {geo['tile']}, "
            f"support {geo['support']}: kernel {ms:.3f} ms, error {rel:.3e} of "
            f"the grid maximum against the plain version",
            flush=True,
        )
        del stream
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import the package and chip_smoke.py from this checkout")
    ap.add_argument("--cells", action="store_true", help="print the cell-change rates")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gridding_shapes: no CUDA device; nothing was run")
    import chip_smoke as cs
    import ska_sdp_func_python_torch as pkg

    print(f"{cs.card_line()}; package {os.path.dirname(pkg.__file__)}", flush=True)
    (cells if args.cells else times)(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
