"""The gridding kernels at the shapes of the main paths, and the cell
changes of the register sums, on one NVIDIA GPU.

Default: times degrid (K3) and permute (K4), with their bounds, at every
shape the main paths give them (CUDA events, mean of 20 runs after a
warm-up; 10 on the epsilon plans): the flagship ``ical`` plan, the
config-4 cube's 64 channel plans, and the epsilon plans 9c and 9e. On a
stack of channel plans it times the one launch over all channels and, for
comparison, one launch per channel (what a package without the stack
runs); the inverse permute at the flagship also as a gather through the
inverse permutation. Then it times the grid kernel (K1+K2), with its
bound, on the plans of ``chip_smoke.py``
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

``--k3k4``: only degrid and permute (the first part of the default).

Usage: python3 gridding_shapes.py [--tree DIR] [--cells | --k3k4]
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


def _bound_ms(nbytes, nops):
    """The larger of the bytes over 3.35 TB/s and the f32 operations over
    67 TFLOP/s (the H100 SXM's published peaks), in ms."""
    return max(nbytes / 3.35e12, nops / 67e12) * 1e3


def k3k4_shape(label, vplan, reps=20):
    """K3 and K4 on the plan set ``vplan`` of one observation: one launch a
    channel, and (where the package has a plan stack) one launch over all
    channels; random grids and complex64 payloads."""
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops.gridding_fused import degrid
    from ska_sdp_func_python_torch.ops.permute import permute_apply

    gps = [p.gp for p in vplan.plans]
    gp0, nchan = gps[0], len(gps)
    dev = gp0.perm.device
    n = int(gp0.perm.shape[0])  # entries a channel, copies included
    g = torch.Generator(device=dev).manual_seed(3)
    grids = torch.randn((nchan, gp0.nplanes, gp0.npixel, gp0.npixel), generator=g,
                        device=dev, dtype=torch.complex64)
    x = torch.randn((nchan, n), generator=g, device=dev, dtype=torch.complex64)
    f = torch.randn(n, generator=g, device=dev, dtype=torch.complex64)
    n_in = sum(gp.n_in for gp in gps)
    d_bound = _bound_ms(nchan * gp0.nplanes * gp0.npixel**2 * 8 + nchan * n * 88,
                        n_in * (2 * (64 * 4 + 8 * 4) + 6))
    p_bound = _bound_ms(nchan * n * 20, 0)
    f_bound = _bound_ms(nchan * n * 12 + n * 8, 0)
    times = {
        "degrid": lambda: [degrid(gp, grids[c]) for c, gp in enumerate(gps)],
        "permute inverse": lambda: [
            permute_apply(gp.perm, x[c], inverse=True) for c, gp in enumerate(gps)
        ],
        "permute shared forward": lambda: [permute_apply(gp.perm, f) for gp in gps],
    }
    per = {k: cs.timed(fn, reps) for k, fn in times.items()}
    print(
        f"{label}: {nchan} channel(s) of {n} entries ({n_in} in the grid), "
        f"{gp0.nplanes} planes of {gp0.npixel}^2; one launch a channel: degrid "
        f"{per['degrid']:.4f} ms (bound {d_bound:.4f} ms), inverse permute "
        f"{per['permute inverse']:.4f} ms (bound {p_bound:.4f} ms), forward permute "
        f"of one [{n}] source a channel {per['permute shared forward']:.4f} ms "
        f"(bound {f_bound:.4f} ms)",
        flush=True,
    )
    st = getattr(vplan, "stack", None)
    if st is not None and nchan > 1:
        from ska_sdp_func_python_torch.ops.gridding_fused import degrid_stack

        one = {
            "degrid": cs.timed(lambda: degrid_stack(st, grids), reps),
            "inverse": cs.timed(lambda: permute_apply(st.perm, x, inverse=True), reps),
            "gather": cs.timed(lambda: permute_apply(st.iperm, x), reps),
            "shared": cs.timed(lambda: permute_apply(st.perm, f, shared=(0,)), reps),
        }
        print(
            f"{label}: one launch over all {nchan} channels: degrid "
            f"{one['degrid']:.4f} ms, inverse permute {one['inverse']:.4f} ms as a "
            f"scatter, {one['gather']:.4f} ms as a gather through the inverse "
            f"permutations, forward permute from the shared source "
            f"{one['shared']:.4f} ms",
            flush=True,
        )
    if nchan == 1:
        perm = gp0.perm
        iperm = torch.empty_like(perm)
        iperm[perm.long()] = torch.arange(n, dtype=torch.int32, device=dev)
        gather = cs.timed(lambda: permute_apply(iperm, x[0]), reps)
        forward = cs.timed(lambda: permute_apply(perm, x[0]), reps)
        print(
            f"{label}: inverse permute as a gather through the inverse "
            f"permutation {gather:.4f} ms; forward permute {forward:.4f} ms; "
            f"the sector floor (4 + 8 + 32 bytes an element) "
            f"{_bound_ms(n * 44, 0):.4f} ms",
            flush=True,
        )


def epsilon_plans(vis, model):
    """The plans of chip_smoke.py phases 9c (the eskernel plan of
    ``invert_visibility(epsilon=1e-5)``) and 9e (the plan cache's)."""
    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops import imaging as im

    eskernel = im._route(vis, model, "ng", 8, None, None, {"epsilon": cs.EPS_PRECISE})[3]
    return (("9c eskernel plan", eskernel),
            ("9e cached plan", im.make_visibility_plan(vis, model, padding=2)))


def k3k4(dev):
    """K3 and K4 on the flagship ical plan, the config-4 cube's plans and
    the epsilon plans 9c and 9e."""
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.models import create_named_configuration
    from ska_sdp_func_python_torch.ops import imaging as im

    _, vis, model, _ = cs.simulate(dev, rmax=40000.0, ntimes=76, npixel=1024)
    k3k4_shape("flagship ical plan", im.make_visibility_plan(vis, model, context="ng"))
    del vis, model
    torch.cuda.empty_cache()
    vis, model = cs.simulate_cube(dev, **cs.CUBE)
    k3k4_shape("config-4 cube plans", im.make_visibility_plan(vis, model, context="ng"))
    del vis, model
    torch.cuda.empty_cache()
    cfg = create_named_configuration("LOW", rmax=40000.0)
    vis, model, _, _ = cs.observation9(cfg, dev, torch.float32)
    for label, plan in epsilon_plans(vis, model):
        k3k4_shape(label, plan, reps=10)
        del plan
    im._PLAN_CACHE.clear()
    torch.cuda.empty_cache()


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

    k3k4(dev)
    cfg = create_named_configuration("LOW", rmax=40000.0)
    vis, model, _, _ = cs.observation9(cfg, dev, torch.float32)
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    for label, plan in epsilon_plans(vis, model):
        p = plan.plans[0]
        vals = sort_values(p.gp, weighted.repeat(p.ncopies))
        ms = cs.timed(lambda: grid(p.gp, vals), 5)
        # the bound comes from a chip_smoke.py that has it
        bnd = f", bound {cs.grid_bound(p.gp)[0]:.4f} ms" if hasattr(cs, "grid_bound") else ""
        print(
            f"grid {label}: {p.gp.n_in} entries, {p.gp.nplanes} planes of "
            f"{p.gp.npixel}^2, tile {p.gp.tile}: kernel {ms:.4f} ms{bnd}",
            flush=True,
        )
        del vals
    del vis, model, weighted
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
    ap.add_argument("--k3k4", action="store_true",
                    help="time only degrid and permute")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gridding_shapes: no CUDA device; nothing was run")
    import chip_smoke as cs
    import ska_sdp_func_python_torch as pkg

    print(f"{cs.card_line()}; package {os.path.dirname(pkg.__file__)}", flush=True)
    (cells if args.cells else k3k4 if args.k3k4 else times)(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
