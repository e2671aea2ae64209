"""The Hogbom kernels (K5 ``hogbom``, K6 ``hogbom_complex``) at the main
path's shapes, on one NVIDIA GPU.

Times, with CUDA events (mean of 20 runs after a warm-up; the floors 5):
  - the flagship (``chip_smoke.py``'s observation): one lane of the cycle-0
    1024^2 dirty image and its bounded PSF patch, K5 with and without the
    quarter window and K6 on the Q and U planes of ``chip_smoke.py`` phase
    6, at niter 300, gain 0.2, fractional threshold 0.01;
  - the config-4 cube: 64 lanes of 256^2 (the cube's dirty channels and
    their bounded PSF patches), K5 and K6 with the same CLEAN settings;
  - with ``--floor``: the per-iteration floor of the two ways to sequence a
    CLEAN loop on the card: K5's barrier over all its CTAs (one lane of
    1024^2 with a 1x1 PSF, so that one CTA changes per iteration) and K7's
    two launches per iteration (msclean on one 32^2 scale with a 3x3 PSF),
    each over 300 iterations that all run.
Each line gives the iterations used (from the plain loop's rows, the same
on every tree) and the kernel's microseconds an iteration (for a batch of
lanes: over its longest lane, which the launch waits for).

``--tree DIR`` imports the package and ``chip_smoke.py`` of another
checkout instead (its kernels build under DIR), so that two trees are
timed on one card in one call.

Usage: python3 hogbom_shapes.py [--tree DIR] [--floor]
"""

from __future__ import annotations

import argparse
import os
import sys

CLEAN_KW = dict(gain=0.2, thresh=0.0, niter=300, fracthresh=0.01)


def _iterations(rows, used_col):
    return int((rows[..., used_col] > 0).sum(dim=-1).max())


def _report(label, ms, iters):
    print(
        f"{label}: kernel {ms:.4f} ms, {iters} iterations, "
        f"{ms / max(iters, 1) * 1e3:.3f} us an iteration",
        flush=True,
    )


def _lanes(dirty, psf, label):
    """K5 and K6 on lanes ``dirty`` [n, ny, nx] with PSFs ``psf``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops import cleaners as cl

    nl, ny, nx = dirty.shape
    rows = torch.stack([
        cl.hogbom_rows_plain(dirty[i], psf[i], **CLEAN_KW)[0] for i in range(nl)
    ])
    ms = cs.timed(lambda: cl.hogbom_lanes(dirty, psf, **CLEAN_KW), 20)
    _report(f"hogbom {label}", ms, _iterations(rows, 3))
    if nl == 1:
        win = torch.zeros_like(dirty)
        win[:, ny // 4 + 1 : 3 * (ny // 4), nx // 4 + 1 : 3 * (nx // 4)] = 1.0
        rows = cl.hogbom_rows_plain(dirty[0], psf[0], win[0], **CLEAN_KW)[0]
        ms = cs.timed(lambda: cl.hogbom_lanes(dirty, psf, win, **CLEAN_KW), 20)
        _report(f"hogbom {label}, quarter window", ms, _iterations(rows, 3))
    q = (cs.POL_P * np.cos(2 * cs.POL_CHI)) * dirty
    u = (cs.POL_P * np.sin(2 * cs.POL_CHI)) * dirty
    rows = torch.stack([
        cl.hogbom_complex_rows_plain(q[i], u[i], psf[i], **CLEAN_KW)[0]
        for i in range(nl)
    ])
    ms = cs.timed(lambda: cl.hogbom_complex_lanes(q, u, psf, **CLEAN_KW), 20)
    _report(f"hogbom_complex {label}", ms, _iterations(rows, 4))


def flagship(dev):
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )

    _, vis, model, _ = cs.simulate(dev, rmax=40000.0, ntimes=76, npixel=1024)
    plan = make_visibility_plan(vis, model, context="ng")
    dirty, _ = invert_visibility(vis, model, plan=plan)
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    patch = bound_psf(psf, psf).pixels.to(torch.float32)
    d = dirty.pixels[0, 0].to(torch.float32)[None].contiguous()
    p = patch[0, 0][None].contiguous()
    del vis, model, plan, dirty, psf
    torch.cuda.empty_cache()
    _lanes(d, p, f"flagship 1 lane of {d.shape[-1]}^2, PSF {p.shape[-1]}^2")


def cube(dev):
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )

    vis, model = cs.simulate_cube(dev, **cs.CUBE)
    plan = make_visibility_plan(vis, model, context="ng")
    dirty, _ = invert_visibility(vis, model, plan=plan)
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    patch = bound_psf(psf, psf).pixels.to(torch.float32)
    d = dirty.pixels[:, 0].to(torch.float32).contiguous()
    p = patch[:, 0].contiguous()
    del vis, model, plan, dirty, psf
    torch.cuda.empty_cache()
    _lanes(d, p, f"cube {d.shape[0]} lanes of {d.shape[-1]}^2, PSF {p.shape[-1]}^2")


def floors(dev):
    """Per-iteration floors: K5's barrier against K7's two launches."""
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops import cleaners as cl

    g = torch.Generator(device=dev).manual_seed(3)
    kw = dict(gain=0.2, thresh=0.0, niter=300, fracthresh=0.0)
    d = torch.rand((1, 1024, 1024), generator=g, device=dev) + 1.0
    p = torch.ones((1, 1, 1), device=dev)
    ms = cs.timed(lambda: cl.hogbom_lanes(d, p, **kw), 5)
    print(
        f"floor: hogbom barrier over all CTAs (1 lane of 1024^2, 1x1 PSF, 300 "
        f"iterations) {ms / 300 * 1e3:.3f} us an iteration",
        flush=True,
    )
    res = torch.rand((1, 1, 32, 32), generator=g, device=dev) + 1.0
    psf_ss = torch.zeros((1, 1, 1, 3, 3), device=dev)
    psf_ss[..., 1, 1] = 1.0
    cd = torch.ones((1, 1), device=dev)
    ms = cs.timed(lambda: cl.msclean_lanes(res, psf_ss, cd, **kw), 5)
    print(
        f"floor: msclean two launches (one 32^2 scale, 3x3 PSF, 300 "
        f"iterations) {ms / 300 * 1e3:.3f} us an iteration",
        flush=True,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import the package and chip_smoke.py from this checkout")
    ap.add_argument("--floor", action="store_true", help="also time the per-iteration floors")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hogbom_shapes: no CUDA device; nothing was run")
    import chip_smoke as cs
    import ska_sdp_func_python_torch as pkg

    print(f"{cs.card_line()}; package {os.path.dirname(pkg.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    flagship(dev)
    cube(dev)
    if args.floor:
        floors(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
