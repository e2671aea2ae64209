"""The CLEAN kernels (K5 ``hogbom``, K6 ``hogbom_complex``, K7 ``msclean``,
K8 ``msmfs``) at the main path's shapes, on one NVIDIA GPU.

Times, with CUDA events (mean of 20 runs after a warm-up; the floors and
the CLEAN lanes 5):
  - the flagship (``chip_smoke.py``'s observation): one lane of the cycle-0
    1024^2 dirty image and its bounded PSF patch, K5 with and without the
    quarter window and K6 on the Q and U planes of ``chip_smoke.py`` phase
    6, at niter 300, gain 0.2, fractional threshold 0.01; K7 on the fused
    cycle's msclean stacks of the same image (4 scales), the kernel alone
    and the whole CLEAN lane (``msclean_with_stacks``: the scale
    convolutions, the kernel and the component image);
  - the config-4 cube: 64 lanes of 256^2 (the cube's dirty channels and
    their bounded PSF patches), K5 and K6 with the same CLEAN settings; K8
    on the cycle-0 moment stacks of ``chip_smoke.py`` phase 8a (3 moments,
    4 scales, niter 100, gain 0.7), the kernel alone and the whole CLEAN
    lane (``msmfs_with_stacks``);
  - with ``--floor``: the per-iteration floor of the ways to sequence a
    CLEAN loop on the card: K5's barrier over all its CTAs (one lane of
    1024^2 with a 1x1 PSF, so that one CTA changes per iteration), K7 on
    one 32^2 scale with a 3x3 PSF (two launches per iteration before the
    redesign, one barrier over 32 CTAs after it), K7 on one 1024^2 scale
    and K8 on one 256^2 scale and moment with 1x1 PSFs, each over 300
    iterations that all run.
Each line gives the iterations used (from the plain loop's rows, the same
on every tree) and the kernel's microseconds an iteration (for a batch of
lanes: over its longest lane, which the launch waits for).

``--tree DIR`` imports the package and ``chip_smoke.py`` of another
checkout instead (its kernels build under DIR), so that two trees are
timed on one card in one call; the K7 and K8 calls follow that package's
signatures (before the redesign they took no scale blobs and returned no
component image, which the lane then rebuilt from the rows).

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


def _blobs(fn, blobs):
    """The scale-blob argument of msclean_lanes or msmfs_lanes, where the
    package's version takes one."""
    import inspect

    return [blobs] if "pscalestack" in inspect.signature(fn).parameters else []


def _msclean(d, p):
    """K7 and the msclean CLEAN lane on the flagship lane ``d`` [1, ny, nx]
    with PSF patch ``p`` [1, py, px]."""
    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops import cleaners as cl

    ny, nx = d.shape[-2:]
    st = cl.msclean_psf_stacks(p[0], ny, nx, cs.SCALES)
    res = cl.convolve_scalestack(st.scalestack, d[0] / st.pmax)[None].contiguous()
    args = (res, st.psf_ss[None], st.coupling_diag[None],
            *_blobs(cl.msclean_lanes, st.pscalestack[None]))
    rows = cl.msclean_rows_plain(res[0], st.psf_ss, st.coupling_diag, **CLEAN_KW)[0]
    iters = _iterations(rows, 4)
    ms = cs.timed(lambda: cl.msclean_lanes(*args, **CLEAN_KW), 20)
    label = f"msclean flagship 1 lane of {len(cs.SCALES)} x {nx}^2, PSF {p.shape[-1]}^2"
    _report(label, ms, iters)
    ms = cs.timed(lambda: cl.msclean_with_stacks(st, d[0], **CLEAN_KW), 5)
    _report(f"{label}, the CLEAN lane (msclean_with_stacks)", ms, iters)


def _msmfs(dirty, patch, frequency):
    """K8 and the MSMFS CLEAN lane on the cycle-0 moment stacks of the
    cube's dirty channels ``dirty`` [nchan, 1, ny, nx] and PSF patches."""
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops import cleaners as cl
    from ska_sdp_func_python_torch.ops.taylor import moment_weights

    nm = cs.CUBE_CLEAN["nmoment"]
    w_m, w_p = (
        moment_weights(frequency, None, k).to(device=dirty.device, dtype=torch.float32)
        for k in (nm, 2 * nm)
    )
    psf_t = torch.einsum("cm,cpyx->mpyx", w_p, patch)
    peak = psf_t.max()
    ny, nx = dirty.shape[-2:]
    st = cl.msmfs_psf_stacks(psf_t[:, 0] / peak, ny, nx, cs.SCALES)
    dpix = torch.einsum("cm,cpyx->mpyx", w_m, dirty) / peak
    smres = cl.calculate_scale_moment_residual(dpix[:, 0] / st.pmax, st.scalestack)
    smres = smres.contiguous()
    kw = dict(gain=0.7, thresh=0.0, fracthresh=cs.CUBE_CLEAN["fractional_threshold"],
              niter=cs.CUBE_CLEAN["niter"])
    args = (smres[None], st.canvas, st.hsmm, st.ihsmm,
            *_blobs(cl.msmfs_lanes, st.pscalestack))
    rows = cl.msmfs_rows_plain(smres, st.canvas, st.hsmm, st.ihsmm, **kw)[0]
    iters = _iterations(rows, 3)
    ms = cs.timed(lambda: cl.msmfs_lanes(*args, **kw), 20)
    label = f"msmfs cube {len(cs.SCALES)} scales x {nm} moments x {nx}^2"
    _report(label, ms, iters)
    ms = cs.timed(lambda: cl.msmfs_with_stacks(st, dpix[:, 0], **kw), 5)
    _report(f"{label}, the CLEAN lane (msmfs_with_stacks)", ms, iters)


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
    _msclean(d, p)


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
    _msmfs(dirty.pixels.to(torch.float32), patch, model.frequency)
    del vis, model, plan, dirty, psf
    torch.cuda.empty_cache()
    _lanes(d, p, f"cube {d.shape[0]} lanes of {d.shape[-1]}^2, PSF {p.shape[-1]}^2")


def floors(dev):
    """Per-iteration floors of the CLEAN loops' sequencing."""
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
    args = (res, psf_ss, cd, *_blobs(cl.msclean_lanes, psf_ss[:, 0]))
    ms = cs.timed(lambda: cl.msclean_lanes(*args, **kw), 5)
    print(
        f"floor: msclean one 32^2 scale, 3x3 PSF, 300 iterations "
        f"{ms / 300 * 1e3:.3f} us an iteration",
        flush=True,
    )
    one = torch.ones((1, 1, 1), device=dev)
    res = torch.rand((1, 1, 1024, 1024), generator=g, device=dev) + 1.0
    args = (res, one[None, None], one[0], *_blobs(cl.msclean_lanes, one[None]))
    ms = cs.timed(lambda: cl.msclean_lanes(*args, **kw), 5)
    print(
        f"floor: msclean one 1024^2 scale, 1x1 PSF, 300 iterations "
        f"{ms / 300 * 1e3:.3f} us an iteration",
        flush=True,
    )
    res = torch.rand((1, 1, 1, 256, 256), generator=g, device=dev) + 1.0
    args = (res, one[None, None], one, one, *_blobs(cl.msmfs_lanes, one))
    ms = cs.timed(lambda: cl.msmfs_lanes(*args, **kw), 5)
    print(
        f"floor: msmfs one 256^2 scale and moment, 1x1 PSF, 300 iterations "
        f"{ms / 300 * 1e3:.3f} us an iteration",
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
