"""CPU checks of the MSMFS cube, the JAX package beside the PyTorch port.

Two checks, each on the CPU in one process (JAX under x64, as the tests
run it):

  gates    chip_smoke.py's cube gates (the fall of the peak residual, the
           model flux within 10 px of the source in the middle channel, the
           spectral index from the first and last channels) for the JAX
           package's fused ``continuum_imaging`` and for the port's, on the
           config-4 layout cut to --nants stations, --nchan channels over the
           same 64 MHz band from 100 MHz, and a --npixel cube;
  inverse  the port's fused ``ical`` with MSMFS (2 moments) on 6 channels of
           1 MHz, the JAX package's fused-cube test geometry otherwise,
           against the JAX package's: the count of model pixels whose zero
           pattern differs, with the moment Hessian inverted in f64 (the
           port) and in f32 (as the JAX package inverts it).

Usage: python3 cube_cpu_checks.py gates [--nants 48] [--nchan 16] [--npixel 128]
       python3 cube_cpu_checks.py inverse
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tests"))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

OFFSET = (10, -7)


def _peaks(logger_name, fn):
    handler = cs._CycleLog()
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        out = fn()
    finally:
        logger.removeHandler(handler)
    return out, [float(m.rsplit(" ", 1)[1]) for _, m in handler.events if "cycle" in m]


class _Cube:
    """What ``chip_smoke.cube_gates`` reads of a model image."""

    def __init__(self, pixels, frequency):
        self.pixels = torch.tensor(np.asarray(pixels))
        self.frequency = np.asarray(frequency)
        self.npixel = self.pixels.shape[-1]


def gates(nants: int, nchan: int, npixel: int) -> None:
    from simul import make_visibility

    from ska_sdp_func_python_tpu.models import SkyComponents
    from ska_sdp_func_python_tpu.ops import (
        create_image_from_visibility,
        dft_skycomponent_visibility,
        weight_visibility,
    )
    from ska_sdp_func_python_tpu.pipeline import continuum_imaging as jax_ci
    from ska_sdp_func_python_torch.pipeline import continuum_imaging

    df = 64e6 / nchan
    kw = dict(nmajor=4, context="ng", **cs.CUBE_CLEAN)
    vis = make_visibility(nants=nants, ntimes=9, nchan=nchan, frequency0=1e8,
                          channel_bandwidth=df, rmax=2000.0)
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=3.0, nchan=nchan)
    ra, dec = model.pixel_to_radec(npixel // 2 + OFFSET[0], npixel // 2 + OFFSET[1])
    f0 = np.asarray(vis.frequency)
    sky = SkyComponents.from_lists(
        [[float(ra), float(dec)]], (2.0 * (f0 / f0[nchan // 2]) ** -0.7)[None, :, None],
        vis.frequency,
    )
    vis = weight_visibility(dft_skycomponent_visibility(vis, sky), model, weighting="uniform")
    (cur, _, _), peaks = _peaks(
        "ska-sdp-func-python-tpu",
        lambda: jax_ci(vis, model, use_plan=True, fused=True, **kw),
    )
    cs.cube_gates("jax", _Cube(cur.pixels, cur.frequency), peaks, OFFSET, -0.7, gate=False)
    small = dict(cs.CUBE, nants=nants, nchan=nchan, df=df, npixel=npixel, offset=OFFSET)
    pvis, pmodel = cs.simulate_cube("cpu", **small)
    (cur, _, _), peaks = _peaks(
        "ska-sdp-func-python-torch", lambda: continuum_imaging(pvis, pmodel, **kw)
    )
    cs.cube_gates("port", cur, peaks, OFFSET, -0.7, gate=False)


def inverse() -> None:
    import test_torch_cube as tc

    from ska_sdp_func_python_torch.ops import cleaners

    f64 = cleaners._hessian_inverse
    for name, inv in (("f64", f64), ("f32", lambda h: torch.linalg.inv(h).contiguous())):
        cleaners._hessian_inverse = inv
        try:
            tc._ical_cube_both(6, 14, 96, (7, -4), -0.7, 1e6, algorithm="mmclean",
                               nmoment=2, niter=100)
            print(f"{name} inverse: the same component pixels as the JAX package")
        except AssertionError as e:
            lines = [ln for ln in str(e).splitlines() if "Mismatched" in ln]
            print(f"{name} inverse: differs from the JAX package: {lines}")
    cleaners._hessian_inverse = f64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("check", choices=("gates", "inverse"))
    ap.add_argument("--nants", type=int, default=48)
    ap.add_argument("--nchan", type=int, default=16)
    ap.add_argument("--npixel", type=int, default=128)
    args = ap.parse_args()
    if args.check == "gates":
        gates(args.nants, args.nchan, args.npixel)
    else:
        inverse()
    return 0


if __name__ == "__main__":
    sys.exit(main())
