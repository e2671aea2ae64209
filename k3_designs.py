"""Designs of the degrid kernel (K3) that were measured and not kept, timed
beside the package's kernel on one NVIDIA GPU.

Each source in ``k3_designs/`` is a whole ``degrid.cu`` of its own with a
plain C entry point ``ska_degrid``. This script builds each alone with
``nvcc`` for ``sm_90a`` (all started together) into
``build/k3_designs/``, binds it with ``ctypes`` and times it (CUDA events,
mean of 20 runs after a warm-up) on the flagship ``ical`` plan and on the
config-4 cube's 64 channel plans in one launch, beside the package's
``degrid_stack`` on the same grids, in turns package, designs, package.
Each design's values are held against the package kernel's to 1e-5 of
the largest |value| (``chip_smoke.py`` holds the package's kernel against
the plain version).

Designs:

- ``rows_plan_order``: 8 lanes an entry, lane x reading column x of each
  window row; entries in plan order, one entry a group.
- ``rows_staged``: ``rows_plan_order``, plus each run of at least 128
  entries of one segment in a CTA's 2048 served from the segment's tile
  and halo staged in shared memory with ``cp.async``.
- ``thread_walk``: one thread an entry, each segment walked in the grid
  kernel's window-corner order (``GridPlan.korder``).

``--tree DIR`` imports the package and ``chip_smoke.py`` of another
checkout instead.

Usage: python3 k3_designs.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DESIGNS = ("rows_plan_order", "rows_staged", "thread_walk")
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build(out_dir: Path) -> dict:
    """Compile every design into its own shared library; returns the
    loaded ``ska_degrid`` of each by name."""
    from ska_sdp_func_python_torch import kernels

    nvcc = kernels._nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in DESIGNS:
        so = out_dir / f"{name}.so"
        cmd = [nvcc, *kernels._NVCC_FLAGS, "-shared", "-o", str(so),
               str(ROOT / "k3_designs" / f"{name}.cu")]
        jobs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).ska_degrid
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(name, fn, st, grids, out):
    """One launch of design ``name`` over the stack ``st``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    head = [grids.data_ptr(), st.iu0.data_ptr(), st.iv0.data_ptr(),
            st.plane.data_ptr(), st.frac.data_ptr(), st.ku.data_ptr(),
            st.kv.data_ptr()]
    geo = [st.n, st.nchan, st.npixel, st.nplanes]
    if name == "thread_walk":
        fn.argtypes = [*[_P] * 9, _L, _P, _L, _I, _I, _I, _I, _P]
        args = [*head, st.korder.data_ptr(), st.n_in.data_ptr(), 0,
                out.data_ptr(), *geo, int(st.wstacked), stream]
    elif name == "rows_staged":
        fn.argtypes = [*[_P] * 8, _L, _P, _L, _I, _I, _I, _I, _I, _P]
        args = [*head, st.n_in.data_ptr(), 0, out.data_ptr(), *geo,
                st.plans[0].tile, int(st.wstacked), stream]
    else:
        fn.argtypes = [*[_P] * 8, _L, _P, _L, _I, _I, _I, _I, _P]
        args = [*head, st.n_in.data_ptr(), 0, out.data_ptr(), *geo,
                int(st.wstacked), stream]
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def shape(label, vplan, fns):
    import torch

    import chip_smoke as cs
    from ska_sdp_func_python_torch.ops.gridding_fused import degrid_stack

    st = vplan.stack
    g = torch.Generator(device=st.perm.device).manual_seed(3)
    grids = torch.randn((st.nchan, st.nplanes, st.npixel, st.npixel), generator=g,
                        device=st.perm.device, dtype=torch.complex64)
    ref = degrid_stack(st, grids)
    scale = float(ref.abs().max())
    times = {"package": [cs.timed(lambda: degrid_stack(st, grids), 20)]}
    for name, fn in fns.items():
        out = torch.empty_like(ref)
        launch(name, fn, st, grids, out)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) / scale
        if not err <= 1e-5:
            raise AssertionError(f"{label}: {name} disagrees with the package ({err:.3e})")
        times[name] = [cs.timed(lambda: launch(name, fn, st, grids, out), 20), err]
    times["package"].append(cs.timed(lambda: degrid_stack(st, grids), 20))
    print(
        f"{label}: {st.nchan} channel(s) of {st.n} entries, {st.nplanes} planes of "
        f"{st.npixel}^2; degrid ms: package {times['package'][0]:.4f}, "
        + ", ".join(f"{k} {v[0]:.4f} (err {v[1]:.2e})" for k, v in times.items()
                    if k != "package")
        + f", package {times['package'][1]:.4f}",
        flush=True,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import the package and chip_smoke.py from this checkout")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_designs: no CUDA device; nothing was run")
    import chip_smoke as cs
    import ska_sdp_func_python_torch as pkg
    from ska_sdp_func_python_torch.ops import imaging as im

    print(f"{cs.card_line()}; package {os.path.dirname(pkg.__file__)}", flush=True)
    fns = build(ROOT / "build" / "k3_designs")
    dev = torch.device("cuda", 0)
    _, vis, model, _ = cs.simulate(dev, rmax=40000.0, ntimes=76, npixel=1024)
    shape("flagship ical plan", im.make_visibility_plan(vis, model, context="ng"), fns)
    del vis, model
    torch.cuda.empty_cache()
    vis, model = cs.simulate_cube(dev, **cs.CUBE)
    shape("config-4 cube plans", im.make_visibility_plan(vis, model, context="ng"), fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
