"""The unit size of the tiled gridder against the f32 error and the time of
kernel K9 (``unit_tiles``), on one NVIDIA GPU.

Builds the entry stream that ``invert_visibility(epsilon=1e-3)`` grids on
the flagship observation of ``chip_smoke.py`` phase 9 (the fast-f32 row:
~59.7M entries, support 6, 9 w-planes of 1344^2), cut into units of each
size, and prints for each: the number of units, the kernel's time (CUDA
events, mean of 5 runs after a warm-up), and the largest error of the
kernel and of the plain version in f32 against the plain version in f64,
relative to the grid maximum. A cell's f32 sum is a sum, within each unit,
of register runs of at most 64 entries (the kernel's run cap; the plain
version sums a unit's entries in one matmul) and, across the units of its
segment, of the unit sums; the unit size sets both depths.

Usage: python3 unit_tiles_units.py [unit ...]   (default 1024 4096 16384)
"""

from __future__ import annotations

import dataclasses
import sys


def main(units) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("unit_tiles_units: no CUDA device; nothing was run")
    import chip_smoke as cs
    from ska_sdp_func_python_torch.models import create_named_configuration
    from ska_sdp_func_python_torch.ops import imaging as im

    print(cs.card_line(), flush=True)
    cfg = create_named_configuration("LOW", rmax=40000.0)
    vis, model, _, _ = cs.observation9(cfg, torch.device("cuda"), torch.float32)
    for unit in units:
        im._UNIT_GRID = unit
        stream, geo = cs.unit_stream9(vis, model, cs.EPS_FAST)
        ref = dataclasses.replace(
            stream, u=stream.u.double(), v=stream.v.double(),
            vals=stream.vals.to(torch.complex128),
        ).grid(plain=True, **geo)
        peak = float(ref.abs().max())
        errs = [
            float((g.to(torch.complex128) - ref).abs().max()) / peak
            for g in (stream.grid(**geo), stream.grid(plain=True, **geo))
        ]
        ms = cs.timed(lambda: stream.grid(**geo), 5)
        segs = torch.bincount(stream.unit_seg.long())
        print(
            f"unit {unit}: {stream.unit_seg.shape[0]} units (at most "
            f"{int(segs.max())} in one segment), kernel {ms:.3f} ms, error of "
            f"the kernel {errs[0]:.3e} and of the f32 plain version "
            f"{errs[1]:.3e} of the grid maximum {peak:.4e}",
            flush=True,
        )
        del ref, stream
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [1024, 4096, 16384]))
