"""The port's plans at supports past 16 against the JAX plan path:
``grid_with_plan`` and ``degrid_with_plan`` on the same coordinates
(x64 on the CPU, the JAX Pallas kernels in interpret mode), at every
support of ``test_torch_wide_supports.SUPPORTS`` on tile 64, on linear
and nearest planes.

Tolerances: 1e-5 of the maximum up to support 33 and 2e-5 past it. The
JAX kernel evaluates its taps in f32 inside the kernel, and its own
distance from the direct f64 scatter grows with the window, to 9.8e-6 at
support 63 on a 128^2 grid of tile 64. Each support is a JAX compile of
its own, so the supports of one plane mode run in one test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_func_python_tpu.ops.gridding_plan import (
    degrid_with_plan as jax_degrid_with_plan,
    grid_with_plan as jax_grid_with_plan,
    make_grid_plan as jax_make_grid_plan,
)
from ska_sdp_func_python_torch.ops.gridding_plan import degrid_with_plan, grid_with_plan

from test_torch_wide_supports import NPIX, NW, SUPPORTS, TILE, _coords, _port_plan


@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_wide_plan_grid_and_degrid_match_jax(mode):
    for support in SUPPORTS:
        u, v, p0, frac, vals = _coords(150, 400 + support)
        jp = jax_make_grid_plan(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(p0),
            jnp.asarray(frac) if mode == "linear" else None,
            npixel=NPIX, support=support, nplanes=NW, tile=TILE,
        )
        pp = _port_plan(u, v, p0, frac, support, mode)
        tol = 1e-5 if support <= 33 else 2e-5
        ref = np.asarray(jax_grid_with_plan(jp, jnp.asarray(vals)))
        out = grid_with_plan(pp, torch.as_tensor(vals)).numpy()
        err = np.max(np.abs(out - ref)) / np.max(np.abs(ref))
        assert err <= tol, f"grid, support {support}: {err:.3e}"
        rng = np.random.default_rng(support)
        grids = rng.normal(size=ref.shape) + 1j * rng.normal(size=ref.shape)
        dref = np.asarray(jax_degrid_with_plan(jp, jnp.asarray(grids)))
        dout = degrid_with_plan(pp, torch.as_tensor(grids)).numpy()
        err = np.max(np.abs(dout - dref)) / np.max(np.abs(dref))
        assert err <= tol, f"degrid, support {support}: {err:.3e}"
