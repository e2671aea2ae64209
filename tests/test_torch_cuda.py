"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. This file
imports only the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: ``permute_apply`` is bit-exact (elements are only moved);
``hogbom`` gives identical component positions and values to 1e-6
relative; ``grid`` (atomics, run-to-run summation order; held against
the plain version accumulated in f64) and ``degrid`` agree to 1e-5 of the
maximum.
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_torch import kernels
from ska_sdp_func_python_torch.ops.cleaners import hogbom_lanes
from ska_sdp_func_python_torch.ops.gridding_fused import (
    degrid,
    degrid_plain,
    grid,
    grid_plain,
)
from ska_sdp_func_python_torch.ops.gridding_plan import make_grid_plan
from ska_sdp_func_python_torch.ops.permute import (
    permute_apply,
    permute_apply_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(dev, n=20000, npix=256, nplanes=4, wstacked=True):
    g = torch.Generator().manual_seed(5)
    u = torch.rand(n, generator=g, dtype=torch.float64) * (npix + 20) - 10
    v = torch.rand(n, generator=g, dtype=torch.float64) * (npix + 20) - 10
    p0 = torch.randint(0, nplanes - 1, (n,), generator=g)
    frac = torch.rand(n, generator=g, dtype=torch.float64)
    if not wstacked:
        p0 = frac = None
        nplanes = 1
    return make_grid_plan(
        u.to(dev), v.to(dev), None if p0 is None else p0.to(dev),
        None if frac is None else frac.to(dev),
        npixel=npix, nplanes=nplanes, tile=64, chunk=512,
    )


@pytest.mark.parametrize("wstacked", [True, False])
def test_grid_and_degrid_match_plain(dev, wstacked):
    plan = _plan(dev, wstacked=wstacked)
    g = torch.Generator(device=dev).manual_seed(6)
    vals = torch.randn(plan.n, generator=g, device=dev, dtype=torch.complex64)
    ref = grid_plain(plan, vals.to(torch.complex128))
    out = grid(plan, vals)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    grids = torch.randn(ref.shape, generator=g, device=dev, dtype=torch.complex64)
    ref = degrid_plain(plan, grids)
    out = degrid(plan, grids)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("inverse", [False, True])
def test_permute_bit_exact(dev, inverse):
    n = 100003
    perm = torch.randperm(n, device=dev).to(torch.int32)
    a = torch.randn(n, device=dev)
    b = torch.randn(n, device=dev, dtype=torch.complex64)
    for x in (a, b):
        out = permute_apply(perm, x, inverse=inverse)
        ref = permute_apply_plain(perm, x, inverse=inverse)
        assert torch.equal(out, ref)
    # mixed f32 and complex64 payloads in one launch
    before = kernels.KERNELS["permute"].launches
    out = permute_apply(perm, b, a, a, b, inverse=inverse)
    assert kernels.KERNELS["permute"].launches == before + 1
    ref = permute_apply_plain(perm, b, a, a, b, inverse=inverse)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_hogbom_matches_plain(dev):
    rng = np.random.default_rng(9)
    ny, py = 128, 64
    y, x = np.mgrid[:py, :py] - py // 2
    psf = np.exp(-(x**2 + y**2) / 8.0).astype(np.float32)
    dirty = 0.01 * rng.normal(size=(ny, ny)).astype(np.float32)
    for _ in range(4):
        cy, cx = rng.integers(0, ny, 2)
        dirty[max(cy - 3, 0) : cy + 3, max(cx - 3, 0) : cx + 3] += 1.0
    d = torch.as_tensor(dirty, device=dev)[None].contiguous()
    p = torch.as_tensor(psf, device=dev)[None].contiguous()
    kw = dict(gain=0.2, thresh=0.0, niter=300, fracthresh=0.01)
    before = kernels.KERNELS["hogbom"].launches
    comps, res = hogbom_lanes(d, p, **kw)
    assert kernels.KERNELS["hogbom"].launches == before + 1
    rc, rr = hogbom_lanes(d.cpu(), p.cpu(), **kw)
    comps, res = comps.cpu(), res.cpu()
    assert torch.equal(comps != 0, rc != 0)
    torch.testing.assert_close(comps, rc, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(res, rr, rtol=0.0, atol=1e-6 * float(rr.abs().max()))
