"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. This file
imports only the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: ``permute_apply`` is bit-exact (elements are only moved);
``hogbom`` (with and without a window), ``hogbom_complex``, ``msclean``
and ``msmfs`` give identical component positions and values to 1e-6
relative (the same f32 operations in the same order); ``grid`` (atomics, run-to-run summation order; held against
the plain version accumulated in f64) and ``degrid`` agree to 1e-5 of the
maximum.
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_torch import kernels
from ska_sdp_func_python_torch.ops import cleaners
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


def _clean_inputs(ny=128, py=64, seed=9):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:py, :py] - py // 2
    psf = np.exp(-(x**2 + y**2) / 8.0).astype(np.float32)
    dirty = 0.01 * rng.normal(size=(ny, ny)).astype(np.float32)
    for _ in range(4):
        cy, cx = rng.integers(0, ny, 2)
        dirty[max(cy - 3, 0) : cy + 3, max(cx - 3, 0) : cx + 3] += 1.0
    return dirty, psf


def _same(out, ref):
    for o, r in zip(out, ref):
        o = o.cpu()
        torch.testing.assert_close(o, r, rtol=0.0, atol=1e-6 * float(r.abs().max()))


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_hogbom_matches_plain(dev, window):
    dirty, psf = _clean_inputs()
    d = torch.as_tensor(dirty, device=dev)[None].contiguous()
    p = torch.as_tensor(psf, device=dev)[None].contiguous()
    w = None
    if window:
        w = torch.zeros_like(d)
        w[:, 20:100, 30:110] = 1.0
    kw = dict(gain=0.2, thresh=0.0, niter=300, fracthresh=0.01)
    before = kernels.KERNELS["hogbom"].launches
    comps, res = hogbom_lanes(d, p, w, **kw)
    assert kernels.KERNELS["hogbom"].launches == before + 1
    rc, rr = hogbom_lanes(d.cpu(), p.cpu(), None if w is None else w.cpu(), **kw)
    comps, res = comps.cpu(), res.cpu()
    assert torch.equal(comps != 0, rc != 0)
    torch.testing.assert_close(comps, rc, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(res, rr, rtol=0.0, atol=1e-6 * float(rr.abs().max()))


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_hogbom_complex_matches_plain(dev, window):
    dq, psf = _clean_inputs(seed=10)
    du = 0.6 * np.roll(dq, 7, axis=0)
    q, u, p = (torch.as_tensor(a, device=dev)[None].contiguous() for a in (dq, du, psf))
    w = None
    if window:
        w = torch.zeros_like(q)
        w[:, 10:90, 30:120] = 1.0
    kw = dict(gain=0.2, thresh=0.0, niter=200, fracthresh=0.01)
    before = kernels.KERNELS["hogbom_complex"].launches
    out = cleaners.hogbom_complex_lanes(q, u, p, w, **kw)
    assert kernels.KERNELS["hogbom_complex"].launches == before + 1
    ref = cleaners.hogbom_complex_lanes(
        q.cpu(), u.cpu(), p.cpu(), None if w is None else w.cpu(), **kw
    )
    assert torch.equal(out[0].cpu() != 0, ref[0] != 0)
    _same(out, ref)


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window+sensitivity"])
def test_msclean_matches_plain(dev, window):
    dirty, psf = _clean_inputs(ny=128, py=128, seed=11)
    d = torch.as_tensor(dirty, device=dev)
    p = torch.as_tensor(psf, device=dev)
    w = s = None
    if window:
        w = torch.zeros_like(d)
        w[16:112, 8:100] = 1.0
        s = torch.linspace(0.5, 1.5, 128 * 128, device=dev).reshape(128, 128)
    kw = dict(gain=0.2, thresh=0.0, niter=120, fracthresh=0.01)
    st = cleaners.msclean_psf_stacks(p, 128, 128, (0, 3, 10, 30))
    before = kernels.KERNELS["msclean"].launches
    out = cleaners.msclean_with_stacks(st, d, w, s, **kw)
    assert kernels.KERNELS["msclean"].launches == before + 1
    st_cpu = cleaners.MSCleanStacks(*(t.cpu() for t in st))
    ref = cleaners.msclean_with_stacks(
        st_cpu, d.cpu(), None if w is None else w.cpu(), None if s is None else s.cpu(), **kw
    )
    assert torch.equal(out[0].cpu() != 0, ref[0] != 0)
    _same(out, ref)


@pytest.mark.parametrize("algorithm", ["hogbom-complex", "msclean"])
def test_deconvolve_cube_window_on_card_matches_cpu(dev, algorithm):
    """deconvolve_cube with the quarter window on the card (kernels) and on
    the CPU (plain versions): identical component positions, values to
    1e-5 of the maximum (msclean's scale stacks come from cuFFT on the
    card)."""
    from ska_sdp_func_python_torch.models.image import create_image
    from ska_sdp_func_python_torch.ops.deconvolution import deconvolve_cube

    dirty, psf = _clean_inputs(ny=96, py=96, seed=12)
    frame = "stokesIQUV" if algorithm == "hogbom-complex" else "stokesI"
    npol = 4 if frame == "stokesIQUV" else 1
    scale = np.array([1.0, 0.17, 0.1, 0.02])[:npol, None, None]
    out = {}
    for d in (dev, torch.device("cpu")):
        im = create_image(96, 0.001, (0.0, -0.6), polarisation_frame=frame, device=d)
        di = im.replace(pixels=torch.as_tensor(scale * dirty[None], dtype=torch.float32, device=d)[None])
        ps = im.replace(pixels=torch.as_tensor(np.broadcast_to(psf, (1, npol, 96, 96)).copy(), device=d))
        kernels.reset_launch_counts()
        out[d.type] = deconvolve_cube(
            di, ps, algorithm=algorithm, niter=40, gain=0.2,
            fractional_threshold=0.01, window_shape="quarter", scales=[0, 3, 10],
        )
        if d.type == "cuda":
            counts = kernels.launch_counts()
            names = ("hogbom", "hogbom_complex") if npol == 4 else ("msclean",)
            assert all(counts[n] > 0 for n in names), counts
    for a, b in zip(out["cuda"], out["cpu"]):
        a, b = a.pixels.cpu(), b.pixels
        assert torch.equal(a != 0, b != 0)
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5 * float(b.abs().max()))


def _moment_inputs(nmoment, n=96, seed=13):
    """f32 moment images [nmoment, n, n] and moment PSFs [2 nmoment, n, n]
    of an 8-channel cube over 100-163 MHz (PSF narrowing with frequency,
    sources with spectral indices)."""
    rng = np.random.default_rng(seed)
    freq = np.linspace(1.0e8, 1.63e8, 8)
    x = (freq - freq[4]) / freq[4]
    yy, xx = np.mgrid[:n, :n] - n // 2
    psfs = np.stack([np.exp(-(yy**2 + xx**2) / (2.5 * freq[4] / f) ** 2) for f in freq])
    dirty = 0.004 * rng.normal(size=(8, n, n))
    for _ in range(4):
        cy, cx = rng.integers(8, n - 8, 2)
        alpha = rng.uniform(-1.5, 0.5)
        for c, f in enumerate(freq):
            dirty[c] += (f / freq[4]) ** alpha * np.roll(psfs[c], (cy - n // 2, cx - n // 2), (0, 1))
    w = x[:, None] ** np.arange(2 * nmoment)[None, :]
    return (
        np.einsum("cm,cyx->myx", w[:, :nmoment], dirty).astype(np.float32),
        np.einsum("cm,cyx->myx", w, psfs).astype(np.float32),
    )


@pytest.mark.parametrize(
    "findpeak,window,nmoment",
    [("RASCIL", False, 3), ("CASA", False, 2), ("RASCIL", True, 3)],
    ids=["rascil", "casa", "rascil-window"],
)
def test_msmfs_matches_plain(dev, findpeak, window, nmoment):
    """K8 against msmfs_rows_plain on the same f32 stacks: the same rows
    and residual, and one launch per lane."""
    dirty, psf = _moment_inputs(nmoment)
    n = dirty.shape[-1]
    st = cleaners.msmfs_psf_stacks(torch.as_tensor(psf, device=dev), n, n, (0, 3, 10))
    smres = cleaners.calculate_scale_moment_residual(
        torch.as_tensor(dirty, device=dev) / st.pmax, st.scalestack
    ).contiguous()
    ws = None
    if window:
        w = torch.zeros((n, n), device=dev)
        w[n // 4 + 1 : 3 * (n // 4), n // 4 + 1 : 3 * (n // 4)] = 1.0
        ws = (cleaners.convolve_scalestack(st.scalestack, w) > 0.9).float()[None].contiguous()
    kw = dict(gain=0.5, thresh=0.0, fracthresh=0.03, niter=150, findpeak=findpeak)
    before = kernels.KERNELS["msmfs"].launches
    rows, res = cleaners.msmfs_lanes(smres[None], st.canvas, st.hsmm, st.ihsmm, ws, **kw)
    assert kernels.KERNELS["msmfs"].launches == before + 1
    prow, pres = cleaners.msmfs_rows_plain(
        smres.cpu(), st.canvas.cpu(), st.hsmm.cpu(), st.ihsmm.cpu(),
        None if ws is None else ws[0].cpu(), **kw,
    )
    used = int((prow[:, 3] > 0).sum())
    assert 0 < used < 150
    torch.testing.assert_close(rows[0].cpu()[:, :4], prow[:, :4], rtol=0, atol=0)
    _same((rows[0, :, 4:], res[0]), (prow[:, 4:], pres))


def test_msmfs_ties_go_to_the_first_index(dev):
    """Exact ties across the sweep's CTAs and scales: unit Hessians, equal
    peaks at (31, 2), (30, 31) and (30, 30) of scale 1 and (5, 5) of
    scale 2, each pick clearing only its own pixel; the kernel picks in
    (scale, y, x) order, as the plain version does."""
    ns, nm, n, pn = 3, 2, 40, 16
    smres = torch.zeros((ns, nm, n, n), device=dev)
    for s, y, x in ((2, 5, 5), (1, 31, 2), (1, 30, 31), (1, 30, 30)):
        smres[s, 0, y, x] = 1.0
    canvas = torch.zeros((ns, ns, 2 * nm - 1, pn, pn), device=dev)
    for s in range(ns):
        canvas[s, s, :, pn // 2, pn // 2] = 1.0
    eye = torch.eye(nm, device=dev).expand(ns, nm, nm).contiguous()
    rows, _ = cleaners.msmfs_lanes(
        smres[None], canvas, eye, eye, gain=1.0, thresh=0.0, fracthresh=0.01, niter=4
    )
    picks = [tuple(int(v) for v in r[:3]) for r in rows[0].cpu()]
    assert picks == [(30, 30, 1), (30, 31, 1), (31, 2, 1), (5, 5, 2)]
