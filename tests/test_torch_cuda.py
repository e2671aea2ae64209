"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. This file
imports only the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: ``permute_apply`` is bit-exact (elements are only moved);
``hogbom`` (with and without a window), ``hogbom_complex``, ``msclean``
and ``msmfs`` give identical component positions and values to 1e-6
relative (the same f32 operations in the same order); ``grid`` (atomics, run-to-run summation order; held against
the plain version accumulated in f64) and ``degrid`` agree to 1e-5 of the
maximum; ``unit_tiles`` (atomics) agrees with its plain version
accumulated in f64 to 1e-5 of the grid maximum in f32 and to 1e-12 in
f64.
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
from ska_sdp_func_python_torch.ops.gridding_tiled import entry_stream
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


def _stress_coords(case, npix, rng, tile=64):
    """f64 pixel coordinates (u, v) of one stress case for the register
    gridders (grid, unit_tiles) on an npix^2 grid of ``tile``-pixel
    tiles."""
    if case == "one_cell":
        # every entry on one point: the longest register runs
        n = 20000
        return np.full(n, 100.3), np.full(n, 77.6)
    if case == "alternating":
        # two distant cells of one tile, in turn: a cell change per entry
        # in plan order
        n = 6000
        u = np.where(np.arange(n) % 2 == 0, tile + 3.2, 2 * tile - 2.1)
        v = np.where(np.arange(n) % 2 == 0, tile + 6.4, 2 * tile - 6.9)
        return u, v
    if case == "lattice":
        # one entry on every window corner of the grid: the most cell
        # changes in the kernels' walk order
        iv, iu = np.mgrid[3 : npix - 5, 3 : npix - 5]
        return iu.ravel() + 0.37, iv.ravel() + 0.61
    # windows on tile edges, in the halo and on the grid edges
    edges = np.concatenate([np.arange(0, npix, tile) + d for d in (-1.5, -0.5, 0.5, 3.2, 3.9)])
    edges = edges[(edges >= 3) & (edges <= npix - 5)]
    uu, vv = np.meshgrid(edges, edges)
    u, v = np.repeat(uu.ravel(), 5), np.repeat(vv.ravel(), 5)
    return u + rng.uniform(0, 0.1, u.size), v + rng.uniform(0, 0.1, v.size)


@pytest.mark.parametrize("wstacked", [True, False], ids=["wstacked", "one-plane"])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges", "chunked"])
def test_grid_stress_matches_plain(dev, case, wstacked):
    """K1 (register runs) against grid_plain accumulated in f64, to 1e-5
    of the grid maximum: long runs, a cell change per entry, windows on
    tile and grid edges, and chunk boundaries inside segments with empty
    segments between them (a chunk of 100 entries)."""
    _grid_stress(dev, case, wstacked, 64)


@pytest.mark.parametrize("wstacked", [True, False], ids=["wstacked", "one-plane"])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges", "chunked"])
@pytest.mark.parametrize("tile", [56, 8])
def test_grid_stress_other_tiles_match_plain(dev, tile, case, wstacked):
    """The stress cases of test_grid_stress_matches_plain at the tile's
    other row strides: tile 56 (buf 64, the main path's: XOR-swizzled
    rows) and tile 8 (buf 16: rows padded to 24)."""
    _grid_stress(dev, case, wstacked, tile)


def _grid_stress(dev, case, wstacked, tile):
    rng = np.random.default_rng(23)
    npix, nplanes = 4 * tile if tile > 8 else 256, 4
    u, v = _stress_coords("edges" if case == "chunked" else case, npix, rng, tile)
    n = u.size
    if case == "chunked":
        u, v = u[: n // 3], v[: n // 3]  # segments of the first tile row only
        n = u.size
    p0 = torch.as_tensor(rng.integers(0, nplanes - 1, n)).to(dev) if wstacked else None
    frac = torch.as_tensor(rng.uniform(0, 1, n)).to(dev) if wstacked else None
    plan = make_grid_plan(
        torch.as_tensor(u).to(dev), torch.as_tensor(v).to(dev), p0, frac,
        npixel=npix, nplanes=nplanes if wstacked else 1, tile=tile,
        chunk=100 if case == "chunked" else None,
    )
    vals = rng.uniform(0.5, 1.5, n) * (1.0 + 0.5j) * np.exp(0.1j * rng.normal(size=n))
    vals = torch.as_tensor(vals.astype(np.complex64)).to(dev)
    before = kernels.KERNELS["grid"].launches
    out = grid(plan, vals)
    torch.cuda.synchronize()
    assert kernels.KERNELS["grid"].launches == before + 1
    ref = grid_plain(plan, vals.to(torch.complex128))
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


def _unit_stream(case, dtype, with_lo, dev):
    """A tiled-gridder entry stream on ``dev`` in ``dtype`` (hi, lo pairs
    of f64 positions for f32), and the same stream in f64 for the plain
    version. Four linear w-planes at 256^2, tile 64."""
    rng = np.random.default_rng(17)
    npix = 256
    if case == "random":
        n = 20000
        u64 = rng.uniform(-10, npix + 10, n)
        v64 = rng.uniform(-10, npix + 10, n)
        # integer hi with a negative residual: the tap window starts one
        # cell lower than the hi coordinate's
        u64[:200] = np.round(u64[:200]) - 3e-6
        v64[100:300] = np.round(v64[100:300]) - 3e-6
    elif case == "one_segment":
        n = 3000
        u64, v64 = np.full(n, 43.3), np.full(n, 77.7)
    elif case == "single":
        n = 1
        u64, v64 = np.asarray([30.2]), np.asarray([99.9])
    else:
        n = 500
        u64 = rng.uniform(-400, -100, n)
        v64 = rng.uniform(npix + 100, npix + 400, n)
    p0 = rng.integers(0, 3, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    if dtype == torch.float32:
        u, v = u64.astype(np.float32), v64.astype(np.float32)
        ulo, vlo = (u64 - u).astype(np.float32), (v64 - v).astype(np.float32)
        vals = vals.astype(np.complex64)
    else:
        u, v = u64.copy(), v64.copy()
        if case == "random":
            u[:200], v[100:300] = np.round(u[:200]), np.round(v[100:300])
        ulo = np.where(np.arange(n) < 300, -2e-9, rng.uniform(-1e-9, 1e-9, n))
        vlo = ulo.copy()
    if not with_lo:
        ulo = vlo = None
    out = []
    for d, dt in ((dev, dtype), (dev, torch.float64)):
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.float64)).to(d, dt)
        cd = torch.complex128 if dt == torch.float64 else torch.complex64
        out.append(entry_stream(
            t(u), t(v), torch.as_tensor(vals).to(d, cd), torch.as_tensor(p0).to(d),
            t(frac), t(ulo), t(vlo), npixel=npix, support=8, nplanes=4, tile=64,
            unit=256,
        ))
    return out


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "one_segment", "single", "all_outside"])
def test_unit_tiles_matches_plain(dev, case, dtype, with_lo):
    """K9 against unit_tiles_plain accumulated in f64: f32 to 1e-5 of the
    grid maximum, f64 to 1e-12; one launch per stream with units."""
    stream, ref_stream = _unit_stream(case, dtype, with_lo, dev)
    kw = dict(npixel=256, tile=64, support=8, beta=16.0)
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    nunits = int(stream.unit_seg.shape[0])
    assert kernels.KERNELS["unit_tiles"].launches == before + (1 if nunits else 0)
    ref = ref_stream.grid(plain=True, **kw)
    assert out.dtype == (torch.complex64 if dtype == torch.float32 else torch.complex128)
    if case == "all_outside":
        assert nunits == 0 and not out.abs().max() > 0 and not ref.abs().max() > 0
        return
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (out.to(torch.complex128) - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("support", [6, 8, 12, 16])
@pytest.mark.parametrize("case", ["one_cell", "alternating", "lattice", "edges"])
def test_unit_tiles_stress_matches_plain(dev, case, support, dtype, with_lo):
    """K9 (register runs) against unit_tiles_plain accumulated in f64, f32
    to 1e-5 of the grid maximum and f64 to 1e-12, at supports 6 and 8 (the
    main path's) and 12 and 16 (the deep-f64-s12 and -s16 rows: two groups
    and one group of a CTA): the longest runs, a cell change per entry,
    windows on tile and grid edges;
    a fifth of the coordinates are integers with a negative residual (the
    tap window one cell lower)."""
    rng = np.random.default_rng(29)
    npix = 256
    u64, v64 = _stress_coords(case, npix, rng)
    n = u64.size
    ints = np.arange(n) % 5 == 0
    u64 = np.where(ints, np.round(u64), u64)
    v64 = np.where(ints, np.round(v64), v64)
    lo = np.where(ints, -3e-9 if dtype == torch.float64 else -3e-6, 0.0)
    p0 = rng.integers(0, 3, n)
    frac = rng.uniform(0, 1, n)
    vals = rng.uniform(0.5, 1.5, n) * (1.0 + 0.5j) * np.exp(0.1j * rng.normal(size=n))
    if dtype == torch.float32:
        u, v = u64.astype(np.float32), v64.astype(np.float32)
        vals = vals.astype(np.complex64)
    else:
        u, v = u64, v64
    ulo = vlo = lo if with_lo else None
    streams = []
    for dt in (dtype, torch.float64):
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.float64)).to(dev, dt)
        cd = torch.complex128 if dt == torch.float64 else torch.complex64
        streams.append(entry_stream(
            t(u), t(v), torch.as_tensor(vals).to(dev, cd), torch.as_tensor(p0).to(dev),
            t(frac), t(ulo), t(vlo), npixel=npix, support=support, nplanes=4,
            tile=64, unit=256,
        ))
    stream, ref_stream = streams
    kw = dict(npixel=npix, tile=64, support=support, beta=2.3 * support)
    before = kernels.KERNELS["unit_tiles"].launches
    out = stream.grid(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["unit_tiles"].launches == before + 1
    ref = ref_stream.grid(plain=True, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (out.to(torch.complex128) - ref).abs().max() <= tol * ref.abs().max()
