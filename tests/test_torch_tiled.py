"""Parity of the port's tiled gridder (kernel K9's plain version on the
CPU) with the JAX package's tiled gridder and its Pallas unit kernel.

Tolerances: the Pallas unit kernel runs in f32 (interpret mode), so the
plain version is held to it at 1e-4 absolute, as the JAX package holds
its kernel to its XLA formulation (``tests/test_gridding_tiled.py``);
everything else runs in f64 on both sides (the JAX side under x64) and
agrees to 1e-12 absolute for grids and visibilities of O(1) values and
1e-10 of the maximum for images. The JAX package sorts with the unstable
``lax.sort`` and reduces units by a cumsum, so the summation orders differ.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops.gridding import es_kernel as jax_es_kernel
from ska_sdp_func_python_tpu.ops.gridding_pallas import (
    pallas_available,
    unit_tiles_pallas,
)
from ska_sdp_func_python_tpu.ops.gridding_tiled import (
    tiled_degrid as jax_tiled_degrid,
    tiled_grid as jax_tiled_grid,
)
from ska_sdp_func_python_tpu.ops.imaging import (
    invert_core as jax_invert_core,
    predict_core as jax_predict_core,
)
from ska_sdp_func_python_torch.ops.gridding_tiled import (
    _entries,
    entry_stream,
    sorted_seg_bounds,
    tiled_degrid,
    tiled_grid,
    unit_tiles,
    unit_tiles_plain,
)
from ska_sdp_func_python_torch.ops.imaging import invert_core, predict_core


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _overlap_add(tr, ti, tv0, tu0, npix):
    """Place [U, buf, buf] tiles at their origins in an [npix, npix] grid."""
    grid = np.zeros((npix, npix), np.complex128)
    buf = tr.shape[-1]
    for t in range(tr.shape[0]):
        y0, x0 = int(tv0[t]), int(tu0[t])
        h, w = min(buf, npix - y0), min(buf, npix - x0)
        grid[y0 : y0 + h, x0 : x0 + w] += (tr[t] + 1j * ti[t])[:h, :w]
    return grid


def _unit_stream(rng, U, C, npix, tile, support, dtype):
    """U units of C entries, unit u in tile u, in the tile's grid window."""
    nta = npix // tile
    half = support // 2
    tv0 = (np.arange(U) // nta) * tile
    tu0 = (np.arange(U) % nta) * tile
    span = tile - support
    u = tu0[:, None] + (half - 1) + rng.uniform(0, span, (U, C))
    v = tv0[:, None] + (half - 1) + rng.uniform(0, span, (U, C))
    vals = rng.normal(size=(U, C)) + 1j * rng.normal(size=(U, C))
    return (
        u.astype(dtype), v.astype(dtype), vals, tv0.astype(dtype),
        tu0.astype(dtype),
    )


def _table(U, C):
    i32 = torch.int32
    return (
        torch.arange(U, dtype=i32) * C, torch.full((U,), C, dtype=i32),
        torch.arange(U, dtype=i32),
    )


def test_unit_tiles_plain_matches_pallas_kernel(rng):
    """The plain version against the Pallas unit kernel (f32, interpret
    mode) at its fixed beta = 2.3 S and no residuals: U 16, C 128,
    buf 72, S 8."""
    if not pallas_available():
        pytest.skip("pallas unavailable")
    U, C, S, tile, npix = 16, 128, 8, 64, 256
    u, v, vals, tv0, tu0 = _unit_stream(rng, U, C, npix, tile, S, np.float32)
    vr = vals.real.astype(np.float32)
    vi = vals.imag.astype(np.float32)
    tr, ti = unit_tiles_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(vr), jnp.asarray(vi),
        jnp.asarray(tv0), jnp.asarray(tu0), buf=tile + S, support=S,
        interpret=True,
    )
    ref = _overlap_add(np.asarray(tr), np.asarray(ti), tv0, tu0, npix)
    out = unit_tiles_plain(
        _t(u.reshape(-1)), _t(v.reshape(-1)),
        torch.complex(_t(vr.reshape(-1)), _t(vi.reshape(-1))), *_table(U, C),
        npixel=npix, nplanes=1, tile=tile, support=S, beta=2.3 * S,
    )
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
def test_unit_tiles_plain_matches_xla_unit_formulation(rng, with_lo):
    """The plain version against the JAX package's XLA unit compute
    (``tiled_grid``'s ``unit_tiles``) in f64, with a beta of the padded
    grid and split residuals subtracted after the small difference."""
    U, C, S, tile, npix = 9, 200, 6, 48, 144
    beta = 2.3 * S * (1.0 - 1.0 / 2.5) / 0.75
    u, v, vals, tv0, tu0 = _unit_stream(rng, U, C, npix, tile, S, np.float64)
    ulo = rng.uniform(-1e-4, 1e-4, (U, C)) if with_lo else np.zeros((U, C))
    vlo = rng.uniform(-1e-4, 1e-4, (U, C)) if with_lo else np.zeros((U, C))
    r = jnp.arange(tile + S, dtype=jnp.float64)

    def dense(t0, pix, lo):
        offs = ((t0[:, None, None] - pix[:, None, :]) + r[None, :, None]) - lo[:, None, :]
        return jax_es_kernel(offs / (S // 2), S, beta)

    kv = dense(jnp.asarray(tv0), jnp.asarray(v), jnp.asarray(vlo))
    ku = dense(jnp.asarray(tu0), jnp.asarray(u), jnp.asarray(ulo))
    tr = jnp.einsum("urc,uxc->urx", kv * vals.real[:, None, :], ku)
    ti = jnp.einsum("urc,uxc->urx", kv * vals.imag[:, None, :], ku)
    ref = _overlap_add(np.asarray(tr), np.asarray(ti), tv0, tu0, npix)
    out = unit_tiles_plain(
        _t(u.reshape(-1)), _t(v.reshape(-1)), _t(vals.reshape(-1)),
        *_table(U, C), npixel=npix, nplanes=1, tile=tile, support=S,
        beta=beta, u_lo=_t(ulo.reshape(-1)) if with_lo else None,
        v_lo=_t(vlo.reshape(-1)) if with_lo else None,
    )
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-12)


def test_unit_tiles_wrapper_takes_plain_version_on_cpu(rng):
    """On CPU tensors the wrapper is the plain version (beta None is
    2.3 S)."""
    U, C, S, tile, npix = 4, 50, 8, 32, 64
    u, v, vals, _, _ = _unit_stream(rng, U, C, npix, tile, S, np.float64)
    args = (_t(u.reshape(-1)), _t(v.reshape(-1)), _t(vals.reshape(-1)), *_table(U, C))
    kw = dict(npixel=npix, nplanes=1, tile=tile, support=S)
    a = unit_tiles(*args, **kw)
    b = unit_tiles_plain(*args, beta=2.3 * S, **kw)
    assert torch.equal(a, b)


def test_sorted_seg_bounds():
    seg = torch.tensor([0, 0, 2, 2, 2, 5])
    starts, counts = sorted_seg_bounds(seg, 7)
    assert starts.tolist() == [0, 2, 2, 5, 5, 5, 6]
    assert counts.tolist() == [2, 0, 3, 0, 0, 1, 0]


NPIX, TILE, SUP, NPL = 128, 32, 8, 7


def _entry_inputs(rng, form, n=1500):
    u = rng.uniform(-12, NPIX + 12, n)
    v = rng.uniform(-12, NPIX + 12, n)
    if form == "none":
        return u, v, None, None, 1, 1
    if form == "nearest":
        return u, v, rng.integers(0, NPL, n).astype(np.int32), None, NPL, 1
    if form == "linear":
        return u, v, rng.integers(0, NPL - 1, n).astype(np.int32), rng.uniform(0, 1, n), NPL, 1
    if form == "quadratic":
        return u, v, rng.integers(1, NPL - 1, n).astype(np.int32), rng.uniform(-0.5, 0.5, n), NPL, 2
    # ES w-kernel over 6 planes: first tap plane j0, offset t - j0 in [2, 3)
    return u, v, rng.integers(0, NPL - 5, n).astype(np.int32), rng.uniform(2, 3, n), NPL, 6


FORMS = ["none", "nearest", "linear", "quadratic", "eskernel"]


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("form", FORMS)
def test_tiled_grid_matches_jax(rng, form, with_lo):
    u, v, p0, frac, nplanes, w_order = _entry_inputs(rng, form)
    n = u.shape[0]
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    ulo = rng.uniform(-1e-4, 1e-4, n) if with_lo else None
    vlo = rng.uniform(-1e-4, 1e-4, n) if with_lo else None
    kw = dict(npixel=NPIX, support=SUP, nplanes=nplanes, tile=TILE, w_order=w_order)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def p(a):
        return None if a is None else _t(a)

    ref = np.asarray(jax_tiled_grid(
        j(u), j(v), j(vals), j(p0), j(frac), j(ulo), j(vlo), unit=64, **kw
    ))
    out = tiled_grid(
        p(u), p(v), p(vals), p(p0), p(frac), p(ulo), p(vlo), unit=100, **kw
    ).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-12)


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("form", FORMS)
def test_tiled_degrid_matches_jax(rng, form, with_lo):
    u, v, p0, frac, nplanes, w_order = _entry_inputs(rng, form)
    n = u.shape[0]
    shape = (nplanes, NPIX, NPIX)
    grids = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if form == "none":
        grids = grids[0]
    ulo = rng.uniform(-1e-4, 1e-4, n) if with_lo else None
    vlo = rng.uniform(-1e-4, 1e-4, n) if with_lo else None
    kw = dict(support=SUP, nplanes=nplanes, tile=TILE, w_order=w_order)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def p(a):
        return None if a is None else _t(a)

    ref = np.asarray(jax_tiled_degrid(
        j(u), j(v), j(grids), j(p0), j(frac), j(ulo), j(vlo), unit=64, **kw
    ))
    out = tiled_degrid(
        p(u), p(v), p(grids), p(p0), p(frac), p(ulo), p(vlo), unit=100, **kw
    ).numpy()
    assert out.shape == (n,)
    np.testing.assert_allclose(out, ref, atol=1e-12)


@pytest.mark.parametrize("case", ["all_same_cell", "single", "all_outside"])
def test_tiled_edge_cases_match_jax(rng, case):
    """The edge cases of the JAX package's own tiled tests: one cell for
    every entry (one segment of many units), a single entry, and every
    entry outside the grid."""
    if case == "all_same_cell":
        n = 1000
        u, v = np.full(n, 43.3), np.full(n, 77.7)
    elif case == "single":
        n = 1
        u, v = np.asarray([30.2]), np.asarray([99.9])
    else:
        n = 500
        u = rng.uniform(-400, -100, n)
        v = rng.uniform(NPIX + 100, NPIX + 400, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    kw = dict(support=SUP, tile=TILE, unit=64)
    ref = np.asarray(jax_tiled_grid(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(vals), npixel=NPIX, **kw
    ))
    out = tiled_grid(_t(u), _t(v), _t(vals), npixel=NPIX, **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-11)
    grid = rng.normal(size=(NPIX, NPIX)) + 1j * rng.normal(size=(NPIX, NPIX))
    dref = np.asarray(jax_tiled_degrid(jnp.asarray(u), jnp.asarray(v), jnp.asarray(grid), **kw))
    dout = tiled_degrid(_t(u), _t(v), _t(grid), **kw).numpy()
    np.testing.assert_allclose(dout, dref, atol=1e-11)


def _w_column(rng, n):
    """w in [-24, 24] with both ends present: 12 ES planes then step 16
    wavelengths exactly, so the end points sit at integer plane
    coordinates in every arithmetic. There the ES w-weights jump by
    exp(-beta) ~ 1e-8 between the two equivalent tap sets, and the JAX
    package's jit may round the plane coordinate one ulp either way."""
    w = rng.uniform(-24, 24, n)
    w[:2] = (-24.0, 24.0)
    return w


CORE = [
    (1, False, "linear"),
    (6, True, "linear"),
    (6, True, "quadratic"),
    (12, True, "eskernel"),
]


@pytest.mark.parametrize("nw,stacking,w_interp", CORE)
def test_invert_core_tiled_matches_jax(rng, nw, stacking, w_interp):
    n, npixel = 2000, 128
    u, v = rng.uniform(-500, 500, n), rng.uniform(-500, 500, n)
    w = _w_column(rng, n)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    wgt = rng.uniform(0.5, 1.0, n)
    kw = dict(npixel=npixel, cellsize=2e-4, support=8, nw=nw,
              do_wstacking=stacking, gridder="tiled", w_interp=w_interp)
    ref, rsw = jax_invert_core(*(jnp.asarray(a) for a in (u, v, w, vals, wgt)), **kw)
    out, sw = invert_core(*(_t(a) for a in (u, v, w, vals, wgt)), **kw)
    ref = np.asarray(ref)
    np.testing.assert_allclose(float(sw), float(rsw), rtol=1e-14)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-10 * np.max(np.abs(ref))


@pytest.mark.parametrize("nw,stacking,w_interp", CORE)
def test_predict_core_tiled_matches_jax(rng, nw, stacking, w_interp):
    n, npixel = 2000, 128
    u, v = rng.uniform(-300, 300, n), rng.uniform(-300, 300, n)
    w = _w_column(rng, n)
    img = rng.normal(size=(npixel, npixel))
    kw = dict(cellsize=2e-4, support=8, nw=nw, do_wstacking=stacking,
              gridder="tiled", w_interp=w_interp)
    ref = np.asarray(jax_predict_core(*(jnp.asarray(a) for a in (u, v, w, img)), **kw))
    out = predict_core(*(_t(a) for a in (u, v, w, img)), **kw).numpy()
    assert np.max(np.abs(out - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_core_prepix_split_coordinates_match_jax(rng):
    """prepix: padded-grid pixel coordinates with (hi, lo) residuals, the
    compensated core path of the epsilon rows, ES w-gridding at 12 planes."""
    n, npixel, cellsize = 1500, 128, 2e-4
    npad = 256  # _npad_for(128, 2)
    u, v = rng.uniform(-300, 300, n), rng.uniform(-300, 300, n)
    w = _w_column(rng, n)
    up = -u * npad * cellsize + npad // 2
    vp = v * npad * cellsize + npad // 2
    uh, vh = up.astype(np.float32).astype(np.float64), vp.astype(np.float32).astype(np.float64)
    args = (uh, vh, w)
    lo = (up - uh, vp - vh)
    kw = dict(cellsize=cellsize, support=8, nw=12, w_interp="eskernel", prepix=True)
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    wgt = np.ones(n)
    ref, _ = jax_invert_core(
        *(jnp.asarray(a) for a in (*args, vals, wgt, *lo)), npixel=npixel, **kw
    )
    out, _ = invert_core(*(_t(a) for a in (*args, vals, wgt, *lo)), npixel=npixel, **kw)
    ref = np.asarray(ref)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-10 * np.max(np.abs(ref))
    img = rng.normal(size=(npixel, npixel))
    pref = np.asarray(jax_predict_core(
        *(jnp.asarray(a) for a in (*args, img, *lo)), **kw
    ))
    pout = predict_core(*(_t(a) for a in (*args, img, *lo)), **kw).numpy()
    assert np.max(np.abs(pout - pref)) <= 1e-10 * np.max(np.abs(pref))


@pytest.mark.parametrize("w_order", [1, 6])
def test_entry_stream_sorts_each_segment_by_corner(rng, w_order):
    """The stream K9 walks: the in-grid entries of the segment-order sort,
    each segment's entries permuted into (row, column) window-corner order
    (stable), and the unit table over it unchanged."""
    npix, tile, sup, nplanes = 128, 32, 6, 8
    n = 3000
    u = _t(rng.uniform(-10, npix + 10, n))
    v = _t(rng.uniform(-10, npix + 10, n))
    p0 = _t(rng.integers(0, nplanes - w_order, n))
    frac = _t(rng.uniform(0, 1, n))
    vals = _t(rng.normal(size=n) + 1j * rng.normal(size=n))
    kw = dict(npixel=npix, support=sup, nplanes=nplanes, tile=tile, w_order=w_order)
    stream = entry_stream(u, v, vals, p0, frac, unit=50, **kw)
    tid, _, _, ntot, _ = _entries(u, v, p0, frac, **kw)
    perm = torch.argsort(tid, stable=True)[: int((tid < ntot).sum())]
    seg_s = tid[perm]
    src = perm % n

    def corner(pix):
        i0 = torch.floor(pix).long() - (sup // 2 - 1)
        return (i0.clamp(0, npix - sup))

    seg = torch.repeat_interleave(stream.unit_seg, stream.unit_count).long()
    assert torch.equal(seg, seg_s)
    key = seg * npix * npix + corner(stream.v) * npix + corner(stream.u)
    assert bool((key[1:] >= key[:-1]).all())
    # the same entries (coordinates and weighted values) in every segment
    for s_ in torch.unique(seg):
        a = torch.stack([stream.u[seg == s_], stream.v[seg == s_]], 1)
        b = torch.stack([u[src][seg_s == s_], v[src][seg_s == s_]], 1)
        assert torch.equal(a[torch.argsort(a[:, 0])], b[torch.argsort(b[:, 0])])
    assert stream.vals.shape == (int(seg.shape[0]),)
    assert torch.equal(stream.unit_count.sum(), torch.tensor(int(seg.shape[0]), dtype=torch.int64))
