"""Parity of the port's Hogbom CLEAN (kernel K5) and complex Hogbom (K6),
plain versions on the CPU, with the JAX package's ``hogbom`` and
``hogbom_complex``.

Tolerances: identical component positions; against the XLA loops in f32,
component values and the residual to 1e-6 relative; in f64, 1e-8 of the
maxima; against the TPU complex kernel in interpret mode, 1e-6 (its
search rounds the modulus differently). Also the split of lanes over the
CTAs of the Hogbom kernels' cooperative launch (``hogbom_split``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops.cleaners import hogbom as jax_hogbom
from ska_sdp_func_python_tpu.ops.cleaners import (
    hogbom_complex as jax_hogbom_complex,
)
from ska_sdp_func_python_torch.ops.cleaners import (
    clean_split,
    hogbom,
    hogbom_complex,
    hogbom_split,
)


def _psf(n, sigma=2.5):
    y, x = np.mgrid[:n, :n] - n // 2
    ring = 0.1 * np.cos(np.hypot(x, y) / 1.7)
    return (np.exp(-(x**2 + y**2) / (2 * sigma**2)) + ring * (
        np.hypot(x, y) > 3
    )).astype(np.float32)


def _dirty(ny, psf, rng):
    py = psf.shape[0]
    pad = np.zeros((ny + py, ny + py), np.float32)
    for _ in range(5):
        y, x = rng.integers(0, ny, 2)
        pad[y : y + py, x : x + py] += rng.uniform(0.5, 2.0) * psf
    c = py // 2
    return pad[c : c + ny, c : c + ny] + 0.01 * rng.normal(
        size=(ny, ny)
    ).astype(np.float32)


@pytest.mark.parametrize(
    "ny,py,niter",
    [(64, 64, 200), (96, 32, 150)],
    ids=["psf-as-image", "bounded-psf-clipped"],
)
def test_hogbom_matches_jax(ny, py, niter):
    rng = np.random.default_rng(11)
    psf = _psf(py)
    dirty = _dirty(ny, psf, rng)
    kw = dict(gain=0.2, thresh=0.0, niter=niter, fracthresh=0.01)
    jc, jr = jax_hogbom(jnp.asarray(dirty), jnp.asarray(psf), **kw)
    pc, pr = hogbom(torch.as_tensor(dirty), torch.as_tensor(psf), **kw)
    jc, jr = np.asarray(jc), np.asarray(jr)
    pc, pr = pc.numpy(), pr.numpy()
    np.testing.assert_array_equal(pc != 0.0, jc != 0.0)
    assert np.count_nonzero(jc) > 3
    np.testing.assert_allclose(pc, jc, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(
        pr, jr, rtol=0.0, atol=1e-6 * np.max(np.abs(jr))
    )


def test_hogbom_window_matches_jax():
    """The search window keeps Hogbom off the masked pixels, as in the
    JAX package (same f32 inputs; positions identical, values 1e-6)."""
    rng = np.random.default_rng(12)
    psf = _psf(48)
    dirty = _dirty(96, psf, rng)
    win = np.zeros((96, 96), np.float32)
    win[10:80, 20:90] = 1.0
    kw = dict(gain=0.2, thresh=0.0, niter=150, fracthresh=0.01)
    jc, jr = jax_hogbom(jnp.asarray(dirty), jnp.asarray(psf), jnp.asarray(win), **kw)
    pc, pr = hogbom(
        torch.as_tensor(dirty), torch.as_tensor(psf), torch.as_tensor(win), **kw
    )
    jc, jr = np.asarray(jc), np.asarray(jr)
    pc, pr = pc.numpy(), pr.numpy()
    np.testing.assert_array_equal(pc != 0.0, jc != 0.0)
    assert np.all(pc[win == 0] == 0.0)
    np.testing.assert_allclose(pc, jc, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(pr, jr, rtol=0.0, atol=1e-6 * np.max(np.abs(jr)))


def _qu(n, rng, dtype):
    d = np.zeros((n, n))
    d[n // 2 - 20, n // 2 - 60] = 1.0
    d[(3 * n) // 4, (7 * n) // 8] = -0.7
    d[5, n - 4] = 0.9  # a peak whose PSF footprint is clipped
    d += rng.normal(0, 0.01, (n, n))
    return d.astype(dtype), (np.roll(d, 7, axis=0) * 0.6).astype(dtype)


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_hogbom_complex_matches_jax_loop_f64(window):
    """Complex Hogbom against the JAX XLA loop in f64: positions
    identical, components and residuals to 1e-8 of their maxima."""
    rng = np.random.default_rng(31)
    n = 320
    dq, du = _qu(n, rng, np.float64)
    pn = 64
    p = np.exp(-(((np.mgrid[0:pn, 0:pn] - pn // 2) / 3.0) ** 2).sum(0))
    win = None
    if window:
        win = np.ones((n, n))
        win[: n // 2 - 10, : n // 2] = 0.0  # masks the first peak
    kw = dict(gain=0.2, niter=60, fracthresh=0.01)
    jo = jax_hogbom_complex(
        jnp.asarray(dq), jnp.asarray(du), jnp.asarray(p), jnp.asarray(p),
        None if win is None else jnp.asarray(win), use_pallas=False, **kw,
    )
    po = hogbom_complex(
        torch.as_tensor(dq), torch.as_tensor(du), torch.as_tensor(p),
        torch.as_tensor(p), None if win is None else torch.as_tensor(win), **kw,
    )
    for a, b in zip(po, jo):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.abs(b).max())
    np.testing.assert_array_equal(po[0].numpy() != 0, np.asarray(jo[0]) != 0)
    if window:
        assert np.all(po[0].numpy()[win == 0] == 0.0)


def test_hogbom_complex_matches_jax_kernel_f32():
    """Against the TPU list kernel (K6b) in interpret mode at 640^2 with a
    128^2 PSF, to 1e-6 as the JAX package's own test holds it."""
    rng = np.random.default_rng(0)
    n = 640
    dq, du = _qu(n, rng, np.float32)
    pn = 128
    p = np.exp(
        -(((np.mgrid[0:pn, 0:pn] - pn // 2) / 3.0) ** 2).sum(0)
    ).astype(np.float32)
    kw = dict(gain=0.2, niter=30)
    jo = jax_hogbom_complex(
        jnp.asarray(dq), jnp.asarray(du), jnp.asarray(p), jnp.asarray(p), None,
        use_pallas=True, **kw,
    )
    po = hogbom_complex(
        torch.as_tensor(dq), torch.as_tensor(du), torch.as_tensor(p),
        torch.as_tensor(p), None, **kw,
    )
    for a, b in zip(po, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_fms_rounds_once_like_a_fused_multiply_add():
    """The plain versions' residual update c - a*b rounds once, as a fused
    multiply-add does, even where rounding the f64 difference and then
    to f32 would round twice the wrong way: here the exact value lies just
    above an f32 midpoint that the f64 rounding lands on."""
    from ska_sdp_func_python_torch.ops.cleaners import _fms

    c = np.float32(1 + 2.0**-23)
    a = np.float32(2.0**-12 * (1 + 2.0**-18))
    b = np.float32(2.0**-12 * (1 - 2.0**-18))
    twice = np.float32(np.float64(c) - np.float64(a) * np.float64(b))
    once = _fms(torch.tensor([c]), torch.tensor([a]), torch.tensor([b]))
    assert twice == np.float32(1.0)
    assert once.item() == np.float32(1 + 2.0**-23)


@pytest.mark.parametrize(
    "nlanes,ny,resident,expect",
    [
        (1, 1024, 528, (1, 512, 2)),  # the flagship: every resident CTA
        (64, 256, 528, (64, 8, 32)),  # a config-4 cube: 8 CTAs a lane
        (200, 128, 528, (200, 2, 64)),
        (3, 100, 528, (3, 100, 1)),  # no band shorter than a row
        (1, 1000, 396, (1, 334, 3)),  # ny not a multiple of the band
        (2000, 256, 528, (528, 1, 256)),  # more lanes than CTAs
        (0, 64, 528, (1, 64, 1)),
    ],
)
def test_hogbom_split_spreads_lanes_over_resident_ctas(nlanes, ny, resident, expect):
    """The Hogbom kernels' cooperative grid: never more CTAs than can be
    resident, every CTA a non-empty band of whole rows, the bands covering
    the image."""
    per_launch, ctas, band = hogbom_split(nlanes, ny, resident)
    assert (per_launch, ctas, band) == expect
    assert per_launch * ctas <= resident
    assert (ctas - 1) * band < ny <= ctas * band


# the H100's opt-in shared memory per CTA, and its shared memory per SM
SMEM_CTA, SMEM_SM = 227 * 1024, 228 * 1024


def _h100(blocks):
    """Resident CTAs of a cooperative kernel on a model of the H100: 132
    SMs, each with 228 KB of shared memory of which a CTA reserves 1 KB
    and may use at most 227 KB, and at most ``blocks`` CTAs an SM by threads
    and registers (2 for K7 and K8)."""

    def resident(smem):
        if smem > SMEM_CTA:
            return 0
        return 132 * min(blocks, SMEM_SM // (smem + 1024))

    return resident


@pytest.mark.parametrize(
    "nlanes,ny,row_bytes,expect",
    [
        # K7 at the flagship: 4 scales + the component image of 1024 columns
        (1, 1024, 4 * 5 * 1024, (1, 256, 4, 81920)),
        # K8 on the config-4 cube: (4 scales + the model) x 3 moments x 256
        (1, 256, 4 * 5 * 3 * 256, (1, 256, 1, 15360)),
        (3, 128, 4 * 5 * 128, (3, 64, 2, 5120)),
        # a band of 3 rows leaves one CTA an SM: 5 rows on 132 CTAs fit
        (1, 600, 40000, (1, 120, 5, 200000)),
        # more lanes than CTAs: two launches, one CTA a lane
        (269, 16, 4 * 3 * 16, (264, 1, 16, 3072)),
        # 4 x 2048^2 and 64 lanes of 4 x 256^2 exceed the card's shared memory
        (1, 2048, 4 * 5 * 2048, (1, 256, 8, 0)),
        (64, 256, 4 * 5 * 256, (64, 4, 64, 0)),
    ],
)
def test_clean_split_holds_bands_in_shared_memory(nlanes, ny, row_bytes, expect):
    """The msclean and MSMFS kernels' cooperative grid: the split of
    hogbom_split over the CTAs resident at the bands' shared-memory size,
    or, where a band cannot fit, over the CTAs resident without it, with
    the bands in device memory (shared memory 0)."""
    resident = _h100(2)
    per_launch, ctas, band, smem = clean_split(nlanes, ny, row_bytes, resident)
    assert (per_launch, ctas, band, smem) == expect
    if smem:
        assert smem == band * row_bytes <= SMEM_CTA
        assert per_launch * ctas <= resident(smem)
    else:
        assert band * row_bytes > SMEM_CTA or per_launch * ctas > resident(band * row_bytes)
        assert per_launch * ctas <= resident(0)


@pytest.mark.parametrize("ny", [1, 7, 100, 1000, 1024])
@pytest.mark.parametrize("nlanes", [1, 5, 300])
def test_clean_split_bands_own_every_row_once(nlanes, ny):
    """CTA c of a lane owns rows [c * band, min(ny, (c + 1) * band)): every
    band non-empty, the bands disjoint and covering the image."""
    per_launch, ctas, band, smem = clean_split(nlanes, ny, 4 * 5 * 256, _h100(2))
    owner = np.full(ny, -1)
    for c in range(ctas):
        rows = np.arange(c * band, min(ny, (c + 1) * band))
        assert rows.size > 0 and (owner[rows] == -1).all()
        owner[rows] = c
    assert (owner >= 0).all()
    assert per_launch == min(max(nlanes, 1), 264)
