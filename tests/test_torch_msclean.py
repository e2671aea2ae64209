"""Parity of the port's multi-scale CLEAN (kernel K7, plain version on the
CPU) and its scale-stack helpers with the JAX package.

Tolerances:
* ``grdsf``, ``create_scalestack`` and the two scale-stack convolutions,
  in f64: 1e-10 (the PSWF/FFT bound the JAX package holds itself to);
* ``msclean`` against the JAX XLA loop (``use_pallas=False``) in f64:
  identical component positions, components and residual to 1e-8 of
  their maxima;
* ``msclean`` in f32 against the JAX TPU kernels run in interpret mode
  (``use_pallas=True``, the corner kernel K7, and ``"v1"``, K7v1): 1e-5
  of the maxima, the bound the JAX package's own test holds them to.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops import cleaners as jcl
from ska_sdp_func_python_tpu.ops.pswf import grdsf as jax_grdsf
from ska_sdp_func_python_torch.ops import cleaners as pcl
from ska_sdp_func_python_torch.ops.pswf import grdsf

CPU = torch.device("cpu")
SCALES = (0, 3, 10, 30)


def _gauss(pn, sigma=3.0, ring=0.0):
    yy, xx = np.mgrid[0:pn, 0:pn] - pn // 2
    r = np.hypot(yy, xx)
    return np.exp(-((yy / sigma) ** 2 + (xx / sigma) ** 2)) + ring * np.cos(
        r / 2.0
    ) * (r > 4)


def _sky(n, psf, sources, rng, noise):
    """Dirty image of point sources (y, x, flux) through ``psf``, plus an
    extended Gaussian for the larger scales and noise."""
    pn = psf.shape[0]
    pad = np.zeros((n + pn, n + pn))
    for y, x, f in sources:
        pad[y : y + pn, x : x + pn] += f * psf
    dirty = pad[pn // 2 : pn // 2 + n, pn // 2 : pn // 2 + n]
    g = np.mgrid[0:n, 0:n]
    ext = np.exp(-(((g[0] - 0.55 * n) / (0.1 * n)) ** 2 + ((g[1] - 0.3 * n) / (0.1 * n)) ** 2))
    return dirty + 0.5 * ext + rng.normal(0, noise, (n, n))


def test_grdsf_matches_jax():
    nu = np.linspace(-1.2, 1.2, 2001)
    for a, b in zip(grdsf(torch.as_tensor(nu)), jax_grdsf(jnp.asarray(nu))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", [(64, 64), (48, 40)], ids=["square", "oblong"])
def test_scalestack_and_convolutions_match_jax(shape):
    ny, nx = shape
    rng = np.random.default_rng(21)
    img = rng.normal(size=(ny, nx))
    ss = pcl.create_scalestack(ny, nx, SCALES, device=CPU)
    jss = jcl.create_scalestack(ny, nx, SCALES)
    assert ss.dtype == torch.float64
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=0, atol=1e-10)
    a = pcl.convolve_scalestack(ss, torch.as_tensor(img))
    b = jcl.convolve_scalestack(jss, jnp.asarray(img))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    a = pcl.convolve_convolve_scalestack(ss, torch.as_tensor(img))
    b = jcl.convolve_convolve_scalestack(jss, jnp.asarray(img))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


@pytest.mark.parametrize(
    "window,sensitivity",
    [(False, False), (True, False), (False, True), (True, True)],
    ids=["plain", "window", "sensitivity", "window+sensitivity"],
)
def test_msclean_matches_jax_loop_f64(window, sensitivity):
    rng = np.random.default_rng(17)
    n, pn = 128, 64
    psf = _gauss(pn, ring=0.05)
    dirty = _sky(n, psf, [(40, 50, 2.0), (90, 80, 1.4), (44, 54, 0.9), (6, 118, 2.5)], rng, 0.005)
    win = None
    if window:
        # excludes the brightest source (y 6, x 118)
        win = np.zeros((n, n))
        win[20:110, 10:100] = 1.0
    sens = rng.uniform(0.5, 1.5, (n, n)) if sensitivity else None
    kw = dict(gain=0.1, niter=40, scales=SCALES, fracthresh=0.01)
    jc, jr = jcl.msclean(
        jnp.asarray(dirty), jnp.asarray(psf),
        None if win is None else jnp.asarray(win),
        None if sens is None else jnp.asarray(sens),
        use_pallas=False, **kw,
    )
    pc, pr = pcl.msclean(
        torch.as_tensor(dirty), torch.as_tensor(psf),
        None if win is None else torch.as_tensor(win),
        None if sens is None else torch.as_tensor(sens),
        **kw,
    )
    jc, jr = np.asarray(jc), np.asarray(jr)
    assert pc.dtype == torch.float64
    np.testing.assert_array_equal(pc.numpy() != 0.0, jc != 0.0)
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=1e-8 * np.abs(jc).max())
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-8 * np.abs(jr).max())
    if window:
        # the window keeps the search off the brightest source
        assert np.abs(pc.numpy()[:20, 100:]).max() < 1e-3 * np.abs(pc.numpy()).max()


@pytest.mark.parametrize("use_pallas", [True, "v1"], ids=["corner-K7", "v1-K7v1"])
def test_msclean_matches_jax_kernels_f32(use_pallas):
    rng = np.random.default_rng(0)
    n, pn = 256, 128
    psf = _gauss(pn).astype(np.float32)
    dirty = _sky(
        n, psf, [(100, 120, 2.0), (180, 200, 1.4), (104, 124, 0.9)], rng, 0.005
    ).astype(np.float32)
    kw = dict(gain=0.1, niter=40)
    jc, jr = jcl.msclean(jnp.asarray(dirty), jnp.asarray(psf), use_pallas=use_pallas, **kw)
    pc, pr = pcl.msclean(torch.as_tensor(dirty), torch.as_tensor(psf), use_pallas=use_pallas, **kw)
    jc, jr = np.asarray(jc), np.asarray(jr)
    assert pc.dtype == torch.float32
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=1e-5 * np.abs(jc).max())
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-5 * np.abs(jr).max())


def test_msclean_rows_rebuild_components():
    """The rows the loop emits rebuild the component image: one blob per
    used row, clipped at the edges, in emission order."""
    rng = np.random.default_rng(4)
    n, pn = 48, 32
    psf = torch.as_tensor(_gauss(pn))
    dirty = torch.as_tensor(_sky(n, _gauss(pn), [(3, 44, 2.0), (30, 20, 1.0)], rng, 0.001))
    st = pcl.msclean_psf_stacks(psf, n, n, SCALES)
    res_stack = pcl.convolve_scalestack(st.scalestack, dirty / st.pmax)
    rows, _, lane_comps = pcl.msclean_lanes(
        res_stack[None], st.psf_ss[None], st.coupling_diag[None], st.pscalestack[None],
        gain=0.2, thresh=0.0, fracthresh=0.01, niter=25,
    )
    used = rows[0, :, 4] > 0
    assert 0 < int(used.sum()) <= 25
    comps = pcl.msclean_rows_to_comps(rows[0], st.pscalestack, n, n)
    assert torch.equal(lane_comps[0], comps)
    # reference: each blob placed on a zero canvas of twice the image size
    # and cut out around the peak (the JAX package's padded-canvas slice)
    ref = np.zeros((n, n))
    blobs = st.pscalestack.numpy()
    for y, x, s, gm, u in rows[0].tolist():
        if u <= 0:
            continue
        canvas = np.zeros((2 * n, 2 * n))
        o = n - pn // 2
        canvas[o : o + pn, o : o + pn] = blobs[int(s)]
        ref += canvas[n - int(y) : 2 * n - int(y), n - int(x) : 2 * n - int(x)] * gm
    np.testing.assert_allclose(comps.numpy(), ref, rtol=0, atol=1e-12)


def test_msclean_loop_rounds_as_the_jax_loop_f32():
    """At f32 the JAX package's ``_msclean_loop`` contracts the residual
    update into one fused multiply-subtract; the plain version (and the
    CUDA kernel) round the same way, so on the same f32 stacks the rows'
    positions and the residual agree bit for bit."""
    rng = np.random.default_rng(8)
    ns, n, pn = 4, 64, 32
    psf = _gauss(pn)
    st = pcl.msclean_psf_stacks(torch.as_tensor(psf, dtype=torch.float32), n, n, SCALES)
    dirty = _sky(n, psf, [(10, 40, 2.0), (40, 12, 1.3)], rng, 0.01).astype(np.float32)
    res_stack = pcl.convolve_scalestack(st.scalestack, torch.as_tensor(dirty) / st.pmax)
    res_stack = res_stack.contiguous()
    gain, niter = np.float32(0.2), 30
    absthresh = np.float32(0.01) * np.float32(res_stack[0].abs().max())
    jc, jres = jcl._msclean_loop(
        jnp.asarray(res_stack.numpy()),
        jcl._pad_psf_like(jnp.asarray(st.psf_ss.numpy()).reshape(-1, pn, pn), n, n)
        .reshape(ns, ns, 2 * n, 2 * n),
        jcl._pad_psf_like(jnp.asarray(st.pscalestack.numpy()), n, n),
        jnp.asarray(st.coupling_diag.numpy()),
        None, None, gain, absthresh, niter,
    )
    rows, res = pcl.msclean_rows_plain(
        res_stack, st.psf_ss, st.coupling_diag,
        gain=float(gain), thresh=0.0, fracthresh=0.01, niter=niter,
    )
    assert np.asarray(jres).dtype == np.float32
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    comps = pcl.msclean_rows_to_comps(rows, st.pscalestack, n, n)
    np.testing.assert_array_equal(comps.numpy() != 0, np.asarray(jc) != 0)


@pytest.mark.parametrize("window", [False, True], ids=["plain", "window+sensitivity"])
def test_msclean_with_stacks_matches_jax(window):
    """The fused cycle's entry, ``msclean_with_stacks``, on the CPU: the
    component image is the one the rows rebuilt before the kernel built it
    (``msclean_rows_to_comps`` of the plain rows), and matches the JAX
    package's XLA loop in f64 (identical positions, 1e-8 of the maxima)."""
    rng = np.random.default_rng(23)
    n, pn = 96, 48
    psf = _gauss(pn, ring=0.05)
    dirty = _sky(n, psf, [(30, 40, 2.0), (70, 60, 1.1), (8, 88, 1.6)], rng, 0.005)
    win = sens = None
    if window:
        win = np.zeros((n, n))
        win[16:90, 10:80] = 1.0
        sens = rng.uniform(0.5, 1.5, (n, n))
    kw = dict(gain=0.1, niter=40, fracthresh=0.01)
    jc, jr = jcl.msclean(
        jnp.asarray(dirty), jnp.asarray(psf),
        None if win is None else jnp.asarray(win),
        None if sens is None else jnp.asarray(sens),
        use_pallas=False, scales=SCALES, **kw,
    )
    st = pcl.msclean_psf_stacks(torch.as_tensor(psf), n, n, SCALES)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    pc, pr = pcl.msclean_with_stacks(st, t(dirty), t(win), t(sens), thresh=0.0, **kw)
    jc, jr = np.asarray(jc), np.asarray(jr)
    np.testing.assert_array_equal(pc.numpy() != 0.0, jc != 0.0)
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=1e-8 * np.abs(jc).max())
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-8 * np.abs(jr).max())
    res_stack = pcl.convolve_scalestack(st.scalestack, t(dirty) / st.pmax)
    ws = None
    if window:
        ws = (pcl.convolve_scalestack(st.scalestack, t(win)) > 0.9).double()
    rows, _ = pcl.msclean_rows_plain(
        res_stack, st.psf_ss, st.coupling_diag, ws,
        None if sens is None else t(sens), thresh=0.0, **kw,
    )
    assert torch.equal(pc, pcl.msclean_rows_to_comps(rows, st.pscalestack, n, n))


def test_msclean_lanes_are_independent():
    """Two lanes in one call give what each gives alone: rows, residual
    stacks and component images."""
    rng = np.random.default_rng(29)
    n, pn = 48, 32
    psf = torch.as_tensor(_gauss(pn))
    st = pcl.msclean_psf_stacks(psf, n, n, SCALES)
    stacks = [
        pcl.convolve_scalestack(
            st.scalestack,
            torch.as_tensor(_sky(n, _gauss(pn), [(y, x, 1.5)], rng, 0.002)) / st.pmax,
        )
        for y, x in ((12, 30), (40, 8))
    ]
    two = lambda t: torch.stack([t, t])  # noqa: E731
    kw = dict(gain=0.2, thresh=0.0, fracthresh=0.01, niter=30)
    both = pcl.msclean_lanes(
        torch.stack(stacks), two(st.psf_ss), two(st.coupling_diag), two(st.pscalestack), **kw
    )
    for i, res_stack in enumerate(stacks):
        one = pcl.msclean_lanes(
            res_stack[None], st.psf_ss[None], st.coupling_diag[None], st.pscalestack[None], **kw
        )
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])
