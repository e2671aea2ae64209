"""Parity of the port's multi-scale multi-frequency CLEAN (MSMFS; kernel
K8, plain version on the CPU) and its moment-stack helpers with the JAX
package.

Tolerances:
* the three moment-stack functions (scale-moment residual, scale-scale
  moment-moment PSF, Hessian and inverse), in f64: 1e-10 of their maxima;
* ``msmfsclean`` against the JAX XLA loop (``_msmfs_loop``) in f64, for
  the RASCIL and CASA criteria and with a clean window: identical
  component positions, model and residual to 1e-8 of their maxima;
* ``msmfsclean`` in f32 against the JAX TPU kernel K8 run in interpret mode
  (``use_pallas=True``) on the JAX package's own parity setup: 1e-5 of the
  maxima, the bound the JAX package's test holds the kernel to.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops import cleaners as jcl
from ska_sdp_func_python_torch.ops import cleaners as pcl

import test_cleaners

CPU = torch.device("cpu")
SCALES = (0, 3, 10)


def _channel_psf(n, sigma):
    yy, xx = np.mgrid[0:n, 0:n] - n // 2
    r = np.hypot(yy, xx)
    return np.exp(-(r / sigma) ** 2) + 0.04 * np.cos(r / (0.6 * sigma)) * (r > 1.5 * sigma)


def _moment_problem(nmoment, n=64, nchan=8, seed=11):
    """Moment dirty images [nmoment, n, n] and moment PSFs [2 nmoment, n, n]
    of a channel cube over 100-163 MHz: the PSF narrows with frequency;
    point sources with spectral indices and an extended blob, plus noise."""
    rng = np.random.default_rng(seed)
    freq = np.linspace(1.0e8, 1.63e8, nchan)
    f0 = freq[nchan // 2]
    psfs = np.stack([_channel_psf(n, 2.5 * f0 / f) for f in freq])
    g = np.mgrid[0:n, 0:n]
    dirty = np.zeros((nchan, n, n))
    for c, f in enumerate(freq):
        pad = np.zeros((2 * n, 2 * n))
        for y, x, flux, alpha in [(20, 26, 2.0, -0.7), (44, 40, 1.3, 0.5), (22, 30, 0.8, -1.5)]:
            pad[y : y + n, x : x + n] += flux * (f / f0) ** alpha * psfs[c]
        ext = np.exp(-(((g[0] - 40) / 6.0) ** 2 + ((g[1] - 18) / 6.0) ** 2))
        dirty[c] = pad[n // 2 : n // 2 + n, n // 2 : n // 2 + n] + 0.4 * ext
    dirty += rng.normal(0, 0.004, dirty.shape)
    x = (freq - f0) / f0
    w = x[:, None] ** np.arange(2 * nmoment)[None, :]
    return (
        np.einsum("cm,cyx->myx", w[:, :nmoment], dirty),
        np.einsum("cm,cyx->myx", w, psfs),
    )


@pytest.mark.parametrize("nmoment", [2, 3])
def test_moment_stacks_match_jax(nmoment):
    dirty, psf = _moment_problem(nmoment, n=48)
    ss = pcl.create_scalestack(48, 48, SCALES, device=CPU)
    jss = jcl.create_scalestack(48, 48, SCALES)
    a = pcl.calculate_scale_moment_residual(torch.as_tensor(dirty), ss)
    b = np.asarray(jcl.calculate_scale_moment_residual(jnp.asarray(dirty), jss))
    assert a.shape == b.shape == (len(SCALES), nmoment, 48, 48)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10 * np.abs(b).max())
    a = pcl.calculate_scale_scale_moment_moment_psf(torch.as_tensor(psf), ss)
    b = np.asarray(jcl.calculate_scale_scale_moment_moment_psf(jnp.asarray(psf), jss))
    assert a.shape == b.shape
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10 * np.abs(b).max())
    h, ih = pcl.calculate_scale_inverse_moment_moment_hessian(a)
    jh, jih = jcl.calculate_scale_inverse_moment_moment_hessian(jnp.asarray(b))
    for x, y in ((h, jh), (ih, jih)):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-10 * np.abs(y).max())


@pytest.mark.parametrize(
    "findpeak,window",
    [("RASCIL", False), ("CASA", False), ("RASCIL", True)],
    ids=["rascil", "casa", "rascil-quarter-window"],
)
def test_msmfsclean_matches_jax_loop_f64(findpeak, window):
    dirty, psf = _moment_problem(3)
    n = dirty.shape[-1]
    win = None
    if window:
        # the quarter window of find_window
        win = np.zeros((n, n))
        win[n // 4 + 1 : 3 * (n // 4), n // 4 + 1 : 3 * (n // 4)] = 1.0
    kw = dict(gain=0.3, niter=40, scales=SCALES, fracthresh=0.01, findpeak=findpeak)
    jm, jr = jcl.msmfsclean(
        jnp.asarray(dirty), jnp.asarray(psf),
        None if win is None else jnp.asarray(win), use_pallas=False, **kw,
    )
    pm, pr = pcl.msmfsclean(
        torch.as_tensor(dirty), torch.as_tensor(psf),
        None if win is None else torch.as_tensor(win), **kw,
    )
    jm, jr = np.asarray(jm), np.asarray(jr)
    assert pm.dtype == torch.float64 and pm.shape == jm.shape == (3, n, n)
    np.testing.assert_array_equal(pm.numpy() != 0.0, jm != 0.0)
    np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=1e-8 * np.abs(jm).max())
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-8 * np.abs(jr).max())


def test_msmfsclean_matches_jax_kernel_f32():
    """The JAX package's own K8 parity setup (256^2 moment images, a 128^2
    moment PSF, two moments, scales 0 and 4), its kernel run in interpret
    mode."""
    d, p = test_cleaners.TestPallasMsmfsParity()._setup(np.random.default_rng(1805550721))
    kw = dict(gain=0.1, niter=25, scales=[0, 4], fracthresh=0.01)
    jm, jr = jcl.msmfsclean(d, p, use_pallas=True, **kw)
    pm, pr = pcl.msmfsclean(
        torch.tensor(np.asarray(d)), torch.tensor(np.asarray(p)), **kw
    )
    jm, jr = np.asarray(jm), np.asarray(jr)
    assert pm.dtype == torch.float32
    np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=1e-5 * np.abs(jm).max())
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-5 * np.abs(jr).max())


def _plain_inputs(nmoment=2, n=48):
    dirty, psf = _moment_problem(nmoment, n=n)
    st = pcl.msmfs_psf_stacks(torch.as_tensor(psf), n, n, SCALES)
    smres = pcl.calculate_scale_moment_residual(
        torch.as_tensor(dirty) / st.pmax, st.scalestack
    ).contiguous()
    return st, smres


def test_stop_rule_has_no_09_factor():
    """The loop stops before the subtraction once |mval[0]| < absthresh:
    a threshold just above a pick's |mval[0]| stops it there, where a 0.9
    factor (Hogbom, msclean) would let it go on."""
    st, smres = _plain_inputs()
    gain = 0.2
    rows, _ = pcl.msmfs_rows_plain(
        smres, st.canvas, st.hsmm, st.ihsmm, gain=gain, thresh=0.0,
        fracthresh=0.0, niter=30,
    )
    mval0 = (rows[:, 4] / gain).abs().numpy()
    assert bool((rows[:, 3] > 0).all())
    # the first pick k whose |mval[0]| lies below every earlier one, and a
    # threshold above it, within 1/0.9 of it, and at most the earlier ones
    k = next(i for i in range(3, 30) if mval0[i] < mval0[:i].min())
    thresh = min(float(mval0[:k].min()), float(mval0[k]) / 0.92)
    assert 0.9 * thresh < mval0[k] < thresh <= mval0[:k].min()
    rows2, _ = pcl.msmfs_rows_plain(
        smres, st.canvas, st.hsmm, st.ihsmm, gain=gain, thresh=thresh,
        fracthresh=0.0, niter=30,
    )
    assert int((rows2[:, 3] > 0).sum()) == k
    torch.testing.assert_close(rows2[:k], rows[:k], rtol=0, atol=0)


def test_msmfs_rows_rebuild_the_moment_model():
    """The rows rebuild the moment model: one scale blob per used row,
    times gain * mval[n] for moment n, clipped at the edges, in emission
    order."""
    st, smres = _plain_inputs(n=48)
    rows, _, lane_model = pcl.msmfs_lanes(
        smres[None], st.canvas, st.hsmm, st.ihsmm, st.pscalestack, gain=0.5,
        thresh=0.0, fracthresh=0.01, niter=20,
    )
    assert 0 < int((rows[0, :, 3] > 0).sum()) <= 20
    model = pcl.msmfs_rows_to_model(rows[0], st.pscalestack, 48, 48)
    assert torch.equal(lane_model[0], model)
    n, pn = 48, st.pscalestack.shape[-1]
    ref = np.zeros((2, n, n))
    blobs = st.pscalestack.numpy()
    for y, x, s, used, *gm in rows[0].tolist():
        if used <= 0:
            continue
        canvas = np.zeros((2 * n, 2 * n))
        o = n - pn // 2
        canvas[o : o + pn, o : o + pn] = blobs[int(s)]
        patch = canvas[n - int(y) : 2 * n - int(y), n - int(x) : 2 * n - int(x)]
        ref += np.asarray(gm)[:, None, None] * patch[None]
    np.testing.assert_allclose(model.numpy(), ref, rtol=0, atol=1e-12)


def test_msmfs_sensitivity_raises():
    """A sensitivity image is refused: the JAX package multiplies the
    [nscales, ny, nx] search by the [nmoment, ny, nx] sensitivity stack,
    which fails unless the counts agree."""
    dirty, psf = _moment_problem(2, n=48)
    with pytest.raises(NotImplementedError, match="no reference behaviour"):
        pcl.msmfsclean(
            torch.as_tensor(dirty), torch.as_tensor(psf),
            sensitivity=torch.ones(2, 48, 48, dtype=torch.float64),
        )


def test_window_picks_the_scale_not_the_pixel():
    """As in the JAX package (after the reference), the window only
    restricts the search that picks the scale; the pixel is the first
    argmax of the unwindowed |moment-0 solution| of that scale, here the
    bright source outside the window."""
    dirty, psf = _moment_problem(2, n=48)
    win = np.zeros((48, 48))
    win[:, 30:] = 1.0  # leaves out the sources at x 26 and 30 (y 20, 22)
    kw = dict(gain=0.3, niter=5, scales=SCALES, fracthresh=0.01)
    jm, jr = jcl.msmfsclean(
        jnp.asarray(dirty), jnp.asarray(psf), jnp.asarray(win), use_pallas=False, **kw
    )
    st = pcl.msmfs_psf_stacks(torch.as_tensor(psf), 48, 48, SCALES)
    smres = pcl.calculate_scale_moment_residual(torch.as_tensor(dirty) / st.pmax, st.scalestack)
    ws = (pcl.convolve_scalestack(st.scalestack, torch.as_tensor(win)) > 0.9).double()
    rows, _ = pcl.msmfs_rows_plain(
        smres, st.canvas, st.hsmm, st.ihsmm, ws, gain=0.3, thresh=0.0,
        fracthresh=0.01, niter=5,
    )
    y, x, s = (int(v) for v in rows[0, :3])
    assert win[y, x] == 0.0
    sol0 = (st.ihsmm[s, 0, 0] * smres[s, 0] + st.ihsmm[s, 1, 0] * smres[s, 1]).abs()
    assert divmod(int(torch.argmax(sol0)), 48) == (y, x)
    pm, pr = pcl.msmfsclean(
        torch.as_tensor(dirty), torch.as_tensor(psf), torch.as_tensor(win), **kw
    )
    jm = np.asarray(jm)
    np.testing.assert_array_equal(pm.numpy() != 0.0, jm != 0.0)
    np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=1e-8 * np.abs(jm).max())


TIED_PICKS = [(30, 30, 1), (30, 31, 1), (31, 2, 1), (5, 5, 2)]


def tied_stacks(dtype=torch.float64, device=CPU):
    """Stacks with exact ties: unit Hessians, so the criterion is the
    moment-0 residual, equal peaks at (31, 2), (30, 31) and (30, 30) of
    scale 1 and at (5, 5) of scale 2, and a canvas by which each pick
    clears only its own pixel. In (scale, y, x) order the picks are scale 1
    (30, 30), (30, 31), (31, 2), then scale 2 (5, 5)."""
    ns, nm, n, pn = 3, 2, 40, 16
    smres = torch.zeros((ns, nm, n, n), dtype=dtype, device=device)
    for s, y, x in ((2, 5, 5), (1, 31, 2), (1, 30, 31), (1, 30, 30)):
        smres[s, 0, y, x] = 1.0
    canvas = torch.zeros((ns, ns, 2 * nm - 1, pn, pn), dtype=dtype, device=device)
    for s in range(ns):
        canvas[s, s, :, pn // 2, pn // 2] = 1.0  # a pick clears its own pixel
    eye = torch.eye(nm, dtype=dtype, device=device).expand(ns, nm, nm).contiguous()
    return smres, canvas.contiguous(), eye, eye


def test_ties_go_to_the_first_index():
    smres, canvas, h, ih = tied_stacks()
    rows, _ = pcl.msmfs_rows_plain(
        smres, canvas, h, ih, gain=1.0, thresh=0.0, fracthresh=0.01, niter=4
    )
    assert [tuple(int(v) for v in r[:3]) for r in rows] == TIED_PICKS


def test_hessian_inverse_is_taken_in_f64():
    """The moment Hessian of a wide band is poorly conditioned: its inverse
    is taken in f64 on the host and cast to the stacks' dtype, so the card
    and the CPU start from the same numbers."""
    _, psf = _moment_problem(3, n=48)
    st = pcl.msmfs_psf_stacks(torch.as_tensor(psf, dtype=torch.float32), 48, 48, SCALES)
    assert st.ihsmm.dtype == torch.float32 and st.ihsmm.is_contiguous()
    ref = torch.linalg.inv(st.hsmm.double()).float()
    assert torch.equal(st.ihsmm, ref)
    assert float(torch.linalg.cond(st.hsmm.double()).max()) > 1e3


@pytest.mark.parametrize("findpeak", ["RASCIL", "CASA"])
def test_msmfs_with_stacks_matches_jax(findpeak):
    """The fused cycle's entry, ``msmfs_with_stacks``, on the CPU: the
    moment model is the one the rows rebuilt before the kernel built it
    (``msmfs_rows_to_model`` of the plain rows), and matches the JAX
    package's XLA loop in f64 (identical positions, 1e-8 of the maxima)."""
    dirty, psf = _moment_problem(2)
    n = dirty.shape[-1]
    kw = dict(gain=0.3, niter=40, fracthresh=0.01, findpeak=findpeak)
    jm, jr = jcl.msmfsclean(
        jnp.asarray(dirty), jnp.asarray(psf), use_pallas=False, scales=SCALES, **kw
    )
    st = pcl.msmfs_psf_stacks(torch.as_tensor(psf), n, n, SCALES)
    pm, pr = pcl.msmfs_with_stacks(st, torch.as_tensor(dirty), thresh=0.0, **kw)
    jm, jr = np.asarray(jm), np.asarray(jr)
    np.testing.assert_array_equal(pm.numpy() != 0.0, jm != 0.0)
    np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=1e-8 * np.abs(jm).max())
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-8 * np.abs(jr).max())
    smres = pcl.calculate_scale_moment_residual(
        torch.as_tensor(dirty) / st.pmax, st.scalestack
    )
    rows, _ = pcl.msmfs_rows_plain(
        smres, st.canvas, st.hsmm, st.ihsmm, thresh=0.0, **kw
    )
    assert torch.equal(pm, pcl.msmfs_rows_to_model(rows, st.pscalestack, n, n))
