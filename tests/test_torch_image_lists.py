"""The port's image iterators, invert/predict helpers, list CLEAN API,
MSMFS minor-cycle helpers and Taylor-term lists against the JAX
package's, on seeded numpy inputs.

Tolerances: facets, their gather (flat, linear, quadratic and tukey
tapers) and channel scatter/gather exact; ``sum_invert_results``,
``sum_predict_results``, ``threshold_list``, the MSMFS helpers and the
Taylor lists 1e-10 relative (argmax ties go to the first index); the list
API runs ``deconvolve_cube``/``restore_cube`` on the gathered cube, so it
holds to tests/test_torch_deconvolution.py's bounds: identical component
positions, values to 1e-5 of the maximum for the f32 Hogbom kernels and
1e-8 for msclean and MSMFS in f64 (all but Hogbom against the port's own
cube CLEAN bit for bit, whose JAX parity that file holds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ska_sdp_func_python_tpu.ops as J
from ska_sdp_func_python_tpu.ops import cleaners as jax_cleaners
from ska_sdp_func_python_torch import interop
import ska_sdp_func_python_torch.ops as P
from ska_sdp_func_python_torch.ops import cleaners as port_cleaners

from simul import make_visibility
from test_torch_deconvolution import PC, _compare, _cube, _image, _spectral_cube

CPU = torch.device("cpu")


def _port(im):
    return interop.to_image(im, device=CPU)


def _eq(pim, jim):
    np.testing.assert_array_equal(pim.pixels.numpy(), np.asarray(jim.pixels))


def _cube_image(nchan=3, npol=1, n=64, seed=0):
    rng = np.random.default_rng(seed)
    pix = rng.normal(size=(nchan, npol, n, n))
    frame = "stokesI" if npol == 1 else "stokesIQUV"
    return _image(pix, frame)


@pytest.mark.parametrize("taper", ["flat", "linear", "quadratic", "tukey"])
@pytest.mark.parametrize("facets,overlap", [(2, 0), (2, 8), (4, 8)])
def test_facets_and_gather_match_jax(facets, overlap, taper):
    im = _cube_image()
    pim = _port(im)
    jf = list(J.image_raster_iter(im, facets=facets, overlap=overlap, taper=taper))
    pf = list(P.image_raster_iter(pim, facets=facets, overlap=overlap, taper=taper))
    assert len(pf) == len(jf) == facets * facets
    for a, b in zip(pf, jf):
        _eq(a, b)
    jflat = list(J.image_raster_iter(im, facets=facets, overlap=overlap, taper=taper,
                                     make_flat=True))
    pflat = list(P.image_raster_iter(pim, facets=facets, overlap=overlap, taper=taper,
                                     make_flat=True))
    for a, b in zip(pflat, jflat):
        _eq(a, b)
    kw = dict(facets=facets, overlap=overlap, taper=taper)
    _eq(P.image_gather_facets(pf, pim, **kw), J.image_gather_facets(jf, im, **kw))
    _eq(P.image_gather_facets(pf, pim, return_flat=True, **kw),
        J.image_gather_facets(jf, im, return_flat=True, **kw))
    _eq(P.image_gather_facets(P.image_scatter_facets(pim, **kw), pim, **kw),
        J.image_gather_facets(J.image_scatter_facets(im, **kw), im, **kw))
    double = P.image_raster_update(pim, lambda f: f.replace(pixels=2 * f.pixels), **kw)
    _eq(double, J.image_raster_update(im, lambda f: f.replace(pixels=2 * f.pixels), **kw))


def test_channels_scatter_and_gather_match_jax():
    im = _cube_image(nchan=5)
    pim = _port(im)
    for sub in (None, 2):
        jl, pl = J.image_scatter_channels(im, sub), P.image_scatter_channels(pim, sub)
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            _eq(a, b)
            np.testing.assert_array_equal(a.frequency, np.asarray(b.frequency))
        _eq(P.image_gather_channels(pl), J.image_gather_channels(jl))
    for a, b in zip(P.image_channel_iter(pim, 3), J.image_channel_iter(im, 3)):
        _eq(a, b)


def test_invert_and_predict_helpers_match_jax():
    rng = np.random.default_rng(4)
    ims = [_cube_image(nchan=2, seed=s) for s in range(3)]
    swt = [rng.uniform(1, 3, (2, 1)) for _ in ims]
    jres = [(im, jnp.asarray(w)) for im, w in zip(ims, swt)]
    pres = [(_port(im), torch.as_tensor(w)) for im, w in zip(ims, swt)]
    jim, jsw = J.sum_invert_results(jres)
    pim, psw = P.sum_invert_results(pres)
    np.testing.assert_allclose(pim.pixels.numpy(), np.asarray(jim.pixels), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(psw.numpy(), np.asarray(jsw), rtol=1e-10)
    assert P.remove_sumwt(pres)[1] is pres[1][0]
    for use_moment0 in (True, False):
        ref = J.threshold_list(ims, 0.01, 0.1, use_moment0=use_moment0)
        out = P.threshold_list([_port(im) for im in ims], 0.01, 0.1, use_moment0=use_moment0)
        assert out == pytest.approx(ref, rel=1e-10)
    vis = make_visibility(nants=5, ntimes=2, nchan=2)
    vs = [vis.replace(vis=jnp.asarray(rng.normal(size=vis.vis.shape) + 0j)) for _ in range(3)]
    ref = J.sum_predict_results([vs[0], None, vs[1], vs[2]])
    out = P.sum_predict_results([interop.to_visibility(v, device=CPU) for v in vs[:1]] + [None]
                                + [interop.to_visibility(v, device=CPU) for v in vs[1:]])
    np.testing.assert_allclose(out.vis.numpy(), np.asarray(ref.vis), rtol=1e-10)


def _lists(dirty, psf, frame="stokesI", freq=None):
    def image(pix):
        if freq is None:
            return _image(pix, frame)
        from ska_sdp_func_python_tpu.models.image import create_image

        im = create_image(pix.shape[-1], 0.001, PC, frequency=freq, nchan=pix.shape[0])
        return im.replace(pixels=jnp.asarray(pix))

    jd = J.image_scatter_channels(image(dirty))
    jp = J.image_scatter_channels(image(psf))
    return jd, jp, [_port(d) for d in jd], [_port(p) for p in jp]


def _cases(algorithm):
    rng = np.random.default_rng(50)
    if algorithm == "hogbom":
        d, p = _cube(2, 1, 48, rng)
        return _lists(d.astype(np.float32), p.astype(np.float32)), 1e-5, {}
    if algorithm == "hogbom-complex":
        d, p = _cube(2, 4, 48, rng, pol=(0.2, np.deg2rad(30.0), 0.02))
        return _lists(d.astype(np.float32), p.astype(np.float32), "stokesIQUV"), 1e-5, {}
    if algorithm == "msclean":
        d, p = _cube(2, 1, 48, rng)
        return _lists(d, p), 1e-8, {"scales": [0, 3]}
    freq, d, p = _spectral_cube(5, 48, rng)
    return _lists(d, p, freq=freq), 1e-8, {"scales": [0, 3], "nmoment": 2}


@pytest.mark.parametrize("algorithm", ["hogbom", "hogbom-complex", "msclean", "mmclean"])
def test_deconvolve_and_restore_lists_match_jax(algorithm):
    """deconvolve_list and restore_list over single-channel lists, and the
    reference-named kernel lists, on the port's cube CLEAN. Hogbom against
    the JAX package's list API; the others against the port's
    deconvolve_cube on the gathered cube, bit for bit
    (tests/test_torch_deconvolution.py holds that against the JAX
    package's), and their restore_list against the JAX package's on the
    same components and residuals."""
    (jd, jp, pd, pp), tol, extra = _cases(algorithm)
    kw = dict(algorithm=algorithm, niter=40, gain=0.2, fractional_threshold=0.01, **extra)
    pc, pr = P.deconvolve_list(pd, pp, **kw)
    assert len(pc) == len(pr) == len(jd)
    if algorithm == "hogbom":
        jc, jr = J.deconvolve_list(jd, jp, **kw)
        for a, b in zip(pc + pr, jc + jr):
            _compare(b, a, tol)
    else:
        cc, rr = P.deconvolve_cube(P.image_gather_channels(pd), P.image_gather_channels(pp),
                                   **kw)
        for a, b in zip(pc + pr, P.image_scatter_channels(cc) + P.image_scatter_channels(rr)):
            np.testing.assert_array_equal(a.pixels.numpy(), b.pixels.numpy())
        jc = [j.replace(pixels=jnp.asarray(a.pixels.numpy())) for j, a in zip(jd, pc)]
        jr = [j.replace(pixels=jnp.asarray(a.pixels.numpy())) for j, a in zip(jd, pr)]
    beam = {"bmaj": 0.3, "bmin": 0.2, "bpa": 20.0}
    jrest = J.restore_list(jc, jp, jr, clean_beam=beam)
    prest = P.restore_list(pc, pp, pr, clean_beam=beam)
    for a, b in zip(prest, jrest):
        scale = float(np.abs(np.asarray(b.pixels)).max())
        np.testing.assert_allclose(a.pixels.numpy(), np.asarray(b.pixels), rtol=0,
                                   atol=max(tol, 1e-10) * scale)
    kw.pop("algorithm")
    named = {
        "hogbom": lambda: P.hogbom_kernel_list(pd, "", pp, **kw),
        "hogbom-complex": lambda: P.complex_hogbom_kernel_list(pd, pp, **kw),
        "msclean": lambda: P.msclean_kernel_list(pd, "", pp, **kw),
        "mmclean": lambda: P.mmclean_kernel_list(pd, "", pp, **kw),
    }[algorithm]()
    for a, b in zip(named[0] + named[1], pc + pr):
        np.testing.assert_array_equal(a.pixels.numpy(), b.pixels.numpy())


def test_radler_and_list_checks_match_jax():
    """radler_deconvolve_list maps the reference's names onto the port's
    CLEANs as the JAX package does; check_psf_peak, find_window_list and
    bound_psf_list over lists."""
    (jd, jp, pd, pp), _, _ = _cases("hogbom")
    kw = dict(niter=40, gain=0.2, fractional_threshold=0.01)
    ref = J.radler_deconvolve_list(jd, jp, algorithm="generic_clean", **kw)
    out = P.radler_deconvolve_list(pd, pp, algorithm="generic_clean", **kw)
    for a, b in zip(out, ref):
        _compare(b, a, 1e-5)
    hog = P.deconvolve_list(pd, pp, algorithm="hogbom", **kw)[0]
    for a, b in zip(out, hog):
        np.testing.assert_array_equal(a.pixels.numpy(), b.pixels.numpy())
    assert P.check_psf_peak(pp) and J.check_psf_peak(jp)
    bad = [p.replace(pixels=p.pixels * 0.5) for p in pp]
    with pytest.raises(ValueError, match="unit peak"):
        P.check_psf_peak(bad)
    for shape in ("quarter", "no_edge"):
        for a, b in zip(P.find_window_list(pd, window_shape=shape),
                        J.find_window_list(jd, window_shape=shape)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(P.bound_psf_list(pd, psf_list=pp, psf_support=10),
                    J.bound_psf_list(jd, psf_list=jp, psf_support=10)):
        _eq(a, b)


def _msmfs_inputs(nscales=3, nmoment=2, n=24, seed=7):
    rng = np.random.default_rng(seed)
    smres = rng.normal(size=(nscales, nmoment, n, n))
    smres[1, 0, 5, 9] = smres[2, 0, 11, 3] = 40.0  # a tie across scales
    hs = rng.normal(size=(nscales, nmoment, nmoment)) + 3 * np.eye(nmoment)
    ihs = np.linalg.inv(hs)
    window = (rng.uniform(size=(nscales, n, n)) > 0.2).astype(float)
    return smres, hs, ihs, window


def test_msmfs_helpers_match_jax():
    smres, hs, ihs, window = _msmfs_inputs()
    T = torch.as_tensor
    a = np.zeros((4, 5))
    a[1, 2] = a[3, 0] = 2.0
    assert tuple(int(i) for i in port_cleaners.argmax(T(a))) == (1, 2)
    assert tuple(int(i) for i in port_cleaners.argmax(T(a))) == tuple(
        int(i) for i in jax_cleaners.argmax(jnp.asarray(a)))
    res, psf = np.zeros((24, 24)), np.zeros((16, 16))
    for peak in ((3, 20), (12, 12), (23, 0)):
        assert port_cleaners.overlapIndices(res, psf, *peak) == jax_cleaners.overlapIndices(
            res, psf, *peak)
    coupling = np.diag([1.5, 0.8, 1.1]) + 0.1
    for win in (None, window):
        out = port_cleaners.find_max_abs_stack(
            T(smres[:, 0]), None, None if win is None else T(win), T(coupling))
        ref = jax_cleaners.find_max_abs_stack(
            jnp.asarray(smres[:, 0]), None, None if win is None else jnp.asarray(win),
            jnp.asarray(coupling))
        assert [int(x) for x in out] == [int(x) for x in ref]
    nu = np.linspace(-1.3, 1.3, 53)
    np.testing.assert_allclose(port_cleaners.spheroidal_function(T(nu)).numpy(),
                               np.asarray(jax_cleaners.spheroidal_function(jnp.asarray(nu))),
                               rtol=1e-10, atol=1e-14)
    sol = port_cleaners.calculate_scale_moment_principal_solution(T(smres), T(ihs))
    jsol = jax_cleaners.calculate_scale_moment_principal_solution(jnp.asarray(smres), jnp.asarray(ihs))
    np.testing.assert_allclose(sol.numpy(), np.asarray(jsol), rtol=1e-10, atol=1e-12)
    for findpeak, win in (("RASCIL", window), ("CASA", None)):
        out = port_cleaners.find_global_optimum(
            T(hs), T(ihs), T(smres), None if win is None else T(win), None, findpeak)
        ref = jax_cleaners.find_global_optimum(
            jnp.asarray(hs), jnp.asarray(ihs), jnp.asarray(smres),
            None if win is None else jnp.asarray(win), None, findpeak)
        assert [int(x) for x in out[:3]] == [int(x) for x in ref[:3]]
        np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), rtol=1e-10)
    rng = np.random.default_rng(8)
    nscales, nmoment = smres.shape[:2]
    ssmmpsf = rng.normal(size=(nscales, nscales, nmoment, nmoment, 16, 16))
    scalestack = rng.normal(size=(nscales, 16, 16))
    mval = np.array([0.7, -0.2])
    lhs, rhs = jax_cleaners.overlapIndices(res, psf, 3, 20)
    out = port_cleaners.update_scale_moment_residual(T(smres), T(ssmmpsf), lhs, rhs, 0.3, 1, T(mval))
    ref = jax_cleaners.update_scale_moment_residual(
        jnp.asarray(smres), jnp.asarray(ssmmpsf), lhs, rhs, 0.3, 1, jnp.asarray(mval))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    model = rng.normal(size=(nmoment, 24, 24))
    out = port_cleaners.update_moment_model(T(model), T(scalestack), lhs, rhs, 0.3, 2, T(mval))
    ref = jax_cleaners.update_moment_model(
        jnp.asarray(model), jnp.asarray(scalestack), lhs, rhs, 0.3, 2, jnp.asarray(mval))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_taylor_lists_match_jax():
    rng = np.random.default_rng(9)
    freq, dirty, _ = _spectral_cube(6, 32, rng)
    jd, _, pd, _ = _lists(dirty, dirty, freq=freq)
    cube = J.image_gather_channels(jd)
    pcube = P.image_gather_channels(pd)
    for nmoment in (1, 3):
        ref = J.calculate_frequency_taylor_terms_from_image(cube, nmoment=nmoment)
        out = P.calculate_frequency_taylor_terms_from_image(pcube, nmoment=nmoment)
        np.testing.assert_allclose(out.pixels.numpy(), np.asarray(ref.pixels), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(ref.pixels)).max())
        ref = J.calculate_image_list_frequency_moments(jd, nmoment=nmoment)
        out = P.calculate_image_list_frequency_moments(pd, nmoment=nmoment)
        np.testing.assert_allclose(out.pixels.numpy(), np.asarray(ref.pixels), rtol=1e-10)
        jt = J.calculate_frequency_taylor_terms_from_image_list(jd, nmoment=nmoment)
        pt = P.calculate_frequency_taylor_terms_from_image_list(pd, nmoment=nmoment)
        assert len(pt) == len(jt) == nmoment
        for a, b in zip(pt, jt):
            scale = np.abs(np.asarray(b.pixels)).max()
            np.testing.assert_allclose(a.pixels.numpy(), np.asarray(b.pixels), rtol=0,
                                       atol=1e-10 * scale)
            np.testing.assert_allclose(a.frequency, np.asarray(b.frequency), rtol=1e-15)
        jm = J.calculate_image_list_frequency_moments(jd, nmoment=nmoment)
        pm = P.calculate_image_list_frequency_moments(pd, nmoment=nmoment)
        for a, b in zip(P.calculate_image_list_from_frequency_taylor_terms(pd, pm),
                        J.calculate_image_list_from_frequency_taylor_terms(jd, jm)):
            scale = np.abs(np.asarray(b.pixels)).max()
            np.testing.assert_allclose(a.pixels.numpy(), np.asarray(b.pixels), rtol=0,
                                       atol=1e-10 * scale)
