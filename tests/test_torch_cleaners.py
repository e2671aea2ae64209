"""Parity of the port's Hogbom CLEAN (kernel K5, plain version on the CPU)
with the JAX package's ``hogbom`` (its XLA loop on the CPU).

Tolerance: identical component positions; component values and the
residual to 1e-6 relative, on the same f32 residual and PSF.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops.cleaners import hogbom as jax_hogbom
from ska_sdp_func_python_torch.ops.cleaners import hogbom


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
