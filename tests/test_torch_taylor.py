"""Parity of the port's frequency-moment (Taylor-term) transforms with the
JAX package's, in f64, to 1e-12 relative to the largest value."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.models.image import create_image as jax_create_image
from ska_sdp_func_python_tpu.ops import taylor as jt
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops import taylor as pt

CPU = torch.device("cpu")
PC = (0.0, np.deg2rad(-35.0))
FREQ = 1.0e8 + 1.0e6 * np.arange(64)


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("nmoment", [1, 3, 6])
@pytest.mark.parametrize("ref", [None, 1.2e8], ids=["mid", "given"])
def test_moment_weights_match_jax(nmoment, ref):
    w = pt.moment_weights(FREQ, ref, nmoment)
    assert w.dtype == torch.float64 and w.shape == (64, nmoment)
    _close(w.numpy(), jt.moment_weights(jnp.asarray(FREQ), ref, nmoment))
    # a frequency tensor keeps its device
    assert pt.moment_weights(torch.as_tensor(FREQ), ref, nmoment).device == CPU


@pytest.mark.parametrize("nmoment", [1, 2, 3])
def test_moment_transforms_match_jax(nmoment):
    rng = np.random.default_rng(7)
    nchan = 8
    im = jax_create_image(
        24, 0.001, PC, frequency=FREQ[:nchan], nchan=nchan,
        channel_bandwidth=np.full(nchan, 1e6),
    )
    im = im.replace(pixels=jnp.asarray(rng.normal(size=(nchan, 1, 24, 24))))
    pim = interop.to_image(im, device=CPU)
    jm = jt.calculate_image_frequency_moments(im, nmoment=nmoment)
    pm = pt.calculate_image_frequency_moments(pim, nmoment=nmoment)
    assert pm.pixels.shape == (nmoment, 1, 24, 24)
    _close(pm.pixels.numpy(), jm.pixels)
    jc = jt.calculate_image_from_frequency_taylor_terms(im, jm)
    pc = pt.calculate_image_from_frequency_taylor_terms(pim, pm)
    assert pc.pixels.shape == (nchan, 1, 24, 24)
    _close(pc.pixels.numpy(), jc.pixels)
    with pytest.raises(ValueError, match="cannot exceed"):
        pt.calculate_image_frequency_moments(pim, nmoment=nchan + 1)
