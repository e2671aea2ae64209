"""Parity of the port's batched StefCal solve (scalar path) with the JAX
package's ``solve_gains_core``, in f64.

Tolerance: 1e-10 absolute on gains, gain weights and residuals. Both sides
run the same iteration in f64; only reduction order differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops.solvers import (
    ne_index_map as jax_ne_index_map,
    solve_gains_core as jax_solve_gains_core,
)
from ska_sdp_func_python_torch.ops.solvers import ne_index_map, solve_gains_core


def _normal_equations(rng, nsol=5, nants=9):
    g = np.exp(1j * rng.normal(0, 0.5, (nsol, nants)))
    g = g * rng.uniform(0.8, 1.2, (nsol, nants))
    x = g[:, :, None] * np.conj(g[:, None, :])
    # interval-dependent noise: intervals converge after different numbers
    # of iterations, which exercises the per-interval freeze
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    x = x + noise * np.linspace(0.0, 0.05, nsol)[:, None, None]
    xwt = rng.uniform(0.5, 2.0, x.shape)
    x = x * xwt
    gain0 = np.ones((nsol, nants, 1, 1, 1), complex)
    return x[..., None, None], xwt[..., None, None], gain0


@pytest.mark.parametrize("phase_only", [True, False])
def test_solve_gains_core_matches_jax(phase_only):
    rng = np.random.default_rng(3)
    x, xwt, gain0 = _normal_equations(rng)
    kw = dict(niter=50, tol=1e-8, phase_only=phase_only)
    ref = jax_solve_gains_core(
        jnp.asarray(x), jnp.asarray(xwt), jnp.asarray(gain0), **kw
    )
    out = solve_gains_core(
        torch.as_tensor(x), torch.as_tensor(xwt), torch.as_tensor(gain0), **kw
    )
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-10)


def test_ne_index_map_matches_jax():
    a1, a2 = np.triu_indices(7, 1)
    np.testing.assert_array_equal(
        ne_index_map(a1, a2, 7), jax_ne_index_map(a1, a2, 7)
    )
