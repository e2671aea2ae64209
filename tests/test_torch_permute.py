"""Parity of the port's fixed-permutation apply (kernel K4, plain version on
the CPU) with the JAX package's Beneš apply and unsort_values.

Tolerance: none. The apply moves elements without arithmetic, so the
results must be bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops.gridding_plan import (
    make_grid_plan as jax_make_grid_plan,
    sort_values as jax_sort_values,
    unsort_values as jax_unsort_values,
)
from ska_sdp_func_python_tpu.ops.permute import benes_apply, benes_plan
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.gridding_plan import (
    make_grid_plan,
    sort_values,
    unsort_values,
)
from ska_sdp_func_python_torch.ops.permute import permute_apply


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    n, npix, nplanes = 3000, 128, 4
    u = rng.uniform(-10, npix + 10, n)
    v = rng.uniform(-10, npix + 10, n)
    p0 = rng.integers(0, nplanes - 1, n)
    frac = rng.uniform(0, 1, n)
    jgp = jax_make_grid_plan(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(p0), jnp.asarray(frac),
        npixel=npix, nplanes=nplanes, tile=32,
    )
    pgp = make_grid_plan(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(p0),
        torch.as_tensor(frac), npixel=npix, nplanes=nplanes, tile=32,
    )
    return jgp, pgp, rng


def test_plan_permutation_matches_jax_plan_order(case):
    jgp, pgp, _ = case
    perm = interop.permutation_from_backsort_keys(jgp.geo[3, : jgp.n])
    np.testing.assert_array_equal(pgp.perm.numpy(), perm)


@pytest.mark.parametrize("inverse", [False, True])
def test_permute_apply_bit_exact_with_benes(case, inverse):
    jgp, pgp, rng = case
    n = pgp.n
    bp = benes_plan(pgp.perm.numpy())
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    # a complex64 payload beside the f32 ones, as the workspace moves
    # values and weights together
    c = (a + 1j * b).astype(np.complex64)
    move_c = jax_unsort_values if inverse else jax_sort_values
    ref = (
        *benes_apply(bp, jnp.asarray(a), jnp.asarray(b), inverse=inverse),
        move_c(jgp, jnp.asarray(c)),
    )
    out = permute_apply(
        pgp.perm, torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c),
        inverse=inverse,
    )
    for r, o in zip(ref, out, strict=True):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_sort_and_unsort_bit_exact_with_jax(case):
    jgp, pgp, rng = case
    n = pgp.n
    vals = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    np.testing.assert_array_equal(
        sort_values(pgp, torch.as_tensor(vals)).numpy(),
        np.asarray(jax_sort_values(jgp, jnp.asarray(vals))),
    )
    np.testing.assert_array_equal(
        unsort_values(pgp, torch.as_tensor(vals)).numpy(),
        np.asarray(jax_unsort_values(jgp, jnp.asarray(vals))),
    )
