"""The channel-batched degrid (kernel K3) and permute (kernel K4) legs of the
port, plain versions on the CPU: the plan stack of ``make_visibility_plan``,
``degrid_stack`` and the stacked ``permute_apply`` against their
per-channel forms, and the batched cube predict against the JAX package's.

Tolerances: the stacked plain versions are bit-exact with the per-channel
ones (the same operations on the same values); the stack's channel plans
equal plans built for each channel alone; the batched predict agrees with
the JAX package's ``predict_visibility`` to 1e-5 of the visibility maximum
(f32 degridding, as in ``test_torch_cube.py``).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ska_sdp_func_python_tpu.ops.imaging import (
    make_visibility_plan as jax_make_visibility_plan,
    predict_visibility as jax_predict_visibility,
)
from ska_sdp_func_python_torch import interop
from ska_sdp_func_python_torch.ops.gridding_fused import (
    degrid_plain,
    degrid_stack,
)
from ska_sdp_func_python_torch.ops.gridding_plan import (
    STACKED,
    GridPlanStack,
    make_grid_plan,
    stack_views,
)
from ska_sdp_func_python_torch.ops.imaging import (
    make_imaging_plan,
    make_visibility_plan,
    predict_visibility,
    predict_with_plan,
    predict_with_stack,
)
from ska_sdp_func_python_torch.ops.permute import (
    permute_apply,
    permute_apply_plain,
)

from test_torch_cube import _spectral_obs

CPU = torch.device("cpu")
NPIX, TILE, NPLANES, N = 64, 32, 4, 2000


def _channel_coords(rng, kind):
    """f64 pixel coordinates (u, v) of one channel: spread over the grid
    and past its edges, wholly outside, wholly inside, or on the corners
    clipped at the grid edge (window corners 0 and npix - 8)."""
    if kind == "outside":
        return rng.uniform(-40, -10, N), rng.uniform(NPIX + 10, NPIX + 40, N)
    if kind == "inside":
        return rng.uniform(8, NPIX - 9, N), rng.uniform(8, NPIX - 9, N)
    if kind == "edges":
        lo, hi = rng.uniform(3, 4, N), rng.uniform(NPIX - 5, NPIX - 4, N)
        pick = rng.integers(0, 2, (2, N)) == 1
        return np.where(pick[0], lo, hi), np.where(pick[1], hi, lo)
    return rng.uniform(-10, NPIX + 10, N), rng.uniform(-10, NPIX + 10, N)


def _channel_plan(rng, kind, wstacked):
    u, v = _channel_coords(rng, kind)
    p0 = torch.as_tensor(rng.integers(0, NPLANES - 1, N)) if wstacked else None
    frac = torch.as_tensor(rng.uniform(0, 1, N)) if wstacked else None
    return make_grid_plan(
        torch.as_tensor(u), torch.as_tensor(v), p0, frac, npixel=NPIX,
        nplanes=NPLANES if wstacked else 1, tile=TILE,
    )


def _stack(plans):
    """The plans' arrays copied into a channel stack, as
    ``make_visibility_plan`` builds it (``stack_views`` per channel, then
    ``GridPlanStack.of``); the stack's channel plans are new views."""
    store = {}
    views = [
        dataclasses.replace(gp, **stack_views(
            store, len(plans), c, gp.n, **{k: getattr(gp, k) for k in STACKED}
        ))
        for c, gp in enumerate(plans)
    ]
    return GridPlanStack.of(store, views)


@pytest.mark.parametrize("wstacked", [True, False], ids=["wstacked", "one-plane"])
def test_stacked_degrid_plain_matches_per_channel(wstacked):
    """Ragged n_in: a channel past the grid's edges, one wholly outside
    (n_in 0), one wholly inside (n_in n), one on clipped corners."""
    rng = np.random.default_rng(31)
    kinds = ("spread", "outside", "inside", "edges")
    plans = [_channel_plan(rng, k, wstacked) for k in kinds]
    n_in = [gp.n_in for gp in plans]
    assert n_in[1] == 0 and n_in[2] == N and 0 < n_in[0] < N and 0 < n_in[3]
    edges = plans[3]
    assert {0, NPIX - 8} <= set(edges.iu0[: edges.n_in].tolist())
    stack = _stack(plans)
    assert stack.n_in.tolist() == n_in and stack.nchan == 4
    nplanes = NPLANES if wstacked else 1
    grids = torch.as_tensor(
        rng.normal(size=(4, nplanes, NPIX, NPIX, 2)).astype(np.float32)
    )
    grids = torch.view_as_complex(grids)
    out = degrid_stack(stack, grids)
    assert out.shape == (4, N) and out.dtype == torch.complex64
    for c, gp in enumerate(plans):
        assert torch.equal(out[c], degrid_plain(gp, grids[c]))
    assert not out[1].any() and out[2].all()


@pytest.mark.parametrize("mode", ["forward", "inverse", "shared"])
def test_stacked_permute_plain_matches_per_channel(mode):
    """Mixed f32 and complex64 payloads; a shared [n] source for every
    channel (forward only)."""
    rng = np.random.default_rng(37)
    nchan, n = 3, 1001
    perm = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(nchan)]).astype(np.int32))
    a = torch.as_tensor(rng.normal(size=(nchan, n)).astype(np.float32))
    b = torch.as_tensor(
        (rng.normal(size=(nchan, n)) + 1j * rng.normal(size=(nchan, n))).astype(np.complex64)
    )
    f = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    inverse = mode == "inverse"
    payloads = (b, a, f, b) if mode == "shared" else (b, a, a, b)
    shared = (2,) if mode == "shared" else ()
    out = permute_apply(perm, *payloads, inverse=inverse, shared=shared)
    assert len(out) == 4
    for c in range(nchan):
        for x, o in zip(payloads, out, strict=True):
            src = x if x.ndim == 1 else x[c]
            ref = permute_apply_plain(perm[c], src, inverse=inverse)
            assert o.shape == (nchan, n) and o.dtype == x.dtype
            assert torch.equal(o[c], ref)
    if mode == "shared":
        assert torch.equal(out[2], f[perm.long()])


def test_stacked_permute_refuses_other_shapes():
    """A payload of one channel's shape is refused unless it is named a
    shared source, and a shared source only forward on a stack."""
    perm = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="payload 0 shape"):
        permute_apply(perm, torch.zeros(5))
    with pytest.raises(ValueError, match="payload 0 shape"):
        permute_apply(perm, torch.zeros(4), shared=(0,))
    with pytest.raises(ValueError, match="shared source"):
        permute_apply(perm, torch.zeros(5), inverse=True, shared=(0,))
    with pytest.raises(ValueError, match="shared source"):
        permute_apply(perm[0], torch.zeros(5), shared=(0,))


@pytest.fixture(scope="module")
def cube():
    vis, model = _spectral_obs(4, 10, 64, (5, -3))
    pvis = interop.to_visibility(vis, device=CPU)
    pmodel = interop.to_image(model, device=CPU)
    return vis, model, pvis, pmodel


@pytest.mark.parametrize("context", ["ng", "2d"])
def test_channel_plans_are_views_of_the_stack(cube, context):
    """Each channel's plan equals the plan built for that channel alone,
    its degrid and permute arrays are views of the stack (no second copy)
    and keep the kernels' 16-byte tap alignment."""
    _, _, pvis, pmodel = cube
    vplan = make_visibility_plan(pvis, pmodel, context=context)
    st = vplan.stack
    assert st.nchan == 4 and st.perm.shape == (4, st.n)
    uvw = pvis.uvw_lambda
    for c, ip in enumerate(vplan.plans):
        alone = make_imaging_plan(
            uvw[:, :, c, 0].reshape(-1), uvw[:, :, c, 1].reshape(-1),
            uvw[:, :, c, 2].reshape(-1), npixel=pmodel.npixel,
            cellsize=pmodel.cellsize, nw=vplan.nw, do_wstacking=vplan.do_wstacking,
            padding=1.25,
        )
        gp, ref = ip.gp, alone.gp
        for f in gp.__dataclass_fields__:
            a, b = getattr(gp, f), getattr(ref, f)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f
        for k in STACKED:
            view = getattr(gp, k)
            assert view.data_ptr() == getattr(st, k)[c].data_ptr()
            assert view.untyped_storage().data_ptr() == getattr(st, k).untyped_storage().data_ptr()
        assert gp.ku.data_ptr() % 16 == 0 and gp.kv.data_ptr() % 16 == 0
        assert int(st.n_in[c]) == gp.n_in
        for k in ("corr_c", "wb_r", "wb_i"):
            if getattr(alone, k) is None:
                assert getattr(vplan, k) is None
                continue
            assert torch.equal(getattr(ip, k), getattr(alone, k))
            assert getattr(ip, k).data_ptr() == getattr(vplan, k)[c].data_ptr()


def test_batched_cube_predict_matches_jax(cube):
    """The batched predict (one head, one degrid and one permute for all
    channels) against the JAX package's per-channel plan predict, and
    against the port's per-channel predict_with_plan."""
    vis, model, pvis, pmodel = cube
    jplan = jax_make_visibility_plan(vis, model, context="ng")
    pplan = make_visibility_plan(pvis, pmodel, context="ng")
    rng = np.random.default_rng(41)
    pix = np.zeros((4, 1, 64, 64))
    iy, ix = rng.integers(12, 52, (2, 6))
    pix[:, 0, iy, ix] = rng.uniform(0.5, 2.0, (4, 6))
    jim = model.replace(pixels=jnp.asarray(pix))
    ref = np.asarray(jax_predict_visibility(vis, jim, plan=jplan).vis)
    out = predict_visibility(pvis, interop.to_image(jim, device=CPU), plan=pplan).vis.numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.abs(ref).max()
    images = torch.as_tensor(pix[:, 0])
    both = predict_with_stack(pplan, images)
    sorted_ = predict_with_stack(pplan, images, to_sorted=True)
    for c, ip in enumerate(pplan.plans):
        one = predict_with_plan(ip, images[c])
        assert np.max(np.abs((both[c] - one).numpy())) <= 1e-6 * float(one.abs().max())
        assert torch.equal(permute_apply_plain(ip.gp.perm, both[c]), sorted_[c])
