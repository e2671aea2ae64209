"""Plan-sorted gridding (K1+K2) and degridding (K3): tap evaluation, the
kernel wrappers and their plain PyTorch versions.

Counterpart of ``ska_sdp_func_python_tpu/ops/gridding_fused.py``. What the
TPU kernels compute is kept; the TPU layout around them is not (no 8/24-row
payload, packed value rows, mod-8 tap rotation, quad MXU layout or bf16x3
passes). A plan (``gridding_plan.GridPlan``) stores, per sorted entry, the
clipped window corner (iu0, iv0), the lower (or, on a nearest-plane plan,
the only) w-plane, the plane fraction and the separable ES taps of each
axis over the plan's window (``span`` cells: the support, one more for an
odd support, see ``gridding_plan``), zero-padded to the kernels' width
(:func:`tap_width`: 8 up to a span of 8, 16 up to 16) as ``[n, width]``
arrays.

Each wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches the hand-written kernel (``csrc/grid.cu``,
``csrc/degrid.cu``) or raises. :func:`degrid_stack` degrids every channel
of a stack of plans (``gridding_plan.GridPlanStack``) in one launch.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = [
    "MAX_SUPPORT",
    "tap_width",
    "grid",
    "grid_plain",
    "degrid",
    "degrid_plain",
    "degrid_stack",
    "degrid_stack_plain",
]


# the largest support the kernels take: a window of S > 16 cells would
# need a residue-class period of 32, and K1's int64 tile at tile 64 would
# not fit in a block's shared memory
MAX_SUPPORT = 16


def tap_width(span: int) -> int:
    """Width of the stored tap rows of a plan whose windows are ``span``
    cells wide: the residue-class period of K1 and the lanes of K3 that
    serve one entry (8 or 16)."""
    if not 1 <= span <= MAX_SUPPORT:
        raise ValueError(
            f"a window of {span} cells: the plan kernels take supports 1 to "
            f"{MAX_SUPPORT}"
        )
    return 8 if span <= 8 else 16


def _es_taps(pix, i0, support: int, span: int, beta: float | None = None, lo=None):
    """The separable ES-kernel taps of each coordinate over a window of
    ``span`` cells, ``[n, tap_width(span)]`` (zero
    past ``span``): taps[c, k] = es(i0_c + k - pix_c), evaluated in the
    coordinate dtype (f64 coordinates give positionally exact taps) and
    stored as f32. ``lo``: optional f32 residual of a split (hi, lo)
    coordinate pair, subtracted after the small difference so the full
    position survives f32 arithmetic."""
    half = support / 2.0
    if beta is None:
        beta = 2.3 * support
    k = torch.arange(span, device=pix.device, dtype=pix.dtype)[None, :]
    offs = i0.to(pix.dtype)[:, None] + k - pix[:, None]
    if lo is not None:
        offs = offs - lo[:, None]
    nu = offs / half
    nu2 = torch.clamp(nu * nu, 0.0, 1.0)
    t = torch.exp(beta * (torch.sqrt(1.0 - nu2) - 1.0))
    t = torch.where(nu.abs() < 1.0, t, 0.0).to(torch.float32)
    pad = tap_width(span) - span
    return torch.nn.functional.pad(t, (0, pad)).contiguous()


def _window_index(plan, n):
    """Flat grid index ``[n, S, S]`` of each entry's window on its lower
    (or only) plane, S the plan's window (``span``)."""
    off = torch.arange(plan.span, device=plan.iu0.device)
    rows = plan.iv0[:n, None].long() + off
    cols = plan.iu0[:n, None].long() + off
    npix = plan.npixel
    plane = plan.plane[:n].long() * (npix * npix)
    return plane[:, None, None] + rows[:, :, None] * npix + cols[:, None, :]


def grid_plain(plan, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grid`: ``index_add_`` of every in-grid
    entry's S x S window, weighted (1 - frac, frac) onto its lower and
    upper w-plane (a nearest-plane plan: onto its one plane). ``vals`` [n]
    in plan order -> [nplanes, npix, npix] grids of the same dtype
    (complex128 values give an f64-accumulated reference)."""
    npix, n, s = plan.npixel, plan.n_in, plan.span
    v = vals[:n]
    patch = plan.kv[:n, :s, None] * plan.ku[:n, None, :s]  # [n, S, S]
    idx = _window_index(plan, n)
    out = torch.zeros(
        plan.nplanes * npix * npix, dtype=vals.dtype, device=vals.device
    )
    if plan.wstacked:
        f = plan.frac[:n]
        lo = (v * (1.0 - f))[:, None, None] * patch
        hi = (v * f)[:, None, None] * patch
        idx = torch.cat([idx.reshape(-1), idx.reshape(-1) + npix * npix])
        contrib = torch.cat([lo.reshape(-1), hi.reshape(-1)])
    else:
        idx = idx.reshape(-1)
        contrib = (v[:, None, None] * patch).reshape(-1)
    out.index_add_(0, idx, contrib.to(vals.dtype))
    return out.reshape(-1, npix, npix)


def _check_taps(plan, lead):
    """The kernels read each entry's taps, ``[*lead, tap_width(span)]``,
    as 16-byte vectors."""
    width = tap_width(plan.span)
    for name in ("ku", "kv"):
        t = getattr(plan, name)
        if t.shape != (*lead, width):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, expected {(*lead, width)}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def grid(plan, vals: torch.Tensor) -> torch.Tensor:
    """Grid plan-ordered complex64 values onto the complex64 plane grids
    ``[nplanes, npix, npix]`` (kernel K1+K2 on CUDA, the same bits from run
    to run), at the plan's support, on linear (plane pairs) or
    nearest-plane (one plane an entry) plans."""
    if vals.device.type == "cpu":
        return grid_plain(plan, vals)
    dev = vals.device
    k = kernels.KERNELS["grid"]
    chk = kernels.check_cuda_tensor
    if vals.shape != (plan.n,):
        raise ValueError(f"vals: shape {tuple(vals.shape)}, expected ({plan.n},)")
    npix = plan.npixel
    _check_taps(plan, (plan.n,))
    vals_ptr = chk("vals", vals, torch.complex64, dev)
    # the kernel accumulates in int64 fixed point, scaled by the stream's
    # bound: the sum of |re| + |im| over vals times the plan's tap bound
    vsum = torch.view_as_real(vals).abs().sum().reshape(1)
    grid64 = torch.empty(
        (plan.nplanes, npix, npix, 2), dtype=torch.int64, device=dev
    )
    out = torch.empty(
        (plan.nplanes, npix, npix), dtype=torch.complex64, device=dev
    )
    k.launch(
        vals_ptr,
        chk("iu0", plan.iu0, torch.int32, dev),
        chk("iv0", plan.iv0, torch.int32, dev),
        chk("frac", plan.frac, torch.float32, dev),
        chk("ku", plan.ku, torch.float32, dev),
        chk("kv", plan.kv, torch.float32, dev),
        chk("korder", plan.korder, torch.int32, dev),
        chk("chunk_seg", plan.chunk_seg, torch.int32, dev),
        chk("chunk_start", plan.chunk_start, torch.int32, dev),
        chk("chunk_count", plan.chunk_count, torch.int32, dev),
        chk("tap_bound", plan.tap_bound, torch.float32, dev),
        vsum.data_ptr(),
        grid64.data_ptr(),
        out.data_ptr(),
        int(plan.chunk_seg.shape[0]),
        plan.nplanes,
        npix,
        plan.tile,
        npix // plan.tile,
        plan.span,
        4 if plan.wstacked else 2,
    )
    return out


def degrid_plain(plan, grids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`degrid`: gather each entry's S x S windows,
    val = sum_x (sum_r G[r, x] kv[r]) ku[x] on the lower and upper plane,
    weighted (1 - frac, frac) (a nearest-plane plan: on its one plane).
    Returns [n] complex64 in plan order, zero for out-of-grid entries."""
    npix, n, s = plan.npixel, plan.n_in, plan.span
    g = grids.reshape(-1)
    idx = _window_index(plan, n)
    kv = plan.kv[:n, :s].to(torch.complex64)
    ku = plan.ku[:n, :s].to(torch.complex64)

    def window(ix):
        a = torch.einsum("nrx,nr->nx", g[ix], kv)
        return torch.einsum("nx,nx->n", a, ku)

    v = window(idx)
    if plan.wstacked:
        f = plan.frac[:n]
        v = v * (1.0 - f) + window(idx + npix * npix) * f
    out = torch.zeros(plan.n, dtype=torch.complex64, device=grids.device)
    out[:n] = v
    return out


def degrid_stack_plain(stack, grids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`degrid_stack`: :func:`degrid_plain` on each
    channel's plan in turn. Returns [nchan, n] complex64."""
    return torch.stack(
        [degrid_plain(gp, grids[c]) for c, gp in enumerate(stack.plans)]
    )


def _launch_degrid(src, grids, nchan: int, n_in_ptr, n_in0: int):
    """One K3 launch over the ``nchan`` channels of ``src`` (a plan, or a
    stack of them); returns [nchan, n] complex64."""
    dev = grids.device
    chk = kernels.check_cuda_tensor
    npix = src.npixel
    if grids.shape != (nchan, src.nplanes, npix, npix):
        raise ValueError(
            f"grids: shape {tuple(grids.shape)}, expected "
            f"{(nchan, src.nplanes, npix, npix)}"
        )
    if nchan > 65535:
        raise ValueError(f"{nchan} channels; one launch takes at most 65535")
    if src.nplanes * npix * npix >= 2**31:
        raise ValueError(f"{src.nplanes} planes of {npix}^2: a window offset exceeds int32")
    lead = (src.n,) if src.perm.ndim == 1 else (nchan, src.n)
    for name in ("iu0", "iv0", "plane", "frac"):
        if getattr(src, name).shape != lead:
            raise ValueError(f"{name}: shape {tuple(getattr(src, name).shape)}")
    walk = (src.n_in,) if src.perm.ndim == 1 else lead
    if src.korder.shape != walk:
        raise ValueError(f"korder: shape {tuple(src.korder.shape)}, expected {walk}")
    _check_taps(src, lead)
    out = torch.empty((nchan, src.n), dtype=torch.complex64, device=dev)
    kernels.KERNELS["degrid"].launch(
        chk("grids", grids, torch.complex64, dev),
        chk("iu0", src.iu0, torch.int32, dev),
        chk("iv0", src.iv0, torch.int32, dev),
        chk("plane", src.plane, torch.int32, dev),
        chk("frac", src.frac, torch.float32, dev),
        chk("ku", src.ku, torch.float32, dev),
        chk("kv", src.kv, torch.float32, dev),
        chk("korder", src.korder, torch.int32, dev),
        n_in_ptr,
        n_in0,
        out.data_ptr(),
        src.n,
        nchan,
        npix,
        src.nplanes,
        src.span,
        1 if src.wstacked else 0,
    )
    return out


def degrid(plan, grids: torch.Tensor) -> torch.Tensor:
    """Degrid plan-ordered complex64 values from the plane grids (kernel
    K3 on CUDA)."""
    if grids.device.type == "cpu":
        return degrid_plain(plan, grids)
    return _launch_degrid(plan, grids[None], 1, None, plan.n_in)[0]


def degrid_stack(stack, grids: torch.Tensor) -> torch.Tensor:
    """Degrid every channel of a plan stack (``gridding_plan.GridPlanStack``)
    from its grids ``[nchan, nplanes, npix, npix]`` complex64 in one launch
    (kernel K3 on CUDA); returns [nchan, n] complex64, each channel in its
    plan's order, zero for its out-of-grid entries."""
    if grids.device.type == "cpu":
        return degrid_stack_plain(stack, grids)
    n_in = kernels.check_cuda_tensor("n_in", stack.n_in, torch.int32, grids.device)
    return _launch_degrid(stack, grids, stack.nchan, n_in, 0)
