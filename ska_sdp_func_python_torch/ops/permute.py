"""Fixed-permutation apply (kernel K4).

Counterpart of ``ska_sdp_func_python_tpu/ops/permute.py`` and
``permute_pallas.py``. The JAX package routes a Beneš network once per
plan and applies it as butterfly passes, because the TPU has no fast
gather. The port keeps the plan's int32 permutation and applies it in one
pass (``csrc/permute.cu``): forward ``out[i] = x[perm[i]]``, inverse
``out[perm[i]] = x[i]``. A stack of permutations ``[nchan, n]`` (one per
channel plan of a cube) applies to ``[nchan, n]`` payloads in the same
launch, and a forward payload named in ``shared`` may be one ``[n]``
source that every channel reads. Both directions are bit-exact, since elements are only
moved.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["permute_apply", "permute_apply_plain"]

_WIDE = {torch.float32: 0, torch.complex64: 1}


def _check_payloads(perm, payloads, inverse: bool, shared) -> list:
    """Per payload, whether it is a shared source (its position is in
    ``shared``: one [n] source that every channel of the stacked ``perm``
    reads, forward only); raises on a payload of any other shape than
    ``perm``'s."""
    flags = []
    for i, x in enumerate(payloads):
        is_shared = i in shared
        if is_shared and (inverse or perm.ndim != 2):
            raise ValueError(
                f"payload {i}: a shared source needs a forward apply of a "
                f"stack [nchan, n], not perm {tuple(perm.shape)}"
                f"{' inverse' if inverse else ''}"
            )
        want = perm.shape[1:] if is_shared else perm.shape
        if x.shape != want:
            raise ValueError(
                f"payload {i} shape {tuple(x.shape)} for a permutation of shape "
                f"{tuple(perm.shape)}: expected {tuple(want)}"
            )
        flags.append(is_shared)
    return flags


def permute_apply_plain(perm, *payloads, inverse: bool = False, shared=()):
    """Plain version of :func:`permute_apply` (indexing)."""
    idx = perm.long()
    if perm.ndim == 2:
        # channel c's indices offset into row c of the flattened payload
        nchan, n = perm.shape
        flat = (idx + n * torch.arange(nchan, device=idx.device)[:, None]).reshape(-1)
    outs = []
    for x, is_shared in zip(payloads, _check_payloads(perm, payloads, inverse, shared)):
        if is_shared or perm.ndim == 1:
            if inverse:
                y = torch.empty_like(x)
                y[idx] = x
            else:
                y = x[idx]
        elif inverse:
            y = torch.empty_like(x)
            y.reshape(-1)[flat] = x.reshape(-1)
        else:
            y = x.reshape(-1)[flat].reshape(x.shape)
        outs.append(y)
    return outs[0] if len(outs) == 1 else tuple(outs)


def permute_apply(perm: torch.Tensor, *payloads, inverse: bool = False, shared=()):
    """Apply the permutation ``perm`` ([n], or a stack [nchan, n]) to one
    to four payloads of its shape in one pass. The payloads at the
    positions in ``shared`` are instead one [n] source that every channel
    of a stack reads (forward only). Returns one tensor or a tuple
    matching ``payloads``, each of ``perm``'s shape. On CUDA each payload
    must be float32 or complex64 (they may be mixed)."""
    if perm.device.type == "cpu":
        return permute_apply_plain(perm, *payloads, inverse=inverse, shared=shared)
    if not 1 <= len(payloads) <= 4:
        raise ValueError(f"{len(payloads)} payloads; one launch moves 1 to 4")
    if perm.ndim not in (1, 2):
        raise ValueError(f"perm: shape {tuple(perm.shape)}, expected [n] or [nchan, n]")
    dev = perm.device
    nchan, n = (1, perm.shape[0]) if perm.ndim == 1 else perm.shape
    if nchan > 65535:
        raise ValueError(f"{nchan} channels; one launch takes at most 65535")
    kernels.check_cuda_tensor("perm", perm, torch.int32, dev)
    wide = stride0 = 0
    flags = _check_payloads(perm, payloads, inverse, shared)
    for i, x in enumerate(payloads):
        if x.dtype not in _WIDE:
            raise TypeError(f"payload {i}: dtype {x.dtype} not f32/c64")
        kernels.check_cuda_tensor(f"payload {i}", x, x.dtype, dev)
        wide |= _WIDE[x.dtype] << i
        stride0 |= flags[i] << i
    outs = [torch.empty(perm.shape, dtype=x.dtype, device=dev) for x in payloads]
    pad = [None] * (4 - len(payloads))
    kernels.KERNELS["permute"].launch(
        perm.data_ptr(),
        int(n),
        int(nchan),
        len(payloads),
        wide,
        stride0,
        1 if inverse else 0,
        *[x.data_ptr() for x in payloads],
        *pad,
        *[y.data_ptr() for y in outs],
        *pad,
    )
    return outs[0] if len(outs) == 1 else tuple(outs)
