"""Fixed-permutation apply (kernel K4).

Counterpart of ``ska_sdp_func_python_tpu/ops/permute.py`` and
``permute_pallas.py``. The JAX package routes a Beneš network once per
plan and applies it as butterfly passes, because the TPU has no fast
gather. The port keeps the plan's int32 permutation and applies it in one
pass (``csrc/permute.cu``): forward ``out[i] = x[perm[i]]``, inverse
``out[perm[i]] = x[i]``. Both are bit-exact, since elements are only
moved.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["permute_apply", "permute_apply_plain"]

_WIDE = {torch.float32: 0, torch.complex64: 1}


def permute_apply_plain(perm, *payloads, inverse: bool = False):
    """Plain version of :func:`permute_apply` (indexing)."""
    idx = perm.long()
    outs = []
    for x in payloads:
        if inverse:
            y = torch.empty_like(x)
            y[idx] = x
        else:
            y = x[idx]
        outs.append(y)
    return outs[0] if len(outs) == 1 else tuple(outs)


def permute_apply(perm: torch.Tensor, *payloads, inverse: bool = False):
    """Apply the permutation to one to four same-length 1-D payloads in one
    pass; returns one tensor or a tuple matching ``payloads``. On CUDA each
    payload must be float32 or complex64 (they may be mixed)."""
    if perm.device.type == "cpu":
        return permute_apply_plain(perm, *payloads, inverse=inverse)
    if not 1 <= len(payloads) <= 4:
        raise ValueError(f"{len(payloads)} payloads; one launch moves 1 to 4")
    dev = perm.device
    n = int(perm.shape[0])
    kernels.check_cuda_tensor("perm", perm, torch.int32, dev)
    wide = 0
    for i, x in enumerate(payloads):
        if x.dtype not in _WIDE:
            raise TypeError(f"payload {i}: dtype {x.dtype} not f32/c64")
        if x.shape != (n,):
            raise ValueError(f"payload {i}: shape {tuple(x.shape)} != ({n},)")
        kernels.check_cuda_tensor(f"payload {i}", x, x.dtype, dev)
        wide |= _WIDE[x.dtype] << i
    outs = [torch.empty_like(x) for x in payloads]
    pad = [None] * (4 - len(payloads))
    kernels.KERNELS["permute"].launch(
        perm.data_ptr(),
        n,
        len(payloads),
        wide,
        1 if inverse else 0,
        *[x.data_ptr() for x in payloads],
        *pad,
        *[y.data_ptr() for y in outs],
        *pad,
    )
    return outs[0] if len(outs) == 1 else tuple(outs)
