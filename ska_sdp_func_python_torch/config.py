"""Dtype and precision policy of the PyTorch port.

Counterpart of ``ska_sdp_func_python_tpu/config.py``. On the device the
port computes in float32/complex64; float64/complex128 is opt-in by handing
a constructor f64 inputs (the tests do, to compare with the JAX package run
under x64). Working dtypes are derived from the inputs, never from global
state.

TF32 keeps about three decimal digits; it is Hopper's version of the bf16
single-pass trap, so both of PyTorch's TF32 switches are pinned off when
this module is imported.
"""

from __future__ import annotations

import torch

__all__ = [
    "complex_of",
    "real_of",
    "frac_dot_turns",
    "expi",
    "default_device",
    "resolve_device",
    "plan_cache_size",
    "set_plan_cache_size",
    "UNPORTED",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Plans kept by invert_visibility/predict_visibility when no plan is
# passed, keyed on the identity of the Visibility's uvw and frequency
# tensors. Each holds the sorted plan on the device (~100 bytes per
# visibility), so the default is small; 0 disables the cache.
_PLAN_CACHE_SIZE: int = 2


def plan_cache_size() -> int:
    return _PLAN_CACHE_SIZE


def set_plan_cache_size(n: int) -> None:
    global _PLAN_CACHE_SIZE
    _PLAN_CACHE_SIZE = int(n)
    if _PLAN_CACHE_SIZE <= 0:
        from .ops import imaging

        imaging._PLAN_CACHE.clear()


def real_of(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching ``dtype`` (f64 for f64/c128, else f32)."""
    if dtype in (torch.float64, torch.complex128):
        return torch.float64
    return torch.float32


def complex_of(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype matching ``dtype`` (c128 for f64/c128, else c64)."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def expi(phase: torch.Tensor) -> torch.Tensor:
    """exp(1j * phase) for a real tensor."""
    return torch.polar(torch.ones_like(phase), phase)


def frac_dot_turns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fractional part, in turns, of ``sum_k a[..., k] * b[..., k]``.

    Interferometric phases span thousands of turns, so a plain f32 dot
    followed by cos/sin loses ``|phase| * eps``. In f32 each product is
    formed as four error-free partials through Dekker's 12-bit split
    (hi*hi, hi*lo, lo*hi exact in f32; lo*lo negligible) and each partial
    is reduced mod 1 exactly, which keeps the summed fraction accurate to a
    few f32 ulps whatever the phase magnitude. In f64 the plain reduced dot
    is already accurate. Same contract as the JAX package's
    ``config.frac_dot_turns``: ``a`` and ``b`` broadcast with the
    contraction axis last; returns turns reduced to roughly [-2, 2].
    """
    if torch.promote_types(a.dtype, b.dtype) == torch.float64:
        d = (a * b).sum(-1)
        return d - torch.round(d)

    def frac(x):
        return x - torch.round(x)

    def split(x):
        c = 4097.0 * x  # 2**12 + 1
        hi = c - (c - x)
        return hi, x - hi

    total = None
    for k in range(a.shape[-1]):
        xh, xl = split(a[..., k].to(torch.float32))
        yh, yl = split(b[..., k].to(torch.float32))
        t = frac(xh * yh) + frac(xh * yl) + frac(xl * yh) + xl * yl
        total = t if total is None else total + t
    return frac(total)


def default_device() -> torch.device:
    """The device the port's constructors use when the caller names none:
    the CUDA card. Raises when there is none; the CPU is taken only when
    the caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for
    None."""
    return default_device() if device is None else torch.device(device)


# The public names of the JAX package's ``ops``, ``models`` and ``utils``
# namespaces that the port does not have, each with the ROADMAP slice that
# would bring it. Every name of those namespaces (and of ``io``,
# ``pipeline`` and ``parallel``) is exported by the port under its JAX
# name, so the table is empty; a test holds it so.
UNPORTED: dict = {}
