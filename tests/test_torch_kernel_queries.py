"""The kernel library's C interface as the port binds it, read from the
CUDA sources (nothing is built, so this runs without ``nvcc``): every
launch entry point of ``kernels.KERNELS`` is exported with the arguments
the port binds and the stream."""

import re
from pathlib import Path

import pytest

from ska_sdp_func_python_torch import kernels

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
_EXPORT = re.compile(r"SKA_EXPORT\s+(\w+)\s+(ska_\w+)\s*\(([^)]*)\)", re.S)


def _exports():
    """{symbol: (return type, [parameter declarations])} of every source."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for ret, name, args in _EXPORT.findall(src.read_text()):
            out[name] = (ret, [a.strip() for a in args.split(",") if a.strip()])
    return out


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_every_kernel_entry_point_is_exported(name):
    k = kernels.KERNELS[name]
    ret, args = _exports()[k.symbol]
    assert ret == "int"  # cudaGetLastError() after the launch
    assert len(args) == len(k.argtypes) + 1 and args[-1] == "void* stream"
