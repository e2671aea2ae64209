"""Build, load and launch the port's hand-written Hopper kernels.

The CUDA C++ sources live in ``csrc/`` and expose a plain C interface.
They are compiled with ``nvcc`` for ``sm_90a`` at first use, one ``nvcc``
per source, all started together, and linked into one shared library
(about seconds, against minutes for a build that includes PyTorch's
headers), which is bound with ``ctypes``. The library is built into
``build/torch_kernels/`` at the repository root, under a name that carries
a hash of the sources and flags, so an edited source is never served by a
stale library.

Each :class:`Kernel` counts its launches in a plain integer; a run can
reset the counts and read them back to show that the main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "Kernel",
    "KERNELS",
    "build_library",
    "load_library",
    "reset_launch_counts",
    "launch_counts",
    "query",
    "check_cuda_tensor",
]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [
    *_ARCH,
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_lib = None
build_log = ""


def _sources():
    return sorted(_SRC_DIR.glob("*.cu")) + sorted(_SRC_DIR.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libska_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the shared library if it is not built
    yet; returns its path. Raises with the compiler's output on failure."""
    global build_log
    so = _library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], False
        for _, proc in jobs:
            logs.append(proc.communicate()[0])
            failed |= proc.returncode != 0
        tmp = os.path.join(work, so.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *_ARCH, "-shared", "-o", tmp, *[o for o, _ in jobs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            logs.append(link.stdout)
            failed = link.returncode != 0
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, so)
    return so


def load_library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.ska_error_string.argtypes = [ctypes.c_int]
        lib.ska_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class Kernel:
    """One C entry point of the library and its launch count.

    ``argtypes`` follow ctypes: ``ctypes.c_void_p`` for each pointer and
    the stream, ``ctypes.c_int``/``c_longlong``/``c_float`` for scalars.
    The C function returns ``cudaGetLastError()`` after its launch."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        """Launch on the current CUDA stream (the stream is appended as the
        last argument) and raise if the launch was refused or failed."""
        if self._fn is None:
            lib = load_library()
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            msg = load_library().ska_error_string(rc).decode()
            raise RuntimeError(f"kernel {self.name} failed: {msg} ({rc})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

KERNELS = {
    "grid": Kernel(
        "grid",
        "ska_grid",
        [*[_P] * 14, *[_I] * 7],
    ),
    "degrid": Kernel(
        "degrid",
        "ska_degrid",
        [*[_P] * 9, _L, _P, _L, _I, _I, _I, _I, _I],
    ),
    "permute": Kernel(
        "permute",
        "ska_permute",
        [_P, _L, _I, _I, _I, _I, _I, *[_P] * 8],
    ),
    "hogbom": Kernel(
        "hogbom",
        "ska_hogbom",
        [*[_P] * 6, *[_I] * 9, _F, _F, _F],
    ),
    "msclean": Kernel(
        "msclean",
        "ska_msclean",
        [*[_P] * 10, *[_I] * 11, _F, _F, _F],
    ),
    "hogbom_complex": Kernel(
        "hogbom_complex",
        "ska_hogbom_complex",
        [*[_P] * 8, *[_I] * 9, _F, _F, _F],
    ),
    "msmfs": Kernel(
        "msmfs",
        "ska_msmfs",
        [*[_P] * 10, *[_I] * 13, _F, _F, _F],
    ),
    "unit_tiles": Kernel(
        "unit_tiles",
        "ska_unit_tiles",
        [*[_P] * 9, *[_I] * 5, ctypes.c_double, _I],
    ),
}


def query(symbol: str, *args: int) -> int:
    """Call a C helper of the library that takes ints and returns one (a
    device property, not a launch: nothing is counted)."""
    fn = getattr(load_library(), symbol)
    fn.argtypes = [_I] * len(args)
    fn.restype = _I
    return fn(*args)


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, device) -> int:
    """Validate a tensor handed to a kernel; returns its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()
