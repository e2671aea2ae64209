"""The native visibility store: a Python rim over ``native/visio.cpp``.

Counterpart of ``ska_sdp_func_python_tpu/io/visio.py``, with the same
functions and the same on-disk format: both packages load a library
built from the one C++ source. A writer, a reader with a background
prefetch thread (while the device computes on slab k, the reader thread
reads slab k+1 from disk), and a double-buffered chunk generator.

The library is compiled from the repository's ``native/visio.cpp`` with
``g++`` at first use into ``build/torch_native/``, under a name that
carries a hash of the source and flags, so an edited source is never
served by a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "VisStore",
    "stream_visibility_chunks",
    "write_visibility",
    "write_visibility_arrays",
]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "visio.cpp"
_BUILD_DIR = _ROOT / "build" / "torch_native"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_LIB = None
_LOCK = threading.Lock()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libvisio_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``native/visio.cpp`` if it is not built yet; returns the
    library's path. Raises with the compiler's output on failure."""
    so = _library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        tmp = os.path.join(work, so.name)
        proc = subprocess.run(
            ["g++", *_FLAGS, str(_SOURCE), "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SOURCE}:\n{proc.stdout}")
        os.replace(tmp, so)
    return so


def _load_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library()))
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.svis_create.restype = p
        lib.svis_create.argtypes = [ctypes.c_char_p, i64, i64, i64, i64]
        lib.svis_open.restype = p
        lib.svis_open.argtypes = [ctypes.c_char_p]
        lib.svis_dims.restype = None
        lib.svis_dims.argtypes = [p, ctypes.POINTER(i64)]
        lib.svis_meta_offsets.restype = None
        lib.svis_meta_offsets.argtypes = [p, ctypes.POINTER(i64)]
        lib.svis_write_meta.restype = ctypes.c_int
        lib.svis_write_meta.argtypes = [p, f64p, f64p, i32p, i32p, f64p]
        lib.svis_write_chunk.restype = ctypes.c_int
        lib.svis_write_chunk.argtypes = [p, i64, i64, f32p, f32p, f32p, u8p]
        lib.svis_read_chunk.restype = ctypes.c_int
        lib.svis_read_chunk.argtypes = [p, i64, i64, f32p, f32p, f32p, u8p]
        lib.svis_prefetch.restype = ctypes.c_int
        lib.svis_prefetch.argtypes = [p, i64, i64]
        lib.svis_wait.restype = ctypes.c_int
        lib.svis_wait.argtypes = [p, f32p, f32p, f32p, u8p]
        lib.svis_close.restype = None
        lib.svis_close.argtypes = [p]
        _LIB = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _host(x, dtype=None) -> np.ndarray:
    """A contiguous numpy copy of ``x`` (a tensor on any device, or
    anything numpy reads)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=dtype)


def write_visibility_arrays(
    path: str,
    *,
    uvw,
    time,
    frequency,
    antenna1,
    antenna2,
    vis,
    weight=None,
    flags=None,
    chunk_times: int = 16,
):
    """Write raw arrays to the store without building a Visibility.

    ``vis`` is complex [ntime, nbl, nchan, npol]; ``weight``/``flags``
    default to ones/zeros.
    """
    shape = np.shape(vis)
    if weight is None:
        weight = np.ones(shape, np.float32)
    if flags is None:
        flags = np.zeros(shape, np.uint8)

    class _V:
        pass

    v = _V()
    v.vis, v.weight, v.flags = vis, weight, flags
    v.frequency, v.time = frequency, time
    v.antenna1, v.antenna2, v.uvw = antenna1, antenna2, uvw
    return write_visibility(v, path, chunk_times=chunk_times)


def write_visibility(vis, path: str, chunk_times: int = 16):
    """Write a Visibility (its tensors on any device) or any object with
    numpy-compatible vis/weight/flags/uvw/time/frequency/antenna1/antenna2
    to the store. The data fields are sliced ``chunk_times`` integrations
    at a time before they reach the host, so a Visibility on the card, or
    fields that make their slices on demand, never stand whole in host
    memory."""
    lib = _load_lib()
    ntime, nbl, nchan, npol = (int(n) for n in np.shape(vis.vis))
    handle = lib.svis_create(path.encode(), ntime, nbl, nchan, npol)
    if not handle:
        raise OSError(f"cannot create {path}")
    try:
        freq = _host(vis.frequency, np.float64)
        time = _host(vis.time, np.float64)
        a1 = _host(vis.antenna1, np.int32)
        a2 = _host(vis.antenna2, np.int32)
        uvw = _host(vis.uvw, np.float64)
        rc = lib.svis_write_meta(
            handle,
            _ptr(freq, ctypes.c_double),
            _ptr(time, ctypes.c_double),
            _ptr(a1, ctypes.c_int32),
            _ptr(a2, ctypes.c_int32),
            _ptr(uvw, ctypes.c_double),
        )
        if rc != 0:
            raise OSError("meta write failed")
        del uvw
        for t0 in range(0, ntime, chunk_times):
            nt = min(chunk_times, ntime - t0)
            data = _host(vis.vis[t0 : t0 + nt])
            re = np.ascontiguousarray(np.real(data), dtype=np.float32)
            im = np.ascontiguousarray(np.imag(data), dtype=np.float32)
            wt = _host(vis.weight[t0 : t0 + nt], np.float32)
            fl = _host(vis.flags[t0 : t0 + nt], np.uint8)
            rc = lib.svis_write_chunk(
                handle,
                t0,
                nt,
                _ptr(re, ctypes.c_float),
                _ptr(im, ctypes.c_float),
                _ptr(wt, ctypes.c_float),
                _ptr(fl, ctypes.c_uint8),
            )
            if rc != 0:
                raise OSError("chunk write failed")
    finally:
        lib.svis_close(handle)


class VisStore:
    """Reader over the store with an asynchronous prefetch."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._handle = self._lib.svis_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open {path}")
        dims = (ctypes.c_int64 * 4)()
        self._lib.svis_dims(self._handle, dims)
        self.ntime, self.nbl, self.nchan, self.npol = (int(d) for d in dims)
        # the meta sections' offsets come from the library, so this reader
        # cannot drift from the writer's layout; the uvw block is memory
        # mapped, not loaded (24 GB of f64 at 1B visibilities), so a slab
        # touches only its own pages
        offs = (ctypes.c_int64 * 5)()
        self._lib.svis_meta_offsets(self._handle, offs)
        self.frequency = np.fromfile(
            path, dtype=np.float64, count=self.nchan, offset=offs[0]
        )
        self.time = np.fromfile(
            path, dtype=np.float64, count=self.ntime, offset=offs[1]
        )
        self.antenna1 = np.fromfile(
            path, dtype=np.int32, count=self.nbl, offset=offs[2]
        )
        self.antenna2 = np.fromfile(
            path, dtype=np.int32, count=self.nbl, offset=offs[3]
        )
        self.uvw = np.memmap(
            path,
            dtype=np.float64,
            mode="r",
            offset=int(offs[4]),
            shape=(self.ntime, self.nbl, 3),
        )

    def _alloc(self, nt):
        shape = (nt, self.nbl, self.nchan, self.npol)
        return (
            np.zeros(shape, dtype=np.float32),
            np.zeros(shape, dtype=np.float32),
            np.zeros(shape, dtype=np.float32),
            np.zeros(shape, dtype=np.uint8),
        )

    def read_chunk(self, t0: int, nt: int):
        """Synchronous read: returns (re, im, weight, flags)."""
        re, im, wt, fl = self._alloc(nt)
        self._lib.svis_read_chunk(
            self._handle,
            t0,
            nt,
            _ptr(re, ctypes.c_float),
            _ptr(im, ctypes.c_float),
            _ptr(wt, ctypes.c_float),
            _ptr(fl, ctypes.c_uint8),
        )
        return re, im, wt, fl

    def prefetch(self, t0: int, nt: int):
        """Starts the reader thread on integrations ``[t0, t0 + nt)``."""
        self._lib.svis_prefetch(self._handle, t0, nt)

    def wait(self, nt: int):
        """The prefetched ``nt`` integrations (blocks until read):
        (re, im, weight, flags)."""
        re, im, wt, fl = self._alloc(nt)
        self._lib.svis_wait(
            self._handle,
            _ptr(re, ctypes.c_float),
            _ptr(im, ctypes.c_float),
            _ptr(wt, ctypes.c_float),
            _ptr(fl, ctypes.c_uint8),
        )
        return re, im, wt, fl

    def close(self):
        if self._handle:
            self._lib.svis_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stream_visibility_chunks(path: str, chunk_times: int = 16):
    """Double-buffered generator of visibility chunks.

    Yields dicts of numpy arrays (vis_re, vis_im, weight, flags, uvw,
    time, ...) per time slab; the reader thread prefetches the next slab
    while the caller computes.
    """
    with VisStore(path) as store:
        steps = [
            (t0, min(chunk_times, store.ntime - t0))
            for t0 in range(0, store.ntime, chunk_times)
        ]
        if not steps:
            return
        store.prefetch(*steps[0])
        for k, (t0, nt) in enumerate(steps):
            re, im, wt, fl = store.wait(nt)
            if k + 1 < len(steps):
                store.prefetch(*steps[k + 1])
            yield {
                "t0": t0,
                "vis_re": re,
                "vis_im": im,
                "weight": wt,
                "flags": fl,
                "uvw": store.uvw[t0 : t0 + nt],
                "time": store.time[t0 : t0 + nt],
                "frequency": store.frequency,
                "antenna1": store.antenna1,
                "antenna2": store.antenna2,
            }
