"""Where the msclean kernel's (K7) iteration goes, on one NVIDIA GPU.

Builds variants of ``ska_sdp_func_python_torch/csrc/msclean.cu``, each with
one knob changed by text substitution of the source (one ``nvcc`` each, all
started together, into ``build/clean_variants/``), and times each on a
synthetic stack at the flagship's widths: 4 scales (0, 3, 10, 30) of
1024^2 with a 1024^2 Gaussian PSF on a faint pedestal, so that every
footprint covers the image, niter 300 with no threshold, so that every
iteration runs (CUDA events, mean of 5 runs after a warm-up). The variants:

  - ``package``: the source as it is;
  - ``batch8``: eight pixels' loads issued together in place of four;
  - ``one_cta_per_sm``: ``__launch_bounds__(512, 1)`` (up to 128 registers,
    no spills; 132 CTAs of 8 rows);
  - ``256_threads``: 256 threads a CTA, four CTAs an SM (64 registers;
    512 CTAs of 2 rows);
  - ablations, which give other rows: ``no_psf_loads`` (the footprint's
    PSF and blob values replaced by a constant), ``no_division`` (the
    search's division by the coupling diagonal replaced by a product), and
    both.
Each line gives the split (lanes a launch, CTAs a lane, rows a CTA, shared
memory a CTA), the time per iteration and whether the rows equal the
package's. The ablations bound what the footprint's loads and the
divisions cost; the rest of an iteration is the barrier (see
``hogbom_shapes.py --floor``) and the sweep's instructions.

Usage: python3 clean_variants.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from ska_sdp_func_python_torch import kernels
from ska_sdp_func_python_torch.ops import cleaners as cl

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "ska_sdp_func_python_torch", "csrc", "msclean.cu")
OUT = os.path.join(ROOT, "build", "clean_variants")
N, NITER, SCALES = 1024, 300, (0, 3, 10, 30)

# each knob: (old text, new text) substitutions of the source
KNOBS = {
    "batch8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "one_cta_per_sm": [("__launch_bounds__(kThreads, 2) msclean_loop",
                        "__launch_bounds__(kThreads, 1) msclean_loop")],
    "256_threads": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                    ("__launch_bounds__(kThreads, 2) msclean_loop",
                     "__launch_bounds__(kThreads, 4) msclean_loop")],
    "no_psf_loads": [("pv[u] = ps[pq];", "pv[u] = 0.5f;"),
                     ("bv_[u] = bl[pq];", "bv_[u] = 0.5f;")],
    "no_division": [("float k = __fdiv_rn(v[u], cds);", "float k = __fmul_rn(v[u], cds);")],
}
VARIANTS = {
    "package": [],
    "batch8": ["batch8"],
    "one_cta_per_sm": ["one_cta_per_sm"],
    "256_threads": ["256_threads"],
    "no_psf_loads": ["no_psf_loads"],
    "no_division": ["no_division"],
    "no_psf_loads_no_division": ["no_psf_loads", "no_division"],
}
THREADS = {"256_threads": 256}


def build():
    """Writes and compiles every variant; returns {name: loaded library}."""
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    src = src.replace('#include "common.cuh"', f'#include "{os.path.dirname(SRC)}/common.cuh"')
    jobs = {}
    for name, knobs in VARIANTS.items():
        text = src
        for knob in knobs:
            for old, new in KNOBS[knob]:
                if old not in text:
                    raise RuntimeError(f"{name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
        cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared", "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"{name}: {regs[0] if regs else ''}", flush=True)
        lib = ctypes.CDLL(so)
        lib.ska_msclean_resident.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ska_msclean.argtypes = [
            *[ctypes.c_void_p] * 10, *[ctypes.c_int] * 11, *[ctypes.c_float] * 3,
            ctypes.c_void_p,
        ]
        libs[name] = lib
    return libs


def stacks(dev):
    """The msclean stacks of a 1024^2 Gaussian PSF on a faint pedestal and
    of a bright square on faint noise."""
    yy, xx = torch.meshgrid(
        *(torch.arange(N, device=dev) - N // 2 for _ in range(2)), indexing="ij"
    )
    r2 = (xx**2 + yy**2).float()
    psf = torch.exp(-r2 / 18.0) + 0.01 * torch.exp(-r2 / 1.0e5)
    st = cl.msclean_psf_stacks(psf, N, N, SCALES)
    g = torch.Generator(device=dev).manual_seed(1)
    dirty = torch.rand((N, N), generator=g, device=dev) * 0.01
    dirty[500:506, 520:526] += 1.0
    res = cl.convolve_scalestack(st.scalestack, dirty / st.pmax)[None].contiguous()
    return res, st


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("clean_variants: no CUDA device; nothing was run")
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    libs = build()
    res_stack, st = stacks(dev)
    ns = len(SCALES)
    args = [res_stack, st.psf_ss[None], st.coupling_diag[None], None, None,
            st.pscalestack[None]]
    ref = None
    for name, lib in libs.items():
        split = cl.clean_split(
            1, N, 4 * (ns + 1) * N, lambda smem, lib=lib: lib.ska_msclean_resident(0, smem)
        )
        res = torch.empty_like(res_stack)
        comps = torch.empty((1, N, N), device=dev)
        rows = torch.empty((1, NITER, 5), device=dev)
        scratch = torch.empty(8 * split[0] * split[1] + split[0], dtype=torch.int32, device=dev)
        ptrs = [None if t is None else t.data_ptr() for t in args]

        def run(lib=lib, split=split, res=res, comps=comps, rows=rows, scratch=scratch):
            rc = lib.ska_msclean(
                *ptrs, res.data_ptr(), comps.data_ptr(), rows.data_ptr(), scratch.data_ptr(),
                1, *split, ns, N, N, N, N, NITER, 0.1, 0.0, 0.0,
                torch.cuda.current_stream().cuda_stream,
            )
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        ms = cs.timed(run, 5)
        if ref is None:
            ref = rows.clone()
        used = int((rows[0, :, 4] > 0).sum())
        print(
            f"{name} ({THREADS.get(name, 512)} threads): split {split}, {ms:.4f} ms, "
            f"{used} iterations, {ms / max(used, 1) * 1e3:.2f} us an iteration, rows "
            f"{'equal to' if torch.equal(rows, ref) else 'other than'} the package's",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
