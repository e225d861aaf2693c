"""Build the port's CUDA sources into one shared library and load it.

The sources in ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them in seconds without PyTorch's headers, one process per source, all
started together.  The library lands in ``_build/`` under a name that
hashes the sources, the headers and the flags, so an edited
source is never served by a stale build; it is loaded with ``ctypes``.
Building happens at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

# No --use_fast_math: the kernels rely on exact isnan, isinf and -inf.  The
# prior, accept, contrary-step, point-step, range-step, glob-family,
# graphical-lasso, NUTS and fiber kernels round every product on its own
# (-fmad=false), as the op-by-op plain versions do; the product and scan
# kernels keep fused multiply-adds.
COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-Xcompiler", "-fPIC"]
FILE_FLAGS = {"prior_terms.cu": ["-fmad=false"], "accept_select.cu": ["-fmad=false"],
              "contra_step.cu": ["-fmad=false"], "point_step.cu": ["-fmad=false"],
              "range_step.cu": ["-fmad=false"],
              "glob_step.cu": ["-fmad=false"], "ticket_step.cu": ["-fmad=false"],
              "glasso_admm.cu": ["-fmad=false"], "nuts_step.cu": ["-fmad=false"],
              "fiber_slide.cu": ["-fmad=false"], "fiber_de.cu": ["-fmad=false"]}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for src in sorted(_sources() + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(repr((COMMON_FLAGS, sorted(FILE_FLAGS.items()))).encode())
    return os.path.join(BUILD_DIR, f"libmcmcdate_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple:
    """Compile the library if it is not built yet.  Returns ``(path,
    seconds, built)``; ``built`` is False when an existing build was used."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, False
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMMON_FLAGS, *FILE_FLAGS.get(os.path.basename(src), []),
                   "-c", src, "-o", obj]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        for cmd, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        tmp_lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp_lib, *objs]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, path)
    return path, time.perf_counter() - t0, True


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    lib.mcmcdate_error_string.restype = ctypes.c_char_p
    lib.mcmcdate_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, argtypes: tuple):
    """The C function ``name`` with its argument types declared (every
    pointer and the stream as ``c_void_p``)."""
    fn = getattr(library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().mcmcdate_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t):
    """Device pointer of a tensor, or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _ones(n: int, device: str):
    import torch

    return torch.ones(n, dtype=torch.float32, device=device)


def beta_arg(beta, n: int, device):
    """The ``[n]`` float32 likelihood temperature a decision kernel reads:
    ``beta`` checked, or where None a ones vector made once per chain count
    and device (the untempered case; no kernel writes it)."""
    import torch

    if beta is None:
        return _ones(n, str(device))
    require_cuda(beta, "beta", torch.float32)
    if beta.shape != (n,):
        raise ValueError(f"beta must be [{n}], got {tuple(beta.shape)}")
    return beta


def require_cuda(t, name: str, dtype=None) -> None:
    """Validate a tensor handed to a kernel: on a CUDA device, contiguous,
    and of ``dtype`` where given."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
