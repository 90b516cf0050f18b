"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C entry ``int <name>_launch(...)``
(``front_solve.cu`` one per sweep, ``front_forward_launch`` and
``front_backward_launch``) that launches its kernels on the stream it is
given and returns ``cudaGetLastError()``. Each source is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/mgbtpu_torch`` at first use and loaded with ctypes (no PyTorch
headers, so a build takes seconds). ``build_all`` starts one ``nvcc`` per
source, all at once.

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions (and the JAX x64 reference) compute them: the
power-cone residual s^2 - |q|^2 cancels near the barrier wall, and the line
searches accept or reject trial points on its sign.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from .._config import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NAMES = ("panel_fwd", "power_cone", "panel_adj", "gram_matvec",
         "front_factor", "front_solve", "node_barrier")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("mgbtpu_torch: nvcc not found; the CUDA kernels are "
                       "built from source at first use")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str) -> bool:
    lib = library(name)
    if not os.path.exists(lib):
        return False
    deps = [source(name)] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                             if f.endswith(".cuh")]
    return os.path.getmtime(lib) >= max(os.path.getmtime(d) for d in deps)


def build_all(names=NAMES, force=False) -> float:
    """Compile the named kernels (stale or missing ones, or all with
    ``force``), one nvcc process per source, in parallel. Returns the wall
    seconds; raises with the compiler's output if any build fails."""
    t0 = time.time()
    todo = [n for n in names if force or not _fresh(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = f"{library(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source(n)]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} ---\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, library(n))
    if failed:
        raise RuntimeError("mgbtpu_torch: kernel build failed\n"
                           + "\n".join(failed))
    return time.time() - t0


def launcher(name: str, argtypes, entry: str | None = None):
    """The ctypes entry ``entry`` (default ``<name>_launch``) of a built
    kernel library (builds it first if missing or stale)."""
    entry = entry or f"{name}_launch"
    fn = _LIBS.get(entry)
    if fn is None:
        build_all((name,))
        lib = ctypes.CDLL(library(name))
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LIBS[entry] = fn
    return fn


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, err: int):
    """Raise on a refused launch (the C entry returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"mgbtpu_torch: {name} launch failed "
                           f"(cudaError {err})")


def require(cond: bool, name: str, what: str):
    if not cond:
        raise ValueError(f"mgbtpu_torch.{name}: {what}")


def on_cuda(name: str, *tensors) -> bool:
    """True when the inputs lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (the plain version). Raises on mixed or other
    devices."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"mgbtpu_torch.{name}: inputs on devices {kinds}")


def cuda_f64(name: str, t: torch.Tensor, shape, label: str):
    require(t.dtype == torch.float64, name, f"{label} must be float64")
    require(tuple(t.shape) == tuple(shape), name,
            f"{label} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), name, f"{label} must be contiguous")


def cuda_i64(name: str, t: torch.Tensor, shape, label: str):
    require(t.dtype == torch.int64, name, f"{label} must be int64")
    require(tuple(t.shape) == tuple(shape), name,
            f"{label} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), name, f"{label} must be contiguous")
