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

``node_barrier.cu`` holds 9 large kernels; ``--split-compile=0`` optimizes
them on all cores at once, which halves its build (the longest of the
seven) and leaves its SASS byte for byte the same on an H100 (CUDA 12.9).
"""
from __future__ import annotations

import ctypes
import os
import re
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
EXTRA_FLAGS = {"node_barrier": ["--split-compile=0"]}

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
    seconds; raises with the compiler's output if any build fails.
    ``PTXAS[name]`` then holds each build's (nvcc seconds, ``parse_ptxas``
    of its ``-Xptxas -v`` report)."""
    t0 = time.time()
    todo = [n for n in names if force or not _fresh(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{library(n)}.{os.getpid()}.tmp"
        log = open(f"{tmp}.log", "w+")
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(n, ()), "-Xptxas", "-v",
               "-o", tmp, source(n)]
        procs[n] = (tmp, log, subprocess.Popen(cmd, stdout=log,
                                               stderr=subprocess.STDOUT))
    failed, secs = [], {}
    while len(secs) < len(procs):
        for n, (_, _, proc) in procs.items():
            if n not in secs and proc.poll() is not None:
                secs[n] = time.time() - t0
        time.sleep(0.01)
    for n, (tmp, log, proc) in procs.items():
        log.seek(0)
        out = log.read()
        log.close()
        os.remove(f"{tmp}.log")
        if proc.returncode != 0:
            failed.append(f"--- {n} ---\n{out}")
            continue
        os.replace(tmp, library(n))
        PTXAS[n] = (secs[n], parse_ptxas(out))
    if failed:
        raise RuntimeError("mgbtpu_torch: kernel build failed\n"
                           + "\n".join(failed))
    return time.time() - t0


PTXAS: dict = {}


def parse_ptxas(text: str) -> dict:
    """ptxas's ``-v`` report -> {function: {"registers", "stack",
    "spill_stores", "spill_loads"}} (registers for kernels only)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def launcher(name: str, argtypes, entry: str | None = None):
    """The ctypes entry ``entry`` (default ``<name>_launch``) of a built
    kernel library (builds it first if missing or stale)."""
    entry = entry or f"{name}_launch"
    fn = _LIBS.get(entry)
    if fn is None:
        build_all((name,))
        lib = ctypes.CDLL(library(name))
        cfn = getattr(lib, entry)
        cfn.argtypes = list(argtypes)
        cfn.restype = ctypes.c_int
        fn = _LIBS[entry] = _on_stream_device(cfn)
    return fn


class _Stream(ctypes.c_void_p):
    """A stream argument of a C entry, which knows its device."""


def _on_stream_device(cfn):
    """``cfn`` called with the device of its stream argument (the last)
    current: a C entry launches on the current device, and the shards of a
    mesh of cards each launch on their own."""

    def call(*args):
        s = args[-1] if args else None
        if isinstance(s, _Stream) and s.device.index is not None \
                and s.device.index != torch.cuda.current_device():
            with torch.cuda.device(s.device):
                return cfn(*args)
        return cfn(*args)

    return call


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    s = _Stream(torch.cuda.current_stream(device).cuda_stream)
    s.device = device
    return s


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
