"""Device and dtype policy of the PyTorch port.

The port computes in float64 throughout: Hopper has native f64, so the
JAX package's double-float emulation (its f32/TPU path) has no counterpart
here, and the reference it is held to is the JAX x64 path.

The card is the default device. ``resolve_device(None)`` is ``cuda``; with
no card present it raises instead of falling back to the CPU. The CPU runs
only when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import os

import numpy as np
import torch

DTYPE = torch.float64
EPS = float(torch.finfo(DTYPE).eps)

# Build outputs (the native AMG helper, the CUDA kernels) go to
# <checkout>/build/mgbtpu_torch, which .gitignore lists.
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "mgbtpu_torch")


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda; ``"cpu"``/``"cuda"``/a ``torch.device`` as given.
    Raises when CUDA is asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mgbtpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mgbtpu_torch: unsupported device {dev}")
    return dev


def check_dtype(dtype=None):
    """The ``dtype=`` keyword the JAX package's entry points take. The port
    computes in float64 only: ``None`` and float64 (numpy, torch or the
    name) pass; any other dtype raises ``ValueError`` rather than solving
    in a precision other than the one asked for (the JAX package's float32
    path is its double-float emulation for a chip without f64, which the
    port does not have)."""
    if dtype is None or dtype is torch.float64:
        return
    try:
        ok = np.dtype(dtype) == np.float64
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(
            f"mgbtpu_torch computes in float64 only; dtype={dtype!r} is not "
            "supported (pass dtype=None or numpy.float64)")
