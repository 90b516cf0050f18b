"""K1 ``panel_fwd``: Dz = Dz0 + G s, the forward panel product.

Replaces the Pallas kernel ``fwd_dd`` (``mgbtpu/ops/pallas_dd.py:186``,
kernel ``_fwd_kernel`` :174), whose f64 counterpart on the x64 path is
``PanelOps.apply_G`` (``mgbtpu/solver/levelops.py:58-62``) plus the Dz0 add
of ``barrier._Dz``. It runs in every level f0/f1/f2.

CUDA design (``csrc/panel_fwd.cu``): one thread per (element, node) pair
gathers ``s[cols[e, :]]`` itself (the TPU kernel got the gathered slab from
XLA) and keeps the nD sums in registers. What bounds it on an H100: bytes —
the panels (nD*N*p*C doubles) are read once for 2 flops per 8 bytes, far
below the f64 rate; at fem2d_P2 L=5 the ~4 MB working set sits in the 50 MB
L2, so the call is launch-bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B

NAME = "panel_fwd"
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def panel_fwd_plain(panels, cols, s, dz0=None):
    """Plain PyTorch version: gather + einsum (+ Dz0)."""
    nD, N, p, C = panels.shape
    out = torch.einsum("kNpc,Nc->Npk", panels, s[cols]).reshape(N * p, nD)
    return out if dz0 is None else dz0 + out


def panel_fwd(panels, cols, s, dz0=None):
    """panels (nD, N, p, C) f64, cols (N, C) int64, s (n_J,), dz0 optional
    (N*p, nD) -> (N*p, nD). The plain version on CPU tensors; the CUDA
    kernel on CUDA tensors."""
    if not B.on_cuda(NAME, panels, cols, s, dz0):
        return panel_fwd_plain(panels, cols, s, dz0)
    nD, N, p, C = panels.shape
    B.require(nD <= 8, NAME, f"nD={nD} exceeds 8")
    B.cuda_f64(NAME, panels, (nD, N, p, C), "panels")
    B.cuda_i64(NAME, cols, (N, C), "cols")
    B.require(s.dim() == 1 and s.dtype == torch.float64 and s.is_contiguous(),
              NAME, "s must be a contiguous float64 vector")
    if dz0 is not None:
        B.cuda_f64(NAME, dz0, (N * p, nD), "dz0")
    out = torch.empty((N * p, nD), dtype=torch.float64, device=s.device)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(panels), B.ptr(cols), B.ptr(s),
             None if dz0 is None else B.ptr(dz0), B.ptr(out),
             nD, N, p, C, B.stream(s.device))
    B.check(NAME, err)
    panel_fwd.launches += 1
    return out


panel_fwd.launches = 0
