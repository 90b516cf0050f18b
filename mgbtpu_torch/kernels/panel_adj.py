"""K3 ``panel_adj``: G'y, the adjoint panel product scattered into n_J.

Replaces the Pallas kernel ``adj_contrib`` (``mgbtpu/ops/pallas_dd.py:228``,
kernel :210), whose f64 counterpart on the x64 path is
``PanelOps.apply_Gt`` + ``scatter_flat`` (``mgbtpu/solver/levelops.py:
104-107, 169-176``): the gradient in every level f1.

CUDA design (``csrc/panel_adj.cu``, ``csrc/adjoint.cuh``): the TPU kernel's
two steps, per-slot contributions and their column sums, as two phases
launched from one C entry. Phase A: one thread per (element, slot), slots
on neighbouring threads, so neighbouring threads read neighbouring panel
entries; each block stages its elements' node values in shared memory.
Phase B: each column sums its slots from the inverse incidence ``inv`` in a
fixed order, by one thread (K <= 32, the fine levels) or one block (the
coarse levels, where a column has tens to thousands of slots) per column;
the C entry picks the form from K, and refuses an element whose p*nD node
values exceed phase A's stage. Phase B launches as a Hopper programmatic
dependent (``csrc/pdl.cuh``), scheduled while phase A runs. No atomics,
so every run gives the same bits; the order
differs from the plain version's, which it matches to ~1e-16 relative. What
bounds it on an H100: bytes (panels read once, 2 flops per 8 bytes); at L=5
the working set sits in L2 and the call is launch-bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from ..ops.scatter import scatter_add

NAME = "panel_adj"
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def panel_adj_plain(panels, cols, inv, Y, n_J):
    """Plain PyTorch version: einsum + scatter-add by ``cols`` (``inv`` is
    the kernel's input)."""
    nD, N, p, C = panels.shape
    contrib = torch.einsum("kNpc,Npk->Nc", panels, Y.reshape(N, p, nD))
    out = torch.zeros((n_J,), dtype=contrib.dtype, device=contrib.device)
    return scatter_add(out, cols.reshape(-1), contrib.reshape(-1))


def panel_adj(panels, cols, inv, Y, n_J):
    """panels (nD, N, p, C), cols (N, C) int64, inv (n_J, K) int64 (see
    ``solver.levelops.inverse_incidence``), Y (N*p, nD) -> (n_J,)."""
    if not B.on_cuda(NAME, panels, cols, inv, Y):
        return panel_adj_plain(panels, cols, inv, Y, n_J)
    nD, N, p, C = panels.shape
    K = inv.shape[1]
    B.cuda_f64(NAME, panels, (nD, N, p, C), "panels")
    B.cuda_i64(NAME, inv, (n_J, K), "inv")
    B.cuda_f64(NAME, Y, (N * p, nD), "Y")
    contrib = torch.empty((N * C,), dtype=torch.float64, device=Y.device)
    out = torch.empty((n_J,), dtype=torch.float64, device=Y.device)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(panels), B.ptr(inv), B.ptr(Y), B.ptr(contrib), B.ptr(out),
             nD, N, p, C, n_J, K, B.stream(Y.device))
    B.check(NAME, err)
    panel_adj.launches += 1
    return out


panel_adj.launches = 0
