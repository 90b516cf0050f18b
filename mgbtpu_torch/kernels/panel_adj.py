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
the C entry picks the form from K. A level of few elements (the spectral
levels: one element of up to 1,924 slots over 9,216 rows) takes phase A's
spread form: blocks of 16 or 32 slots of an element, the element's rows
and their node values passed through shared memory in a two-stage
``cp.async`` pipeline, each slot's sum in the same order, so the same bits
and any p*nD (the staged form takes p*nD <= 4,096). The C entry picks the
form by shape (``form`` says which). Phase B launches as a Hopper programmatic
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
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FORM = 0   # phase A's form: 0 by shape; the card tests set 1 or 3


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
             nD, N, p, C, n_J, K, _FORM, B.stream(Y.device))
    B.check(NAME, err)
    panel_adj.launches += 1
    return out


panel_adj.launches = 0


def form(nD, N, p, C, request=0):
    """Phase A's form the C entry takes for this shape (1 staged, 3 spread;
    ``request`` 0 by shape, or the form asked for), 0 when it refuses the
    shape. Builds the library (a card's machine)."""
    fn = B.launcher(NAME, [ctypes.c_int] * 5, "panel_adj_form")
    return int(fn(nD, N, p, C, request))
