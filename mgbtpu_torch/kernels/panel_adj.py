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
    return adjoint_sum_plain(cols, inv, panel_adj_contrib_plain(panels, Y),
                             n_J)


def panel_adj_contrib_plain(panels, Y):
    nD, N, p, C = panels.shape
    return torch.einsum("kNpc,Npk->Nc", panels,
                        Y.reshape(N, p, nD)).reshape(-1)


def adjoint_sum_plain(cols, inv, contrib, n_J):
    out = torch.zeros((n_J,), dtype=contrib.dtype, device=contrib.device)
    return scatter_add(out, cols.reshape(-1), contrib)


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


def panel_adj_contrib(panels, Y):
    """Phase A alone (one shard of a mesh): panels (nD, N, p, C), Y (N*p,
    nD) -> the per-slot contributions (N*C,); a launch of K3."""
    if not B.on_cuda(NAME, panels, Y):
        return panel_adj_contrib_plain(panels, Y)
    nD, N, p, C = panels.shape
    B.cuda_f64(NAME, panels, (nD, N, p, C), "panels")
    B.cuda_f64(NAME, Y, (N * p, nD), "Y")
    contrib = torch.empty((N * C,), dtype=torch.float64, device=Y.device)
    fn = B.launcher(NAME, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p], "panel_adj_contrib_launch")
    B.check(NAME, fn(B.ptr(panels), B.ptr(Y), B.ptr(contrib), nD, N, p, C,
                     _FORM, B.stream(Y.device)))
    panel_adj.launches += 1
    return contrib


def adjoint_sum(cols, inv, contrib, n_J):
    """Phase B alone: the (n_J,) column sums of a level's per-slot
    contributions (N*C,), each column's slots in increasing order (``inv``
    on the card, ``cols`` in the plain version); a launch of K3. On a mesh
    the first device runs it over every shard's contributions."""
    if not B.on_cuda(NAME, cols, inv, contrib):
        return adjoint_sum_plain(cols, inv, contrib, n_J)
    N, C = cols.shape
    K = inv.shape[1]
    B.cuda_i64(NAME, inv, (n_J, K), "inv")
    B.cuda_f64(NAME, contrib, (N * C,), "contrib")
    out = torch.empty((n_J,), dtype=torch.float64, device=contrib.device)
    fn = B.launcher(NAME, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p], "panel_adj_sum_launch")
    B.check(NAME, fn(B.ptr(inv), B.ptr(contrib), B.ptr(out), N, C, n_J, K,
                     B.stream(contrib.device)))
    panel_adj.launches += 1
    return out


def form(nD, N, p, C, request=0):
    """Phase A's form the C entry takes for this shape (1 staged, 3 spread;
    ``request`` 0 by shape, or the form asked for), 0 when it refuses the
    shape. Builds the library (a card's machine)."""
    fn = B.launcher(NAME, [ctypes.c_int] * 5, "panel_adj_form")
    return int(fn(nD, N, p, C, request))
