"""K5b ``front_solve``: triangular solves with a batch of nested-dissection
front factors, x = Lf^-1 r (forward) or x = Lf^-T r (backward).

The solve half of the Pallas kernel ``panel_chol_inv`` (``mgbtpu/ops/
pallas_dd.py:446``): on the TPU the kernel's inverse factor turned the dd
solves into products; the x64 reference solves with the factor itself,
``lax.linalg.triangular_solve`` in ``nd_solve`` (``mgbtpu/ops/ndchol.py:
545, 556``), twice per tree level of every preconditioner application.

CUDA design (``csrc/front_solve.cu``): one block per front, the right-hand
side in shared memory, column-oriented substitution with one block
synchronisation per column. What bounds it on an H100: bytes in principle
(the factor read once, 2 flops per 8 bytes); at these front sizes the
a-step chain of synchronisations.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B

NAME = "front_solve"
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def front_solve_plain(Lf, r, transpose=False):
    """Plain PyTorch version: one batched triangular solve."""
    M = Lf.mT if transpose else Lf
    return torch.linalg.solve_triangular(M, r[:, :, None],
                                         upper=transpose)[:, :, 0]


def front_solve(Lf, r, transpose=False):
    """Lf (nk, a, a) lower factors, r (nk, a) -> Lf^-1 r, or Lf^-T r with
    ``transpose``, (nk, a)."""
    if not B.on_cuda(NAME, Lf, r):
        return front_solve_plain(Lf, r, transpose)
    nk, a = r.shape
    B.cuda_f64(NAME, Lf, (nk, a, a), "Lf")
    B.cuda_f64(NAME, r, (nk, a), "r")
    x = torch.empty((nk, a), dtype=torch.float64, device=r.device)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(Lf), B.ptr(r), B.ptr(x), nk, a, int(transpose),
             B.stream(r.device))
    B.check(NAME, err)
    front_solve.launches += 1
    return x


front_solve.launches = 0
