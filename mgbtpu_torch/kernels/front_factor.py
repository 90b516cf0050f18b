"""K5a ``front_factor``: the partial Cholesky of a batch of nested-dissection
fronts, Lf = chol((A + A')/2), U = B Lf^-T, S = C - U U'.

Replaces the Pallas kernel ``panel_chol_inv`` (``mgbtpu/ops/pallas_dd.py:
446``, kernel ``_chol_inv_kernel`` :386), which factored and inverted the
dd front panels; the x64 reference runs the same fronts through
``jnp.linalg.cholesky`` + ``triangular_solve`` + a batched product
(``mgbtpu/ops/ndchol.py:518-522``), once per tree level of every
``nd_factor``. K5b (``front_solve``) is the solve half.

CUDA design (``csrc/front_factor.cu``): one block per front, a left-looking
partial Cholesky in 32-column panels. Each panel (the rows of A on and
below its diagonal tile, and all b rows of B) is staged from F into shared
memory with ``cp.async``, symmetrized, and updated by the earlier panels as
a tiled product; one warp factors the diagonal tile in registers, the
block solves the panel's other rows against it, writes the panel out once
and takes the panel's U U' off S (S = C on the first panel). A front whose
A is not positive definite comes back all NaN (the reference's cholesky
semantics, which ``nd_finite`` reads). What bounds it on an H100: at the
front sizes of the fem2d_P2 levels (f = a + b <= 190 at L=7) neither bytes
nor flops but the chain of its ceil(a/32) panels, a few block barriers
each; the shared memory, f x 34 doubles and 17 KB, takes fronts up to
f = 790.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B

NAME = "front_factor"
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def cholesky_nan(A):
    """Batched lower Cholesky with the JAX semantics the reference relies
    on: the input is symmetrized, (A + A')/2, and a batch entry that is not
    positive definite comes back as all-NaN instead of raising."""
    A = (A + A.mT) / 2
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def front_factor_plain(F, amax, bmax):
    """Plain PyTorch version: cholesky, triangular solve, batched product on
    the blocks of F."""
    A = F[:, :amax, :amax]
    Bc = F[:, amax:amax + bmax, :amax]
    C = F[:, amax:amax + bmax, amax:amax + bmax]
    Lf = cholesky_nan(A)
    U = torch.linalg.solve_triangular(Lf.mT, Bc, upper=True, left=False)
    return Lf, U, C - U @ U.mT


def front_factor(F, amax, bmax):
    """F (nk, ld, ld) fronts, ld >= amax + bmax, eliminated slots first ->
    (Lf (nk, amax, amax), U (nk, bmax, amax), S (nk, bmax, bmax))."""
    if not B.on_cuda(NAME, F):
        return front_factor_plain(F, amax, bmax)
    nk, ld = F.shape[0], F.shape[-1]
    B.require(amax >= 1 and bmax >= 0, NAME, f"front blocks {amax}, {bmax}")
    B.require(amax + bmax <= ld, NAME, f"front width {amax + bmax} > {ld}")
    B.cuda_f64(NAME, F, (nk, ld, ld), "F")
    kw = dict(dtype=torch.float64, device=F.device)
    Lf = torch.empty((nk, amax, amax), **kw)
    U = torch.empty((nk, bmax, amax), **kw)
    S = torch.empty((nk, bmax, bmax), **kw)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(F), B.ptr(Lf), B.ptr(U), B.ptr(S), nk, amax, bmax, ld,
             B.stream(F.device))
    B.check(NAME, err)
    front_factor.launches += 1
    return Lf, U, S


front_factor.launches = 0
