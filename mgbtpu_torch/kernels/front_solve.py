"""K5b ``front_forward`` / ``front_backward``: one tree level's share of a
nested-dissection solve sweep, fused: the gathers, the triangular solves
with the front factors, the coupling products and the forward sweep's
separator update.

The solve half of the Pallas kernel ``panel_chol_inv`` (``mgbtpu/ops/
pallas_dd.py:446``): on the TPU the kernel's inverse factor turned the dd
solves into products; the x64 reference solves with the factor itself,
``r[adofs]``, ``lax.linalg.triangular_solve`` and the ``U`` einsums in
``nd_solve`` (``mgbtpu/ops/ndchol.py:538-559``), per tree level of every
preconditioner application. The separator update gathers over the inverse
incidence of the level's boundary dofs, as the JAX package's dd solve does
with ``b_inc`` (``mgbtpu/ops/ndchol.py:318-332, 766-768``).

CUDA design (``csrc/front_solve.cu``): one block per front, substitution in
32-wide diagonal tiles (one warp solves a tile with shuffles, then the
block applies the tile's off-diagonal panel, reading the factor by rows in
32-double segments), two block barriers per tile; the separator update is a
second kernel of the forward entry, a fixed-order gather. One wrapper call
per tree level and sweep, with no torch ops between the launches, each
kernel launched as a Hopper programmatic dependent (``csrc/pdl.cuh``), so
the next one is scheduled while it runs. What bounds it on an H100: bytes
in principle (the factor and U read once, 2 flops per 8 bytes); at these
front sizes the ceil(a/32)-step chain of tile solves.

The two sweeps share one launch count, ``front_solve.launches``.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from . import _build as B

NAME = "front_solve"
_FWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

front_solve = SimpleNamespace(launches=0)   # K5b's launches, both sweeps


def front_forward_plain(Lf, U, adofs, r, rows, inc):
    """Plain PyTorch version: the gather, ``torch.linalg.solve_triangular``
    and the einsum; the separator update as a left fold over ``inc``'s
    columns (the same bits as a sequential scatter-add of -upd)."""
    y = torch.linalg.solve_triangular(Lf, r[adofs][:, :, None],
                                      upper=False)[:, :, 0]
    upd = torch.einsum("nba,na->nb", U, y)
    flat = torch.cat([upd.reshape(-1), upd.new_zeros(1)])
    acc = r[rows]
    for t in range(inc.shape[1]):
        acc = acc - flat[inc[:, t]]
    r[rows] = acc
    return y, upd


def front_backward_plain(Lf, U, adofs, bdofs, y, x):
    """Plain PyTorch version: the gather, the einsum,
    ``torch.linalg.solve_triangular`` and the dump mask."""
    t = y - torch.einsum("nba,nb->na", U, x[bdofs])
    xA = torch.linalg.solve_triangular(Lf.mT, t[:, :, None],
                                       upper=True)[:, :, 0]
    xA = torch.where(adofs < x.shape[0] - 1, xA, torch.zeros_like(xA))
    x[adofs.reshape(-1)] = xA.reshape(-1)
    return xA


def _check_front(Lf, U, adofs, v):
    nk, a = adofs.shape
    b = U.shape[1]
    B.cuda_f64(NAME, Lf, (nk, a, a), "Lf")
    B.cuda_f64(NAME, U, (nk, b, a), "U")
    B.cuda_i64(NAME, adofs, (nk, a), "adofs")
    B.cuda_f64(NAME, v, (v.shape[0],), "the vector")
    return nk, a, b, v.shape[0] - 1


def front_forward(Lf, U, adofs, r, rows, inc):
    """One tree level of the forward sweep, on the padded residual r
    (n_J + 1,), in place. Lf (nk, a, a) lower and U (nk, b, a) factors,
    adofs (nk, a): y = Lf^-1 r[adofs], upd = U y, then
    r[rows[i]] -= upd.flat[inc[i, t]] for t in turn (inc (nr, Kb) padded
    with nk*b). Returns (y (nk, a), upd (nk, b))."""
    if not B.on_cuda(NAME, Lf, U, adofs, r, rows, inc):
        return front_forward_plain(Lf, U, adofs, r, rows, inc)
    nk, a, b, _ = _check_front(Lf, U, adofs, r)
    nr, Kb = inc.shape
    B.cuda_i64(NAME, rows, (nr,), "rows")
    B.cuda_i64(NAME, inc, (nr, Kb), "inc")
    y = torch.empty((nk, a), dtype=torch.float64, device=r.device)
    upd = torch.empty((nk, b), dtype=torch.float64, device=r.device)
    fn = B.launcher(NAME, _FWD_ARGS, "front_forward_launch")
    err = fn(B.ptr(Lf), B.ptr(U), B.ptr(adofs), B.ptr(rows), B.ptr(inc),
             B.ptr(r), B.ptr(y), B.ptr(upd), nk, a, b, nr, Kb,
             B.stream(r.device))
    B.check(NAME, err)
    front_solve.launches += 1
    return y, upd


def front_backward(Lf, U, adofs, bdofs, y, x):
    """One tree level of the backward sweep, on the padded solution x
    (n_J + 1,), in place: t = y - U' x[bdofs], xA = Lf^-T t, 0 where
    adofs >= n_J, written to x[adofs]. Returns xA (nk, a)."""
    if not B.on_cuda(NAME, Lf, U, adofs, bdofs, y, x):
        return front_backward_plain(Lf, U, adofs, bdofs, y, x)
    nk, a, b, n_J = _check_front(Lf, U, adofs, x)
    B.cuda_i64(NAME, bdofs, (nk, b), "bdofs")
    B.cuda_f64(NAME, y, (nk, a), "y")
    xA = torch.empty((nk, a), dtype=torch.float64, device=x.device)
    fn = B.launcher(NAME, _BWD_ARGS, "front_backward_launch")
    err = fn(B.ptr(Lf), B.ptr(U), B.ptr(adofs), B.ptr(bdofs), B.ptr(y),
             B.ptr(x), B.ptr(xA), nk, a, b, n_J, B.stream(x.device))
    B.check(NAME, err)
    front_solve.launches += 1
    return xA
