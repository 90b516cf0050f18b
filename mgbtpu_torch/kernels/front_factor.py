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
each. That form holds a whole panel, f x 34 doubles, in shared memory, so
it takes fronts up to f = 790.

One block a front leaves the card idle on the fem3d Q3 levels: few fronts
of large a and b (the L=5 plan's upper levels hold 1-32 fronts of f =
1,394 .. 3,290, up to 8 GFLOP a front). Those take the large form: all
fronts of a tree level at once over every block of the card, in 64-column
panels, each phase a kernel launched by the C entry as a programmatic
dependent of the one before (one wrapper call a level, as before). A
panel's rows first take their products with the earlier panels (a GEMM on
the f64 tensor cores, ``mma.sync`` m16n8k16, 64 x 64 tiles, three blocks
an SM); a block a front factors the diagonal tile (two 32-column warp
halves); blocks of 256 rows solve the panel's rows below it; at the end S
= C - U U' is one GEMM over all columns that reads C from F, each lower
tile's products also giving its mirror tile from C's own upper entries
(C need not be symmetric, as in the plain version). This
left-looking order writes each output once; a level of one front takes
the right-looking order instead (each panel's product off the trailing
triangle after it), which spreads each panel's work over the card. A front
with a pivot that is not > 0 is marked in device memory (the flags cleared
by the first kernel, so no memset breaks the chain) and comes back all
NaN. Its sums run in another order than the other forms' (held to them and
to the plain version by tolerance), in a fixed one (a repeat call gives
the same bits). What bounds it: on the levels of many fronts the device
memory of the panels' GEMMs and of F; on the levels of few the chain of
its ceil(a/64) panels, three kernels each.

The wrapper picks the form by shape (``form_of``) and passes it to the C
entry: the large form for f = a + b >= 320 (every fem3d Q3 front; no fem2d
front, whose f <= 190), else the one-panel form.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from ..utils.trace import enqueue

NAME = "front_factor"
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FORM = 0   # 0: the form by shape (form_of); the card tests set 1 or 2
ONE_PANEL, LARGE = 1, 2
FORM_NAMES = {ONE_PANEL: "one-panel", LARGE: "large"}
LARGE_F = 320          # the narrowest front of the large form
ONE_PANEL_F = 790      # the widest front the one-panel form takes


def form_of(nk, a, b):
    """The form a level of nk fronts (a, b) takes by shape: ``LARGE`` for
    f = a + b >= 320, else ``ONE_PANEL``."""
    return LARGE if a + b >= LARGE_F else ONE_PANEL


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


@enqueue("front_factor")
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
    sync = torch.empty((nk + 1,), dtype=torch.int32, device=F.device)
    code = _FORM or form_of(nk, amax, bmax)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(F), B.ptr(Lf), B.ptr(U), B.ptr(S), B.ptr(sync), nk, amax,
             bmax, ld, code, B.stream(F.device))
    B.check(NAME, err)
    front_factor.launches += 1
    front_factor.large_launches += code == LARGE
    return Lf, U, S


front_factor.launches = 0
front_factor.large_launches = 0     # those in the large form
