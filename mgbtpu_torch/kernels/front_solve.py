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

One block a front reads a fem3d Q3 front's factor (up to 40 MB at the L=5
plan's root) through one SM. Those fronts take the large form: [Lf; U]
in bands of 32 rows (forward) or Lf's columns in bands of 32 (backward), a
block a band, so each byte of the factor is read once a sweep by the block
that owns it. A band takes its products with the solved entries tile by
tile as the bands before it publish them (a per-front ready counter in
device memory, release/acquire; a counter, so no bits depend on it), each
lane summing its column in registers, then one shuffle tree (forward) or
a fold of the warps' sums in order (backward); a warp solves the band's
diagonal tile and publishes it. Blocks take their logical ids from a
ticket counter, in the order they start, and a band waits only on bands of
smaller ids, which are running or done: no wait can deadlock. The U bands
of the forward sweep form upd = U y the same way. What bounds it: the
factor's bytes on the levels of many fronts, the chain of ceil(a/32) band
publications on the levels of few.

The wrapper picks the form by shape (``form_of``) and passes it to the C
entries: the large form for f = a + b >= 320 (every fem3d Q3 front; no
fem2d front), else the one-block form. Either is one wrapper call (one
count) per tree level and sweep: the forward entry launches the level's
kernel and the separator update. Each large-form launch takes fresh
counters, zero, from a ring of 2^20 kept for each stream (zeroed again
when it is used up, once in hundreds of ``nd_solve``s), so no memset
breaks the chain of programmatic dependents.

The two sweeps share one launch count, ``front_solve.launches``; those in
the large form also count in ``front_solve.large_launches``.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from . import _build as B
from ..utils.trace import enqueue

NAME = "front_solve"
_FWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FORM = 0   # 0: the form by shape (form_of); the card tests set 1 or 2
ONE_BLOCK, LARGE = 1, 2
FORM_NAMES = {ONE_BLOCK: "one-block", LARGE: "large"}
LARGE_F = 320          # the narrowest front of the large form

# K5b's launches, both sweeps; large_launches: those in the large form
front_solve = SimpleNamespace(launches=0, large_launches=0)


_RING = 1 << 20        # counters a ring holds
_RINGS: dict = {}      # (device, stream) -> [ring, next unused counter]


def form_of(nk, a, b):
    """The form a level of nk fronts (a, b) takes by shape: ``LARGE`` for
    f = a + b >= 320, else ``ONE_BLOCK``."""
    return LARGE if a + b >= LARGE_F else ONE_BLOCK


def _counters(device, nk):
    """A large-form launch's nk + 1 counters (the ticket, then the fronts'
    ready counts), zero: the next unused stretch of the ring kept for the
    current stream of ``device``. A ring that is used up is zeroed again
    on the stream, behind the launches that used it."""
    s = torch.cuda.current_stream(device)
    key = (s.device_index, s.cuda_stream)
    ring = _RINGS.get(key)
    if ring is None or ring[0].numel() < nk + 1:
        ring = _RINGS[key] = [torch.zeros(max(_RING, nk + 1),
                                          dtype=torch.int32, device=device),
                              0]
    buf, at = ring
    if at + nk + 1 > buf.numel():
        buf.zero_()
        at = 0
    ring[1] = at + nk + 1
    return buf[at:at + nk + 1]


def _count(code):
    front_solve.launches += 1
    front_solve.large_launches += code == LARGE


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


@enqueue("front_solve")
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
    code = _FORM or form_of(nk, a, b)
    sync = _counters(r.device, nk) if code == LARGE else None
    fn = B.launcher(NAME, _FWD_ARGS, "front_forward_launch")
    err = fn(B.ptr(Lf), B.ptr(U), B.ptr(adofs), B.ptr(rows), B.ptr(inc),
             B.ptr(r), B.ptr(y), B.ptr(upd),
             None if sync is None else B.ptr(sync), nk, a, b, nr, Kb, code,
             B.stream(r.device))
    B.check(NAME, err)
    _count(code)
    return y, upd


@enqueue("front_solve")
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
    code = _FORM or form_of(nk, a, b)
    sync = xs = None
    if code == LARGE:
        sync = _counters(x.device, nk)
        xs = torch.empty((nk, a), dtype=torch.float64, device=x.device)
    fn = B.launcher(NAME, _BWD_ARGS, "front_backward_launch")
    err = fn(B.ptr(Lf), B.ptr(U), B.ptr(adofs), B.ptr(bdofs), B.ptr(y),
             B.ptr(x), B.ptr(xA), None if sync is None else B.ptr(sync),
             None if xs is None else B.ptr(xs), nk, a, b, n_J, code,
             B.stream(x.device))
    B.check(NAME, err)
    _count(code)
    return xA
