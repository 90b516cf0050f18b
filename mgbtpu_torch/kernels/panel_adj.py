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
spread form, which splits each slot's sum in two levels: the element's
rows, in the (k, q) order, go in slabs (``split_slab``); a block folds
one slab for a tile of slots (two a thread, 16-byte loads, several rows in
flight) into a partial sum, and a second kernel folds each slot's partials
in slab order. That order is its own: ``panel_adj_contrib_split_plain``
computes it in plain PyTorch and gives the kernel's bits; the einsum plain
version (what the CPU runs) and the staged form agree with it to roundoff.
A level of wide elements (the fem3d Q3 hexes: p = 64, C = 128, 320 rows
of 1 KB a slot column) takes phase A's bulk form: one element a CTA, one
thread copying its panel rows by TMA bulk copies through a ring of stages
in shared memory, the other threads folding a slot each in the staged
form's (k, q) row order, so with its bits
(``panel_adj_contrib_rows_plain``). ``bulk_form_takes`` mirrors the C
entry's rule for it: an even C (whole 16-byte rows), at least
``BULK_MIN_N`` elements of at least ``BULK_MIN_ROWS`` rows;
``bulk_launches`` counts the launches that took it.
The spread form takes any p*nD (the staged form p*nD <= 4,096) and a
scratch of N x slabs x C doubles for the partials, which the wrapper
allocates when the C entry takes the spread form. The C entry picks the
form by shape (``form`` says which). Phase B and the second level launch
as Hopper programmatic dependents (``csrc/pdl.cuh``), scheduled while the
kernel before them runs. No atomics, so every run gives the same bits; the
order differs from the plain version's, which it matches to ~1e-16
relative. What bounds it on an H100: bytes (panels read once, 2 flops per
8 bytes); at L=5 the working set sits in L2 and the call is launch-bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from ..ops.scatter import scatter_add
from ..utils.trace import enqueue

NAME = "panel_adj"
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FORM = 0   # phase A's form: 0 by shape; the card tests set 1, 3 or 4
# The spread form's order (csrc/adjoint.cuh's ADJ_SPLIT_SLAB,
# ADJ_SPLIT_SLAB_SMALL, ADJ_SPLIT_SMALL): (k, q) rows a slab, each slot's
# first-level fold
SPLIT_SLAB = 128
SPLIT_SLAB_SMALL = 32   # ... in an element of at most
SPLIT_SMALL = 2048      # ... this many rows
# the forms by shape (adjoint.cuh's ADJ_STAGE, ADJ_SPREAD_MAX_N,
# ADJ_SPREAD_MIN_C, ADJ_BULK_MAX_C, ADJ_BULK_MIN_N, ADJ_BULK_MIN_ROWS)
STAGE = 4096            # the staged and bulk forms: most p*nD
SPREAD_MAX_N = 8        # the spread form: levels of fewer elements ...
SPREAD_MIN_C = 64       # ... of at least this many slots
BULK_MAX_C = 512        # the bulk form: most slots (an even number)
BULK_MIN_N = 8          # ... by shape: levels of at least this many
BULK_MIN_ROWS = 256     # ... elements of at least this many rows p*nD
# phase B's forms (adjoint.cuh's ADJ_THREAD_K, ADJ_COL_THREADS)
ADJ_THREAD_K = 32       # the most slots a thread sums alone
ADJ_COL_THREADS = 256   # past it, threads a column
_FORMS: dict = {}       # (nD, N, p, C, request) -> the C entry's form


def panel_adj_plain(panels, cols, inv, Y, n_J):
    """Plain PyTorch version: einsum + scatter-add by ``cols`` (``inv`` is
    the kernel's input)."""
    return adjoint_sum_plain(cols, inv, panel_adj_contrib_plain(panels, Y),
                             n_J)


def panel_adj_contrib_plain(panels, Y):
    nD, N, p, C = panels.shape
    return torch.einsum("kNpc,Npk->Nc", panels,
                        Y.reshape(N, p, nD)).reshape(-1)


def panel_adj_contrib_rows_plain(panels, Y):
    """Phase A in the staged and bulk forms' order, in plain PyTorch: slot
    (e, c) folds rows i = k*p + q of element e, k outer, from 0.0, each
    product and sum rounded apart. The card's bits in those forms (built
    with --fmad=false)."""
    nD, N, p, C = panels.shape
    y = Y.reshape(N, p, nD)
    acc = torch.zeros((N, C), dtype=panels.dtype, device=panels.device)
    for k in range(nD):
        for q in range(p):
            acc = acc + panels[k, :, q, :] * y[:, q, k, None]
    return acc.reshape(-1)


def bulk_form_takes(nD, N, p, C):
    """Whether phase A takes its bulk form by shape (the C entry's rule,
    ``adjoint_form`` in ``csrc/adjoint.cuh``; at a 16-byte aligned base,
    as every allocation has): not a spread level, an even C of at most
    BULK_MAX_C slots, at least BULK_MIN_N elements of BULK_MIN_ROWS to
    STAGE rows."""
    pn = p * nD
    if pn > STAGE or (N < SPREAD_MAX_N and C >= SPREAD_MIN_C):
        return False
    return (C % 2 == 0 and 2 <= C <= BULK_MAX_C and N >= BULK_MIN_N
            and pn >= BULK_MIN_ROWS)


def split_slab(pn):
    """Rows a slab of the spread form's first level, for p*nD = pn."""
    return SPLIT_SLAB if pn > SPLIT_SMALL else SPLIT_SLAB_SMALL


def panel_adj_contrib_split_plain(panels, Y):
    """Phase A's spread form in its order, in plain PyTorch: slot (e, c)
    sums rows i = k*p + q (k outer) of element e in slabs of
    ``split_slab(p*nD)`` consecutive rows, each slab folded in row order
    from 0.0 (each product and sum rounded apart), then the slabs' partials
    folded in slab order from 0.0. Rows past p*nD add +0.0, which leaves a
    fold that starts at +0.0 as it is (the kernel skips them)."""
    nD, N, p, C = panels.shape
    pn = p * nD
    rows_a_slab = split_slab(pn)
    slabs = -(-pn // rows_a_slab)
    rows = panels.transpose(0, 1).reshape(N, pn, C)        # row i = k*p + q
    y = Y.reshape(N, p, nD).transpose(1, 2).reshape(N, pn)  # y[e, k*p + q]
    part = torch.zeros((N, slabs, C), dtype=panels.dtype,
                       device=panels.device)
    first = torch.arange(slabs, device=panels.device) * rows_a_slab
    for r in range(rows_a_slab):
        i = first + r
        live = i < pn
        if not bool(live.all()):
            i = i[live]
        prod = rows[:, i, :] * y[:, i, None]
        if prod.shape[1] < slabs:
            prod = torch.nn.functional.pad(prod,
                                           (0, 0, 0, slabs - prod.shape[1]))
        part = part + prod
    acc = torch.zeros((N, C), dtype=panels.dtype, device=panels.device)
    for k in range(slabs):
        acc = acc + part[:, k]
    return acc.reshape(-1)


def _part(nD, N, p, C, device):
    """The spread form's scratch (the slab partials, N x slabs x C doubles)
    for a launch of this shape under ``_FORM``; None for the staged form."""
    if form(nD, N, p, C, _FORM) != 3:
        return None
    slabs = -(-(p * nD) // split_slab(p * nD))
    return torch.empty((N * slabs * C,), dtype=torch.float64, device=device)


def adjoint_sum_plain(cols, inv, contrib, n_J):
    out = torch.zeros((n_J,), dtype=contrib.dtype, device=contrib.device)
    return scatter_add(out, cols.reshape(-1), contrib)


def _tree(x):
    """The last axis (a power of two) summed pairwise as a shuffle tree
    leaves it in lane 0: entry l with l + o, o = half .. 1."""
    o = x.shape[-1] // 2
    while o:
        x = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x[..., 0]


def adjoint_sum_ordered_plain(inv, contrib):
    """Phase B (``adjoint.cuh``) in its order, in plain PyTorch: column j's
    slots inv[j, :] (padded with N*C at the end) folded from 0.0 in
    increasing order for K <= ADJ_THREAD_K; past it thread t of
    ADJ_COL_THREADS folds slots t, t + ADJ_COL_THREADS, ..., then a shuffle
    tree a warp and one over the warps' partials. A padded slot adds +0.0,
    which leaves a fold that starts at +0.0 as it is (the kernel skips it).
    The card's bits."""
    n_J, K = inv.shape
    vals = torch.cat([contrib, contrib.new_zeros(1)])[inv]
    if K <= ADJ_THREAD_K:
        acc = contrib.new_zeros(n_J)
        for t in range(K):
            acc = acc + vals[:, t]
        return acc
    T = ADJ_COL_THREADS
    vals = torch.nn.functional.pad(vals, (0, -K % T)).reshape(n_J, -1, T)
    acc = contrib.new_zeros((n_J, T))
    for t in range(vals.shape[1]):
        acc = acc + vals[:, t]
    acc = _tree(acc.reshape(n_J, T // 32, 32))
    return _tree(torch.nn.functional.pad(acc, (0, 32 - T // 32)))


@enqueue("panel_adj")
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
    part = _part(nD, N, p, C, Y.device)
    out = torch.empty((n_J,), dtype=torch.float64, device=Y.device)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(panels), B.ptr(inv), B.ptr(Y), B.ptr(contrib),
             None if part is None else B.ptr(part), B.ptr(out),
             nD, N, p, C, n_J, K, _FORM, B.stream(Y.device))
    B.check(NAME, err)
    _count(panels)
    return out


def _count(panels):
    """One launch of K3 (``bulk_launches`` too where phase A took the
    bulk form: by the C entry's rule, at a 16-byte aligned base)."""
    panel_adj.launches += 1
    if form(*panels.shape, _FORM) == 4 and panels.data_ptr() % 16 == 0:
        panel_adj.bulk_launches += 1


panel_adj.launches = 0
panel_adj.bulk_launches = 0


@enqueue("panel_adj")
def panel_adj_contrib(panels, Y):
    """Phase A alone (one shard of a mesh): panels (nD, N, p, C), Y (N*p,
    nD) -> the per-slot contributions (N*C,); a launch of K3."""
    if not B.on_cuda(NAME, panels, Y):
        return panel_adj_contrib_plain(panels, Y)
    nD, N, p, C = panels.shape
    B.cuda_f64(NAME, panels, (nD, N, p, C), "panels")
    B.cuda_f64(NAME, Y, (N * p, nD), "Y")
    contrib = torch.empty((N * C,), dtype=torch.float64, device=Y.device)
    part = _part(nD, N, p, C, Y.device)
    fn = B.launcher(NAME, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p], "panel_adj_contrib_launch")
    B.check(NAME, fn(B.ptr(panels), B.ptr(Y), B.ptr(contrib),
                     None if part is None else B.ptr(part), nD, N, p, C,
                     _FORM, B.stream(Y.device)))
    _count(panels)
    return contrib


@enqueue("panel_adj")
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
    """Phase A's form the C entry takes for this shape (1 staged, 3 spread,
    4 bulk; ``request`` 0 by shape, or the form asked for), 0 when it
    refuses the shape (the bulk form also refuses a base that is not
    16-byte aligned, which no allocation has). Builds the library (a
    card's machine); the answer is cached."""
    key = (nD, N, p, C, request)
    f = _FORMS.get(key)
    if f is None:
        fn = B.launcher(NAME, [ctypes.c_int] * 5, "panel_adj_form")
        f = _FORMS[key] = int(fn(nD, N, p, C, request))
    return f
