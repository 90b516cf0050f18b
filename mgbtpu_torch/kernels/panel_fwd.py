"""K1 ``panel_fwd``: Dz = Dz0 + G s, the forward panel product.

Replaces the Pallas kernel ``fwd_dd`` (``mgbtpu/ops/pallas_dd.py:186``,
kernel ``_fwd_kernel`` :174), whose f64 counterpart on the x64 path is
``PanelOps.apply_G`` (``mgbtpu/solver/levelops.py:58-62``) plus the Dz0 add
of ``barrier._Dz``. It runs in every level f0/f1/f2.

CUDA design (``csrc/panel_fwd.cu``): a block takes a group of elements
(about 128 threads, one per (element, node, k) output). It stages each k's
panel slab of the group, contiguous in the ``(nD, N, p, C)`` layout, in
shared memory with 16-byte ``cp.async`` copies, and gathers ``s[cols[e, :]]``
once per element (the TPU kernel got the gathered slab from XLA); each
thread then sums its C products from shared memory and the ``(N*p, nD)``
output is stored with k fastest, so loads and stores are coalesced. The
sums run in the order of the one-thread-per-node kernel it replaced (from
0.0, c = 0..C-1, then dz0 + acc), so its bits are unchanged. What bounds it
on an H100: bytes -- the panels (nD*N*p*C doubles) are read once for 2
flops per 8 bytes, far below the f64 rate; at fem2d_P2 L=5 the ~2 MB it
moves sit in the 50 MB L2, so the call is launch-bound.

An element whose nD slabs do not fit in a block's shared memory together
(the fem3d Q3 levels: p = 64, C = 128 and more) takes the wide form: one
element a block, its panel rows staged a chunk of columns at a time, each
sum carried across the chunks in the same order, so the same bits. A level
of few elements with many rows (the spectral levels: one element, p*nD
from 384 to 9,216) takes the spread form: a dense GEMV whose rows go to
warps, each row's sum split over the warp's 32 lanes (lane l the column
pairs l, l + 32, ... in order) and joined by a fixed shuffle tree, the
panels read once, 16 bytes a load, with several loads in flight a lane.
That order is its own: ``panel_fwd_split_plain`` computes it in plain
PyTorch and gives the kernel's bits, and the einsum ``panel_fwd_plain``
(what the CPU runs) agrees with it to roundoff. The C entry picks the form
by shape (``form`` says which); the element-group and wide forms take
p*nD <= 1024 (one thread an output of an element), the spread form any
p*nD, so any nD runs (the 16- and 32-field models' 33 and 65 rows, too).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from ..utils.trace import enqueue

NAME = "panel_fwd"
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FORM = 0   # the C entry's form: 0 by shape; the card tests set 1, 2 or 3
# The spread form's order (csrc/panel_fwd.cu's SPLIT_LANES, SPLIT_VEC):
SPLIT_LANES = 32   # lanes that fold one row, joined by a shuffle tree
SPLIT_VEC = 2      # columns a lane takes a step (one 16-byte load)


def panel_fwd_plain(panels, cols, s, dz0=None):
    """Plain PyTorch version: gather + einsum (+ Dz0)."""
    nD, N, p, C = panels.shape
    out = torch.einsum("kNpc,Nc->Npk", panels, s[cols]).reshape(N * p, nD)
    return out if dz0 is None else dz0 + out


def panel_fwd_split_plain(panels, cols, s, dz0=None):
    """The spread form's function in its order, in plain PyTorch: lane l
    of a row folds columns c = SPLIT_VEC*j + h, for j = l, l + SPLIT_LANES,
    ... and h = 0 .. SPLIT_VEC - 1, from 0.0, each product and sum rounded
    apart; the lanes' partials are joined pairwise (lane l with l + o, o =
    SPLIT_LANES/2 .. 1); then Dz0 + sum. Columns past C add +0.0, which
    leaves a sum that starts at +0.0 as it is (the kernel skips them)."""
    nD, N, p, C = panels.shape
    span = SPLIT_LANES * SPLIT_VEC
    rows = panels.permute(1, 2, 0, 3)            # (N, p, nD, C): row (e, q, k)
    sv = s[cols][:, None, None, :]               # (N, 1, 1, C)
    acc = torch.zeros((N, p, nD, SPLIT_LANES), dtype=panels.dtype,
                      device=panels.device)
    for c0 in range(0, C, span):
        prod = rows[..., c0:c0 + span] * sv[..., c0:c0 + span]
        if prod.shape[-1] < span:
            prod = torch.nn.functional.pad(prod, (0, span - prod.shape[-1]))
        prod = prod.unflatten(-1, (SPLIT_LANES, SPLIT_VEC))
        for h in range(SPLIT_VEC):
            acc = acc + prod[..., h]
    o = SPLIT_LANES // 2
    while o:
        acc = acc[..., :o] + acc[..., o:2 * o]
        o //= 2
    out = acc[..., 0].reshape(N * p, nD)
    return out if dz0 is None else dz0 + out


@enqueue("panel_fwd")
def panel_fwd(panels, cols, s, dz0=None):
    """panels (nD, N, p, C) f64, cols (N, C) int64, s (n_J,), dz0 optional
    (N*p, nD) -> (N*p, nD). The plain version on CPU tensors, the CUDA
    kernel on CUDA tensors."""
    if not B.on_cuda(NAME, panels, cols, s, dz0):
        return panel_fwd_plain(panels, cols, s, dz0)
    nD, N, p, C = panels.shape
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
             nD, N, p, C, _FORM, B.stream(s.device))
    B.check(NAME, err)
    panel_fwd.launches += 1
    return out


panel_fwd.launches = 0


def form(nD, N, p, C, request=0):
    """The form the C entry takes for this shape (1 element-group, 2 wide,
    3 spread; ``request`` 0 by shape, or the form asked for), 0 when it
    refuses the shape. Builds the library (a card's machine)."""
    fn = B.launcher(NAME, [ctypes.c_int] * 5, "panel_fwd_form")
    return int(fn(nD, N, p, C, request))
