"""Barrier objective/gradient/Hessian over a hierarchy level (torch port of
the float64 branches of ``mgbtpu/solver/barrier.py``).

Given a barrier family ``barrier(mode, args, Dz, bw, wc)`` (see
``convex/convex.py``), the level functions of the search coefficient s are

    f0(s) = sum_i [bw_i F0(args_i, Dz_i) + <wc_i, Dz_i>],  Dz = Dz0 + G s
    f1(s) = G' (bw * F1 + wc)
    f2(s) = G' diag-blocks(bw * F2) G

with the level's PanelOps passed as an argument. ``bw`` is the per-node
barrier weight; nodes with bw == 0 are dropped before arithmetic, so an
infeasible excluded node (F = +/-inf) cannot poison the sum. The linear term
uses the physical quadrature weights, passed combined as wc = w * t * c.
On the power cone the per-node part is kernel K2, Dz is K1 and G' is K3.
"""
from __future__ import annotations

import torch

from .levelops import GramHessian
from ..kernels import cholesky_nan


def make_level_fns(barrier):
    """Level functions with signature f(s, ops, Dz0, wc, bw, args)."""

    def f0(s, ops, Dz0, wc, bw, args):
        Dz = ops.apply_G(s, Dz0)
        return barrier(0, args, Dz, bw, wc).sum()

    def f1(s, ops, Dz0, wc, bw, args):
        Dz = ops.apply_G(s, Dz0)
        return ops.apply_Gt(barrier(1, args, Dz, bw, wc))

    def f2(s, ops, Dz0, wc, bw, args):
        Dz = ops.apply_G(s, Dz0)
        Y = barrier(2, args, Dz, bw, wc)
        if ops.nd is not None:
            # large level: matrix-free Gram Hessian, solved by CG
            # preconditioned with the nested-dissection direct factor
            return GramHessian(ops=ops, Lnode=node_factors(Y))
        return ops.assemble_dense(Y)

    return f0, f1, f2


def node_factors(Y):
    """Per-node lower Cholesky factors of the (PSD) barrier Hessian blocks,
    with a jitter ladder sized to each block's own evaluation noise; a
    still-failing node contributes its absolute-diagonal surrogate."""
    eps = torch.finfo(Y.dtype).eps
    scale = Y.abs().amax(dim=(1, 2))
    eye = torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device)
    L = None
    for c in (8.0, 1024.0):
        Lc = cholesky_nan(Y + (c * eps) * scale[:, None, None] * eye)
        if L is None:
            L = Lc
        else:
            ok = torch.isfinite(L).all(dim=2).all(dim=1)
            L = torch.where(ok[:, None, None], L, Lc)
    ok = torch.isfinite(L).all(dim=2).all(dim=1)
    diag_sqrt = torch.sqrt(torch.abs(
        torch.diagonal(Y, dim1=1, dim2=2)))[:, :, None] * eye
    # row-major: the batched factorization returns column-major matrices,
    # and the Gram kernel (K4) reads the factors row by row
    return torch.where(ok[:, None, None], L, diag_sqrt).contiguous()
