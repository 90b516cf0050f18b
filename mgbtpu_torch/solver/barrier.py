"""Barrier objective/gradient/Hessian over a hierarchy level (torch port of
the float64 branches of ``mgbtpu/solver/barrier.py``).

Given a barrier family ``barrier(mode, args, Dz, bw, wc)`` (see
``convex/convex.py``), the level functions of the search coefficient s are

    f0(s) = sum_i [bw_i F0(args_i, Dz_i) + <wc_i, Dz_i>],  Dz = Dz0 + G s
    f1(s) = G' (bw * F1 + wc)
    f2(s) = G' diag-blocks(bw * F2) G

with the level's operators (``PanelOps`` or ``ShardedOps``) passed as an
argument. ``bw`` is the per-node barrier weight; nodes with bw == 0 are
dropped before arithmetic, so an infeasible excluded node (F = +/-inf)
cannot poison the sum. The linear term uses the physical quadrature
weights, passed combined as wc = w * t * c.
On the power cone the per-node part is kernel K2, Dz is K1 and G' is K3.

Dz0, wc, bw and args come one entry a shard of the level's ``ops``
(``ops.split``; a level of one device is one shard): each function runs
per shard on the broadcast s, and what it sums is summed once on the first
device in the order one device sums it (f0 over the shards' node values,
f1 over their per-slot contributions; f2's Gram form keeps each shard's
node factors), so a mesh gives the bits of one device.
"""
from __future__ import annotations

import torch

from .levelops import GramHessian
from ..kernels import cholesky_nan
from ..utils.trace import spanned


def make_level_fns(barrier):
    """Level functions with signature f(s, ops, Dz0, wc, bw, args)."""

    def per_shard(mode, s, ops, Dz0, wc, bw, args):
        return [barrier(mode, a, z, b, w) for a, z, b, w in
                zip(args, ops.shard_G(s, Dz0), bw, wc)]

    @spanned("levelfn.f0")
    def f0(s, ops, Dz0, wc, bw, args):
        return ops.gather(per_shard(0, s, ops, Dz0, wc, bw, args)).sum()

    @spanned("levelfn.f1")
    def f1(s, ops, Dz0, wc, bw, args):
        return ops.adjoint(per_shard(1, s, ops, Dz0, wc, bw, args))

    @spanned("levelfn.f2")
    def f2(s, ops, Dz0, wc, bw, args):
        Ys = per_shard(2, s, ops, Dz0, wc, bw, args)
        if ops.pcg_ctx is not None:
            # large level: matrix-free Gram Hessian, solved by CG
            # preconditioned with the nested-dissection direct factor or
            # the preconditioner BIG_PRE picked (solver/newton.py)
            return GramHessian(ops=ops, Lnode=tuple(map(node_factors, Ys)))
        return ops.dense_hessian(Ys)

    return f0, f1, f2


@spanned("levelfn.f2.node_factors")
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
