"""K4 ``gram_matvec``: H v = P' L (L' (P v)), the fused Gram Hessian apply.

Replaces the Pallas kernel ``ymv_contrib`` (``mgbtpu/ops/pallas_dd.py:142``,
kernel :108). The x64 reference runs the Lnode (Gram) form,
``gram_matvec`` (``mgbtpu/solver/levelops.py:304-313``): one call per CG
iteration and per refinement residual of the nested-dissection levels
(``mgbtpu/solver/newton.py:417, 485, 488``). This kernel computes that Lnode
form, not the TPU kernel's Y form.

CUDA design (``csrc/gram_matvec.cu``): two launches from one C entry. The
first kernel takes a few elements a block, stages their panels and node
factors in shared memory with ``cp.async``, gathers ``v[cols]`` once per
slot, forms P v, L' P v and W = L L' P v per node in shared memory and
writes only the per-slot contributions, from the staged panels and W in
the fixed order of K3's phase A; the second is K3's phase B
(``csrc/adjoint.cuh``): each column's fixed-order sum, with no atomics, so
the same bits on every run. The panels leave device memory once and W
never does. What bounds it on an H100: bytes (panels and node factors read
once, a few flops per 8 bytes); at L=5 the working set sits in L2 and the
call is bound by its two launches and the latency of its loads.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from ..ops.scatter import scatter_add

NAME = "gram_matvec"
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def gram_matvec_plain(panels, cols, inv, Lnode, v):
    """Plain PyTorch version: gather, four einsums, scatter-add by ``cols``
    (``inv`` is the kernel's input)."""
    nD, N, p, C = panels.shape
    vg = v[cols]                                            # (N, C)
    Lr = Lnode.reshape(N, p, nD, nD)
    Pv = torch.einsum("kNpc,Nc->Npk", panels, vg)           # (N, p, j)
    Bv = torch.einsum("Npji,Npj->Npi", Lr, Pv)              # (N, p, i)
    Y = torch.einsum("Npji,Npi->Npj", Lr, Bv)               # back through L
    contrib = torch.einsum("kNpc,Npk->Nc", panels, Y)
    out = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    return scatter_add(out, cols.reshape(-1), contrib.reshape(-1))


def gram_matvec(panels, cols, inv, Lnode, v):
    """panels (nD, N, p, C), cols (N, C) int64, inv (n_J, K) int64 (see
    ``solver.levelops.inverse_incidence``), Lnode (N*p, nD, nD), v (n_J,)
    -> H v (n_J,). On the card the launch fails (RuntimeError) when one
    element's panels and node factors exceed a block's shared memory."""
    if not B.on_cuda(NAME, panels, cols, inv, Lnode, v):
        return gram_matvec_plain(panels, cols, inv, Lnode, v)
    nD, N, p, C = panels.shape
    n_J = v.shape[0]
    B.cuda_f64(NAME, panels, (nD, N, p, C), "panels")
    B.cuda_i64(NAME, cols, (N, C), "cols")
    B.cuda_i64(NAME, inv, (n_J, inv.shape[1]), "inv")
    B.cuda_f64(NAME, Lnode, (N * p, nD, nD), "Lnode")
    B.require(v.dim() == 1 and v.dtype == torch.float64 and v.is_contiguous(),
              NAME, "v must be a contiguous float64 vector")
    K = inv.shape[1]
    contrib = torch.empty((N * C,), dtype=torch.float64, device=v.device)
    out = torch.empty(v.shape, dtype=torch.float64, device=v.device)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(panels), B.ptr(cols), B.ptr(inv), B.ptr(Lnode), B.ptr(v),
             B.ptr(contrib), B.ptr(out), nD, N, p, C, n_J, K,
             B.stream(v.device))
    B.check(NAME, err)
    gram_matvec.launches += 1
    return out


gram_matvec.launches = 0
