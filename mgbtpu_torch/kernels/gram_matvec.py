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

An element whose panels and factors do not fit in a block's shared memory
(the fem3d Q3 levels: p = 64, C = 128 and more) takes the cluster form:
one element to a thread-block cluster of R CTAs (1, 2, 4 or 8), CTA r
holding its share of the element's nodes' panel rows in shared memory,
read once by TMA bulk copies, one mbarrier a slab so that P v starts on
the first slab while the others land; each CTA's partial slot sums are
joined through distributed shared memory in rank order. Its sums run in
an order of their own (P v in K1's split order; see
``gram_matvec_cluster_plain``, which gives its bits on the card); the
einsum ``gram_matvec_plain``, what the CPU runs, agrees to roundoff. The C
entry picks the form, and R, by shape (``cluster_size``), and refuses the
cluster form where a CTA's run of panels is not 16-byte aligned; a
refused launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from .panel_adj import adjoint_sum_ordered_plain
from .panel_fwd import panel_fwd_split_plain
from ..ops.scatter import scatter_add
from ..utils.trace import enqueue

NAME = "gram_matvec"
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_FORM = 0   # the C entry's form: 0 by shape; the card tests set 1 or 2
_R = 0      # the cluster form's R: 0 by shape; the card tests set 1 .. 8


def gram_matvec_plain(panels, cols, inv, Lnode, v):
    """Plain PyTorch version: gather, four einsums, scatter-add by ``cols``
    (``inv`` is the kernel's input)."""
    out = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    return scatter_add(out, cols.reshape(-1),
                       gram_matvec_contrib_plain(panels, cols, Lnode, v))


def gram_matvec_contrib_plain(panels, cols, Lnode, v):
    nD, N, p, C = panels.shape
    vg = v[cols]                                            # (N, C)
    Lr = Lnode.reshape(N, p, nD, nD)
    Pv = torch.einsum("kNpc,Nc->Npk", panels, vg)           # (N, p, j)
    Bv = torch.einsum("Npji,Npj->Npi", Lr, Pv)              # (N, p, i)
    Y = torch.einsum("Npji,Npi->Npj", Lr, Bv)               # back through L
    return torch.einsum("kNpc,Npk->Nc", panels, Y).reshape(-1)


def gram_matvec_cluster_contrib_plain(panels, cols, Lnode, v, R):
    """The cluster form's per-slot contributions (N*C,) in its order, in
    plain PyTorch (each product and sum rounded apart): P v in K1's split
    order (``panel_fwd_split_plain``); B = L' P v and W = L B node by node,
    each from 0.0 in increasing index; rank r's partial of slot c folded
    from 0.0 over k, then its nodes q in [r p / R, (r + 1) p / R); the
    partials added in rank order."""
    nD, N, p, C = panels.shape
    Pv = panel_fwd_split_plain(panels, cols, v).reshape(N, p, nD)
    Lr = Lnode.reshape(N, p, nD, nD)
    zero = Pv.new_zeros((N, p))
    Bv = []
    for i in range(nD):
        a = zero
        for j in range(i, nD):
            a = a + Lr[:, :, j, i] * Pv[:, :, j]
        Bv.append(a)
    W = []
    for j in range(nD):
        a = zero
        for i in range(j + 1):
            a = a + Lr[:, :, j, i] * Bv[i]
        W.append(a)
    W = torch.stack(W, dim=2)                               # (N, p, nD)
    out = None
    for r in range(R):
        a = panels.new_zeros((N, C))
        for k in range(nD):
            for q in range(r * p // R, (r + 1) * p // R):
                a = a + panels[k, :, q] * W[:, q, k, None]
        out = a if out is None else out + a
    return out.reshape(-1)


def gram_matvec_cluster_plain(panels, cols, inv, Lnode, v, R):
    """The cluster form's H v in its order (R CTAs a cluster), phase B
    included (``adjoint_sum_ordered_plain``): the card's bits."""
    return adjoint_sum_ordered_plain(
        inv, gram_matvec_cluster_contrib_plain(panels, cols, Lnode, v, R))


def form(nD, N, p, C, request=0):
    """The form the C entry takes for this shape (1 the fused kernel, 2 the
    cluster form; ``request`` 0 by shape, or the form asked for), 0 where
    it refuses the shape. Builds the library (a card's machine)."""
    fn = B.launcher(NAME, [ctypes.c_int] * 5, "gram_matvec_form")
    return int(fn(nD, N, p, C, request))


def cluster_size(nD, N, p, C, request=0):
    """The R the C entry's cluster form takes for this shape (``request``
    0 by shape, or 1, 2, 4, 8), 0 where it refuses the shape. Builds the
    library (a card's machine)."""
    fn = B.launcher(NAME, [ctypes.c_int] * 5, "gram_matvec_cluster_size")
    return int(fn(nD, N, p, C, request))


def cluster_occupancy(nD, p, C, R):
    """The clusters of R CTAs the card holds at once at this shape's layout
    (``cudaOccupancyMaxActiveClusters``), 0 where it holds none."""
    fn = B.launcher(NAME, [ctypes.c_int] * 4,
                    "gram_matvec_cluster_occupancy")
    return int(fn(nD, p, C, R))


@enqueue("gram_matvec")
def gram_matvec(panels, cols, inv, Lnode, v):
    """panels (nD, N, p, C), cols (N, C) int64, inv (n_J, K) int64 (see
    ``solver.levelops.inverse_incidence``), Lnode (N*p, nD, nD), v (n_J,)
    -> H v (n_J,)."""
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
             B.ptr(contrib), B.ptr(out), nD, N, p, C, n_J, K, _FORM, _R,
             B.stream(v.device))
    B.check(NAME, err)
    gram_matvec.launches += 1
    return out


gram_matvec.launches = 0


@enqueue("gram_matvec")
def gram_matvec_contrib(panels, cols, Lnode, v):
    """The per-slot contributions (N*C,) of H v alone, for one shard of a
    mesh (K4 without its phase B: the first device sums every shard's with
    ``panel_adj.adjoint_sum``); a launch of K4."""
    if not B.on_cuda(NAME, panels, cols, Lnode, v):
        return gram_matvec_contrib_plain(panels, cols, Lnode, v)
    nD, N, p, C = panels.shape
    B.cuda_f64(NAME, panels, (nD, N, p, C), "panels")
    B.cuda_i64(NAME, cols, (N, C), "cols")
    B.cuda_f64(NAME, Lnode, (N * p, nD, nD), "Lnode")
    B.require(v.dim() == 1 and v.dtype == torch.float64 and v.is_contiguous(),
              NAME, "v must be a contiguous float64 vector")
    contrib = torch.empty((N * C,), dtype=torch.float64, device=v.device)
    fn = B.launcher(NAME, _ARGS)
    err = fn(B.ptr(panels), B.ptr(cols), None, B.ptr(Lnode), B.ptr(v),
             B.ptr(contrib), None, nD, N, p, C, v.shape[0], 0, _FORM, _R,
             B.stream(v.device))
    B.check(NAME, err)
    gram_matvec.launches += 1
    return contrib
